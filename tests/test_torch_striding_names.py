"""The public names of ``core/striding.py`` and ``codegen/loopir.py``
that the port had left out — ``factorizations`` (the paper's §3 D × P
pairs), ``stream_spacing_bytes`` (§4.5), ``partition_rows`` and
``to_loop_nest`` (the bridge from a ``TraversalSpec`` to the §5.1
planner) — against the JAX package's on the same arguments."""
import numpy as np
import torch
import pytest

from repro.codegen import loopir as jloopir
from repro.core import striding as jstriding
from repro import registry as jregistry
from repro_torch import core as tcore
from repro_torch import registry as tregistry
from repro_torch.codegen import loopir as tloopir

EXTENTS = (1, 2, 7, 8, 96, 1000, 4096, 16386)


@pytest.mark.parametrize("unrolls", range(1, 65))
def test_factorizations_match_jax(unrolls):
    got = list(tcore.factorizations(unrolls))
    assert got == list(jstriding.factorizations(unrolls))
    assert all(d * p == unrolls for d, p in got)


@pytest.mark.parametrize("extent", EXTENTS)
def test_stream_spacing_and_partition_rows_match_jax(extent):
    for d in range(1, 17):
        for row_bytes in (2, 4, 8192):
            assert tcore.stream_spacing_bytes(extent, d, row_bytes) == \
                jstriding.stream_spacing_bytes(extent, d, row_bytes)
        if extent % d:
            for fn in (tcore.partition_rows, jstriding.partition_rows):
                with pytest.raises(ValueError, match="not divisible"):
                    fn(extent, d)
        else:
            assert tcore.partition_rows(extent, d) == \
                jstriding.partition_rows(extent, d) == extent // d


def _nest(n) -> tuple:
    return (tuple(n.loops), tuple((a.array, tuple(a.index))
                                  for a in n.accesses), tuple(n.writes))


ROWS = [row.name for row in jregistry.all_specs() if row.traversal]


@pytest.mark.parametrize("name", ROWS)
def test_to_loop_nest_matches_jax_on_every_registry_spec(name):
    """Every registry row's traversal at its bench problem (each pass of
    a row that lowers several): the same loops, accesses (reads, then
    writes) and written arrays."""
    jrow, trow = jregistry.get(name), tregistry.get(name)
    sizes = dict(jrow.bench_problem)
    jspecs = jrow.traversal(sizes, np.float32)
    tspecs = trow.traversal(sizes, torch.float32)
    if not isinstance(jspecs, tuple):
        jspecs, tspecs = (jspecs,), (tspecs,)
    assert len(tspecs) == len(jspecs)
    for jspec, tspec in zip(jspecs, tspecs):
        assert _nest(tloopir.to_loop_nest(tspec)) == \
            _nest(jloopir.to_loop_nest(jspec))
