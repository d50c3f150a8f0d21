"""``TraversalSpec`` factory for the doitgen family, as in the JAX
package's ``kernels/doitgen/specs.py``.

A batched 3-D nest: ``r`` is a batch axis (a grid dimension), ``q``
the stride axis split into D streams, ``s`` a reduction contracted
inside the body against the resident ``C4 [s, p]`` (a free axis to the
K1 template, read at whole width) and ``p`` the vector axis: the §5.1
analysis picks the *written* array as critical.  ``full_width`` keeps
``p`` in one block.  The K1 template lowers it: ``csrc/doitgen.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.codegen import Access, Axis, TraversalSpec

__all__ = ["doitgen_spec"]


def _doitgen_body(env):
    return torch.einsum("bqs,sp->bqp", env["A"].float(), env["C4"].float())


def doitgen_spec(a, c4) -> TraversalSpec:
    r, q, s = a.shape
    p = c4.shape[1]
    return TraversalSpec(
        name="doitgen",
        axes=(Axis("r", r, kind="batch"), Axis("q", q),
              Axis("s", s, kind="reduction"), Axis("p", p)),
        reads=(Access("A", ("r", "q", "s")), Access("C4", ("s", "p"))),
        writes=(Access("o", ("r", "q", "p")),),
        body=_doitgen_body,
        full_width=True,
    )
