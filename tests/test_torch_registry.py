"""The port's kernel registry and its conformance matrix against the JAX
package's.

Both packages register the same 35 rows (18 hand-named ops and 17
``*_gen`` ops) with the same sizes, tolerances and tags, and derive the
same 210-point kernel × (D, P) matrix.  At every point one numpy draw
(the port row's ``make_inputs``, on the CPU) goes to both packages: the
JAX row's ``run`` in ``ref`` mode against the port row's ``run`` on CPU
tensors, at the row's ``rtol`` / ``atol``.  For every row with a
``traversal`` the port plans the same blocks and names the same template
as the JAX emitter, whose choice is read by stopping it at its lowering.
The CUDA kernels themselves are held against their plain versions on the
card in ``test_torch_cuda.py`` and by ``chip_smoke.py``'s registry phase.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import registry as jregistry
from repro.registry import base as jregistry_base
from repro.codegen import emit as jemit
from repro.core.striding import StridingConfig as JConfig
from repro_torch import codegen as tcg
from repro_torch import kernels as tkernels
from repro_torch import obs
from repro_torch import registry as tregistry
from repro_torch.codegen import transforms as ttransforms
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels import cuda
from repro_torch.kernels import gen as tgen

POINTS = jregistry.conformance_points()
TRAVERSED = [p for p in POINTS if jregistry.get(p[1]).traversal is not None]
_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _tcfg(c: JConfig) -> TConfig:
    return TConfig(c.stride_unroll, c.portion_unroll, c.lookahead,
                   c.arrangement, c.block_rows)


def _to_jax(x):
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    if isinstance(x, torch.dtype):
        return _DTYPES[x]
    return x


def _jax_inputs(name: str, inputs: tuple) -> tuple:
    if name == "stream_init":       # the port's inputs carry its device
        inputs = inputs[:3]
    return tuple(_to_jax(x) for x in inputs)


def _leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


# ------------------------------------------------------- the registry

def test_registry_matches_jax():
    """Names, families, the family list and every conformance point id:
    35 rows, 210 points."""
    assert tregistry.names() == jregistry.names()
    assert len(tregistry.names()) == 35
    assert tregistry.families() == jregistry.families()
    assert tregistry.FAMILIES == jregistry.FAMILIES
    tpts, jpts = tregistry.conformance_points(), jregistry.conformance_points()
    assert [p[0] for p in tpts] == [p[0] for p in jpts]
    assert len(tpts) == 210
    for (_, tk, ts, tc), (_, jk, js, jc) in zip(tpts, jpts):
        assert (tk, ts) == (jk, js)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert [(label, dataclasses.asdict(c))
            for label, c in tregistry.CONFORMANCE_CONFIGS] == [
        (label, dataclasses.asdict(c))
        for label, c in jregistry_base.CONFORMANCE_CONFIGS]


@pytest.mark.parametrize("name", jregistry.names())
def test_row_matches_jax(name):
    """A row's family, sizes, tolerances, tags, cache shape, traffic
    signature and whether it declares a traversal."""
    t, j = tregistry.get(name), jregistry.get(name)
    assert t.family == j.family and t.fn.__name__ == j.fn.__name__ == name
    assert dict(t.default_sizes) == dict(j.default_sizes)
    assert dict(t.aliased_sizes) == dict(j.aliased_sizes)
    assert t.bench_problem == j.bench_problem
    assert (t.rtol, t.atol, t.tags) == (j.rtol, j.atol, j.tags)
    assert (t.traversal is None) == (j.traversal is None)
    assert (t.traffic is None) == (j.traffic is None)
    for sizes in (j.default_sizes, j.aliased_sizes, j.bench_problem):
        assert t.cache_shape(dict(sizes)) == j.cache_shape(dict(sizes))
        if j.traffic is not None:
            tt = t.traffic(dict(sizes), torch.float32)
            jt = j.traffic(dict(sizes), jnp.float32)
            fields = ("rows", "cols", "read_arrays", "write_arrays",
                      "rw_arrays", "resident_bytes")
            assert ({f: getattr(tt, f) for f in fields}
                    == {f: getattr(jt, f) for f in fields})
            assert tt.dtype == torch.float32


def test_exports_are_the_registered_ops():
    """``repro_torch.kernels`` exports every registered op under its own
    name, the 18 it exported before the registry among them."""
    assert sorted(tkernels.__all__) == tregistry.names()
    for name in tregistry.names():
        assert getattr(tkernels, name) is tregistry.get(name).fn
    assert {"rmsnorm", "decode_attn", "mxv", "mxv_t", "bicg", "gemver",
            "gemver_outer", "gemver_sum", "gemver_mxv1", "gemver_mxv2",
            "stream_read", "stream_copy", "stream_init",
            "stream_copy_manual", "jacobi2d", "conv3x3", "doitgen",
            "adamw_update"} <= set(tkernels.__all__)


def test_example_input_is_a_numpy_draw_on_the_device():
    a = tkernels.common.example_input((3, 5), 7, torch.bfloat16, "cpu")
    want = np.random.default_rng(7).standard_normal((3, 5)).astype(
        np.float32)
    assert a.dtype == torch.bfloat16 and a.device.type == "cpu"
    torch.testing.assert_close(a, torch.from_numpy(want).bfloat16())
    p = tkernels.common.placeholder((4, 2), torch.float16)
    assert p.device.type == "meta" and p.shape == (4, 2)


# ------------------------------------------------- the conformance matrix

@pytest.mark.parametrize("point,kernel,sizes,config", POINTS,
                         ids=[p[0] for p in POINTS])
def test_conformance_matches_jax_ref(point, kernel, sizes, config):
    """The port row's ``run`` on CPU tensors against the JAX row's ``run``
    in ref mode, on the same numpy draw, at the row's tolerances; the
    port's oracle agrees too."""
    t, j = tregistry.get(kernel), jregistry.get(kernel)
    tin = t.make_inputs(sizes, torch.float32, "cpu")
    want = _leaves(j.run(_jax_inputs(kernel, tin), config, "ref"))
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    got = _leaves(t.run(tin, _tcfg(config), None))
    assert all(k.launches == before.get(n, 0)
               for n, k in cuda.KERNELS.items())
    oracle = _leaves(t.ref(tin, _tcfg(config)))
    assert len(got) == len(want) == len(oracle)
    for g, w, o in zip(got, want, oracle):
        assert tuple(g.shape) == tuple(w.shape), point
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=t.rtol, atol=t.atol, err_msg=point)
        np.testing.assert_allclose(o.float().numpy(), np.asarray(w, np.float32),
                                   rtol=t.rtol, atol=t.atol, err_msg=point)


class _Lowered(Exception):
    pass


def _jax_lowering(monkeypatch, spec, config) -> tuple:
    """(template, BlockPlan) the JAX emitter picks for ``spec``: its
    ``emit_spec`` runs on zero operands up to the lowering, which is
    replaced by a stop."""
    seen = []
    for fn, template in (("_emit_streaming", "K1"),
                         ("_emit_reduction", "K2"),
                         ("_emit_stream_reduction", "K3"),
                         ("_emit_manual", "K4")):
        def stop(sched, bp, *args, _t=template, **kw):
            seen.append((_t, bp))
            raise _Lowered
        monkeypatch.setattr(jemit, fn, stop)
    arrays = [jnp.zeros(tuple(spec.axis(v).extent + lo + hi
                              for v, (lo, hi) in zip(a.index, a.halo)),
                        jnp.float32) for a in spec.reads]
    with pytest.raises(_Lowered):
        jemit.emit_spec(spec, arrays + [0.0] * len(spec.scalars), config,
                        interpret=True)
    return seen[0]


def _plan(bp) -> tuple:
    return (bp.d, bp.bm, bp.bn, bp.rows, bp.cols,
            dataclasses.asdict(bp.info))


@pytest.mark.parametrize("point,kernel,sizes,config", TRAVERSED,
                         ids=[p[0] for p in TRAVERSED])
def test_block_plan_and_template_match_jax(monkeypatch, point, kernel,
                                           sizes, config):
    """Every spec of a row's traversal (two for ``bicg_gen``), built on
    meta tensors, gets the JAX emitter's BlockPlan and template (a 1-D
    nest: the plan of its §5.1.1 tiling)."""
    tspecs = tregistry.get(kernel).traversal(sizes, torch.float32)
    jspecs = jregistry.get(kernel).traversal(sizes, jnp.float32)
    tspecs = tspecs if isinstance(tspecs, tuple) else (tspecs,)
    jspecs = jspecs if isinstance(jspecs, tuple) else (jspecs,)
    tcfg = _tcfg(config)
    for tspec, jspec in zip(tspecs, jspecs, strict=True):
        assert tspec.name == jspec.name
        want_t, want_bp = _jax_lowering(monkeypatch, jspec, config)
        info = tcg.classify(tspec)
        planned = tcg.block_1d(tspec, tcfg, info)[0] if info.blocked else tspec
        got_bp = ttransforms.plan_blocks(planned, tcfg)
        assert tcg.template_of(tspec, tcfg, info) == want_t, point
        assert _plan(got_bp) == _plan(want_bp), point


def test_make_kernel_op_memoizes_the_spec_per_shape():
    """A ``make_kernel_op`` op builds and classifies its spec once per
    shape key: the second call of a shape is a memo hit."""
    x = torch.ones(8, 256)
    with obs.collect() as c:
        tgen.stream_copy_gen(x, config=TConfig(2, 1))
        tgen.stream_copy_gen(x + 1, config=TConfig(4, 2))
        tgen.stream_copy_gen(torch.ones(16, 256))
    counts = c.counters()
    assert counts["codegen.spec_memo.miss"] == 2
    assert counts["codegen.spec_memo.hit"] == 1
