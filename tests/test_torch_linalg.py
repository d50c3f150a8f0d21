"""The port's mxv, bicg and gemver families against the JAX package.

Inputs are drawn once with numpy and the same arrays go to both
packages.  The ops are held against the JAX ops in ``mode="ref"`` at
every conformance point (the five ``CONFORMANCE_CONFIGS`` at the
registry's ``default_sizes``, D=4 at its ``aliased_sizes``) and at a
ragged shape that forces pad-and-crop.  The kernel structure is held
against the JAX emitter in interpret mode: the port's emitter front end
on CPU tensors runs each kernel wrapper's plain version (the two passes
of the column-dot, the §5.1.1 blocking of ``gemver_sum``) and must agree
with the Pallas kernels and plan the same blocks.  Tolerances are the
registry rows' ``rtol``/``atol``.  The CUDA kernels themselves are
tested on the card in ``test_torch_cuda.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codegen as jcg
from repro.codegen import transforms as jtransforms
from repro.core.striding import StridingConfig as JConfig
from repro.kernels.bicg import ops as jbops
from repro.kernels.bicg import specs as jbspecs
from repro.kernels.gemver import ops as jgops
from repro.kernels.gemver import specs as jgspecs
from repro.kernels.mxv import ops as jmops
from repro.kernels.mxv import specs as jmspecs
from repro.registry import base as jreg
from repro_torch import codegen as tcg
from repro_torch.codegen import transforms as ttransforms
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels import cuda
from repro_torch.kernels.bicg import ops as tbops
from repro_torch.kernels.bicg import ref as tbref
from repro_torch.kernels.bicg import specs as tbspecs
from repro_torch.kernels.gemver import ops as tgops
from repro_torch.kernels.gemver import ref as tgref
from repro_torch.kernels.gemver import specs as tgspecs
from repro_torch.kernels.mxv import kernel as mkernel
from repro_torch.kernels.mxv import ops as tmops
from repro_torch.kernels.mxv import ref as tmref
from repro_torch.kernels.mxv import specs as tmspecs

CONFIGS = list(jreg.CONFORMANCE_CONFIGS)
RAGGED = {"m": 40, "n": 200, "vn": 777}      # pads rows, columns, tiles
# (label, config, which sizes): every conformance point, then the ragged
# shape under every conformance config
POINTS = ([(label, cfg, "default") for label, cfg in CONFIGS]
          + [("aliased", JConfig(4, 1), "aliased")]
          + [(f"ragged-{label}", cfg, "ragged") for label, cfg in CONFIGS])


def _tcfg(c: JConfig) -> TConfig:
    return TConfig(c.stride_unroll, c.portion_unroll, c.lookahead,
                   c.arrangement, c.block_rows)


def _sizes(kernel: str, which: str) -> dict:
    row = jreg.get(kernel)
    if which == "ragged":
        return dict(RAGGED)
    return dict(row.default_sizes if which == "default"
                else row.aliased_sizes)


def _inputs(kernel: str, s: dict, seed: int) -> list:
    """numpy inputs of the registry row's op, in its argument order."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    m, n = s.get("m"), s.get("n")
    return {
        "mxv": lambda: [r(m, n), r(n)],
        "mxv_t": lambda: [r(m, n), r(m)],
        "bicg": lambda: [r(m, n), r(m), r(n)],
        "gemver_outer": lambda: [r(m, n), r(m), r(n), r(m), r(n)],
        "gemver_sum": lambda: [r(s["vn"]), r(s["vn"])],
        "gemver_mxv1": lambda: [r(m, n), r(m), r(n), 1.2],
        "gemver_mxv2": lambda: [r(m, n), r(n), 1.5],
        "gemver": lambda: [r(m, n), r(m), r(n), r(m), r(n), r(m), r(n),
                           1.5, 1.2],
    }[kernel]()


def _j(args):
    return [jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in args]


def _t(args):
    return [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in args]


OPS = {
    "mxv": (jmops.mxv, tmops.mxv),
    "mxv_t": (jmops.mxv_t, tmops.mxv_t),
    "bicg": (jbops.bicg, tbops.bicg),
    "gemver_outer": (jgops.gemver_outer, tgops.gemver_outer),
    "gemver_sum": (jgops.gemver_sum, tgops.gemver_sum),
    "gemver_mxv1": (jgops.gemver_mxv1, tgops.gemver_mxv1),
    "gemver_mxv2": (jgops.gemver_mxv2, tgops.gemver_mxv2),
    "gemver": (jgops.gemver, tgops.gemver),
}


def _close(got, want, row):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=row.rtol,
                                   atol=row.atol)


@pytest.mark.parametrize("kernel", list(OPS))
@pytest.mark.parametrize("label,cfg,which", POINTS,
                         ids=[p[0] for p in POINTS])
def test_op_matches_jax_ref(kernel, label, cfg, which):
    """The port's op on CPU tensors against the JAX op in ref mode, with
    the same explicit config on both sides."""
    args = _inputs(kernel, _sizes(kernel, which), seed=1)
    jop, top = OPS[kernel]
    want = jop(*_j(args), config=cfg, mode="ref")
    got = top(*_t(args), config=_tcfg(cfg))
    _close(got, want, jreg.get(kernel))


# ------------------------------------------------- kernel structure

# spec name → (its registry row, the template the JAX package lowers it
# through at lookahead 2)
SPEC_ROWS = {
    "mxv": ("mxv", "K2"), "bicg_q": ("bicg", "K2"),
    "gemver_mxv2": ("gemver_mxv2", "K2"),
    "mxv_t": ("mxv_t", "K3"), "bicg_s": ("bicg", "K3"),
    "gemver_mxv1": ("gemver_mxv1", "K3"),
    "gemver_mxv1_sum": ("gemver_mxv1", "K3"),
    "gemver_outer": ("gemver_outer", "K1"), "gemver_sum": ("gemver_sum", "K1"),
}


def _spec_case(name: str, which: str, seed: int):
    """(JAX spec factory, port spec factory, numpy inputs, registry row)
    of one kernel spec at its registry row's sizes."""
    rng = np.random.default_rng(seed)
    row = SPEC_ROWS[name][0]
    s = _sizes(row, which)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    m, n = s.get("m"), s.get("n")
    table = {
        "mxv": (jmspecs.mxv_spec, tmspecs.mxv_spec,
                lambda: [r(m, n), r(n)]),
        "mxv_t": (jmspecs.mxv_t_spec, tmspecs.mxv_t_spec,
                  lambda: [r(m, n), r(m)]),
        "bicg_q": (jbspecs.bicg_q_spec, tbspecs.bicg_q_spec,
                   lambda: [r(m, n), r(n)]),
        "bicg_s": (jbspecs.bicg_s_spec, tbspecs.bicg_s_spec,
                   lambda: [r(m, n), r(m)]),
        "gemver_outer": (jgspecs.gemver_outer_spec,
                         tgspecs.gemver_outer_spec,
                         lambda: [r(m, n), r(m), r(n), r(m), r(n)]),
        "gemver_sum": (jgspecs.gemver_sum_spec, tgspecs.gemver_sum_spec,
                       lambda: [r(s["vn"]), r(s["vn"])]),
        "gemver_mxv1": (jgspecs.gemver_mxv1_spec, tgspecs.gemver_mxv1_spec,
                        lambda: [r(m, n), r(m), 1.2]),
        "gemver_mxv1_sum": (jgspecs.gemver_mxv1_sum_spec,
                            tgspecs.gemver_mxv1_sum_spec,
                            lambda: [r(m, n), r(m), 1.2]),
        "gemver_mxv2": (jgspecs.gemver_mxv2_spec, tgspecs.gemver_mxv2_spec,
                        lambda: [r(m, n), r(n), 1.5]),
    }
    jb, tb, make = table[name]
    return jb, tb, make(), jreg.get(row)


KERNEL_SPECS = ("mxv", "mxv_t", "bicg_q", "bicg_s", "gemver_outer",
                "gemver_sum")
ALL_SPECS = KERNEL_SPECS + ("gemver_mxv1", "gemver_mxv1_sum", "gemver_mxv2")


def _plans(monkeypatch):
    """Record every BlockPlan either package's emitter plans."""
    seen = {"jax": [], "port": []}

    def spy(mod, key):
        real = mod.plan_blocks

        def plan(spec, config, *a, **kw):
            bp = real(spec, config, *a, **kw)
            seen[key].append((spec.name, bp.d, bp.bm, bp.bn, bp.rows,
                              bp.cols, dataclasses.asdict(bp.info)))
            return bp
        monkeypatch.setattr(mod, "plan_blocks", plan)
    spy(jtransforms, "jax")
    spy(ttransforms, "port")
    return seen


def _port_emit(spec, args, cfg):
    """The port's emitter front end on CPU tensors: plan, pad, the kernel
    wrapper's plain version (per pass), crop."""
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    out = tcg.emit_spec(spec, args, cfg)
    assert all(k.launches == before.get(n, 0)
               for n, k in cuda.KERNELS.items())
    return out


@pytest.mark.parametrize("name", KERNEL_SPECS)
@pytest.mark.parametrize("label,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_kernel_structure_matches_jax_interpret(monkeypatch, name, label,
                                                cfg):
    """Each kernel's spec through both emitters at the registry's default
    sizes: the JAX Pallas kernel in interpret mode against the port's
    front end and kernel wrapper (plain version on CPU), with equal block
    plans — for ``gemver_sum`` the plan of its blocked 2-D tiling."""
    jb, tb, args, row = _spec_case(name, "default", seed=7)
    seen = _plans(monkeypatch)
    want = jcg.emit_spec(jb(*_j(args)), _j(args), cfg, interpret=True)
    got = _port_emit(tb(*_t(args)), _t(args), _tcfg(cfg))
    _close(got, want, row)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1


@pytest.mark.parametrize("name", ALL_SPECS)
@pytest.mark.parametrize("label,cfg,which", POINTS,
                         ids=[p[0] for p in POINTS])
def test_block_plans_match_jax(monkeypatch, name, label, cfg, which):
    """The port plans every new spec's blocks as the JAX package does, at
    every conformance point and the ragged shape, and names the same
    template.  A 1-D nest is planned on its §5.1.1 tiling: the port's
    ``block_1d`` against the plan the JAX package's ``_emit_blocked``
    makes (recorded while it runs in interpret mode)."""
    jb, tb, args, _ = _spec_case(name, which, seed=0)
    jspec, tspec = jb(*_j(args)), tb(*_t(args))
    jinfo, tinfo = jcg.classify(jspec), tcg.classify(tspec)
    assert dataclasses.asdict(tinfo) == dataclasses.asdict(jinfo)
    tcfg = _tcfg(cfg)
    assert tcg.template_of(tspec, tcfg) == SPEC_ROWS[name][1]
    if tinfo.blocked:
        seen = _plans(monkeypatch)
        jcg.emit_spec(jspec, _j(args), cfg, interpret=True)
        tspec, n = tcg.block_1d(tspec, tcfg)
        cols = 128 * cfg.portion_unroll
        assert n == args[0].shape[0]
        assert [(a.name, a.extent) for a in tspec.axes] == [
            ("i__blk", -(-n // cols)), ("i__lane", cols)]
        (want,) = seen["jax"]
    else:
        jbp = jcg.plan_blocks(jspec, cfg)
        want = (jspec.name, jbp.d, jbp.bm, jbp.bn, jbp.rows, jbp.cols,
                dataclasses.asdict(jbp.info))
    tbp = tcg.plan_blocks(tspec, tcfg)
    assert (tspec.name, tbp.d, tbp.bm, tbp.bn, tbp.rows, tbp.cols,
            dataclasses.asdict(tbp.info)) == want


@pytest.mark.parametrize("name", ["gemver_mxv1", "gemver_mxv1_sum",
                                  "gemver_mxv2"])
@pytest.mark.parametrize("which", ["default", "aliased", "ragged"])
def test_specs_off_the_path_have_plain_versions(name, which):
    """The family's specs whose kernels wait (ROADMAP Queue 1) evaluate
    like the JAX package's, ``SumWithTotal``'s second output included;
    their emitter raises naming the TPU template."""
    jb, tb, args, row = _spec_case(name, which, seed=3)
    want = jcg.evaluate(jb(*_j(args)), _j(args))
    got = tcg.evaluate(tb(*_t(args)), _t(args))
    _close(got, want, row)
    with pytest.raises(NotImplementedError, match="_emit_"):
        tcg.emit_spec(tb(*_t(args)), _t(args), TConfig(2, 1))


@pytest.mark.parametrize("lookahead", [1, 3])
def test_k4_specs_refuse_until_that_template_lands(monkeypatch, lookahead):
    """Named for what it checked until the K4 template landed: at
    lookahead != 2 the JAX package runs gemver_sum's blocked tiling
    through K4 (``_emit_manual``).  The port's emitter now routes it to
    its ring (``kernels/manual.py``), whose plain version on CPU tensors
    equals the JAX kernel in interpret mode, with equal block plans."""
    from repro.codegen import emit as jemit
    from repro_torch.kernels import manual as tmanual
    jb, tb, args, row = _spec_case("gemver_sum", "default", seed=5)
    cfg = JConfig(4, 2, lookahead=lookahead)
    seen = _plans(monkeypatch)
    ran = []
    for mod, key in ((jemit, "_emit_manual"), (tmanual, "emit")):
        real = getattr(mod, key)

        def spy(*a, _real=real, _key=key, **kw):
            ran.append(_key)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, key, spy)
    want = jcg.emit_spec(jb(*_j(args)), _j(args), cfg, interpret=True)
    got = _port_emit(tb(*_t(args)), _t(args), _tcfg(cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ran == ["_emit_manual", "emit"]
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 1
    assert tcg.template_of(tb(*_t(args)), _tcfg(cfg)) == "K4"


# ---------------------------------------------- two passes and oracles

@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_column_dot_two_passes_equal_one_sweep(d, sms):
    """The column-dot's split into (segment, row chunk) partial rows and
    their in-order merge, through the wrappers' plain versions, equal the
    one-sweep spec for any chunking the card's SM count gives."""
    rng = np.random.default_rng(d * sms)
    a = torch.from_numpy(rng.standard_normal((96, 384)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    spec = tmspecs.mxv_t_spec(a, x)
    bp = tcg.plan_blocks(spec, TConfig(d, 2))
    tpc, chunks = mkernel.row_chunks(bp, sms)
    tiles = bp.rows // bp.d // bp.bm
    assert (chunks - 1) * tpc < tiles <= chunks * tpc
    part = mkernel.split_plain(spec, bp, [a, x], tpc, chunks)
    assert tuple(part.shape) == (d * chunks, 384)
    y = mkernel.merge_plain(part, torch.float32)
    torch.testing.assert_close(y, tcg.evaluate(spec, [a, x]), rtol=1e-5,
                               atol=1e-5)


def test_oracles_match_jax_oracles():
    from repro.kernels.bicg import ref as jbref
    from repro.kernels.gemver import ref as jgref
    from repro.kernels.mxv import ref as jmref
    rng = np.random.default_rng(11)
    m, n = 24, 136
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((m, n), (m,), (n,), (m,), (n,), (m,), (n,))]
    a, u1, v1, u2, v2, y, z = arrs
    pairs = [
        (tmref.mxv_ref, jmref.mxv_ref, [a, v1]),
        (tmref.mxv_t_ref, jmref.mxv_t_ref, [a, u1]),
        (tbref.bicg_ref, jbref.bicg_ref, [a, u1, v1]),
        (tgref.outer_ref, jgref.outer_ref, [a, u1, v1, u2, v2]),
        (tgref.sum_ref, jgref.sum_ref, [v1, v2]),
        (tgref.mxv1_ref, jgref.mxv1_ref, [a, y, z, 1.2]),
        (tgref.mxv1_sum_ref, jgref.mxv1_sum_ref, [a, y, z, v1, 1.2]),
        (tgref.mxv2_ref, jgref.mxv2_ref, [a, z, 1.5]),
        (tgref.gemver_ref, jgref.gemver_ref, arrs + [1.5, 1.2]),
    ]
    for tfn, jfn, args in pairs:
        got, want = tfn(*_t(args)), jfn(*_j(args))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-4, atol=1e-4)


def test_cpu_ops_launch_nothing_and_bf16_keeps_its_dtype():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((48, 256)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    y = tmops.mxv(a.bfloat16(), x.bfloat16())
    assert y.dtype == torch.bfloat16
    want = jmops.mxv(jnp.asarray(a.numpy(), jnp.bfloat16),
                     jnp.asarray(x.numpy(), jnp.bfloat16), mode="ref",
                     config=JConfig(4, 2))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-4)
    assert {n: k.launches for n, k in cuda.KERNELS.items()} == before
    assert set(cuda.KERNELS) >= {"mxv", "mxv_t", "mxv_t_merge",
                                 "gemver_outer", "gemver_sum"}
