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
from repro_torch.kernels.gemver import kernel as gkernel  # noqa: F401  (registers its kernels)
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
    """gemver's matrix-vector specs (named for when their kernels were
    still to port) evaluate like the JAX package's, ``SumWithTotal``'s
    second output included; their emitter front end now runs their
    kernel wrappers (the plain versions on CPU tensors) and agrees with
    the JAX emitter in interpret mode."""
    jb, tb, args, row = _spec_case(name, which, seed=3)
    want = jcg.evaluate(jb(*_j(args)), _j(args))
    got = tcg.evaluate(tb(*_t(args)), _t(args))
    _close(got, want, row)
    want = jcg.emit_spec(jb(*_j(args)), _j(args), JConfig(2, 1),
                         interpret=True)
    got = _port_emit(tb(*_t(args)), _t(args), TConfig(2, 1))
    _close(got, want, row)


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
    """The column-dot's partial rows of its cluster ranks (each rank's
    slots of every segment, every row once) and their fold in rank
    order, through the wrappers' plain versions, equal the one-sweep
    spec for any cluster the card's SM count gives."""
    rng = np.random.default_rng(d * sms)
    a = torch.from_numpy(rng.standard_normal((96, 384)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    spec = tmspecs.mxv_t_spec(a, x)
    bp = tcg.plan_blocks(spec, TConfig(d, 2))
    g = mkernel.geometry(bp.rows, bp.cols, bp.d, 4, sms)
    rows = torch.cat([mkernel.rank_rows(bp, g, r) for r in range(g.cluster)])
    assert sorted(rows.tolist()) == list(range(bp.rows))
    part = mkernel.split_plain(spec, bp, [a, x], g)
    assert tuple(part.shape) == (g.cluster, 384)
    y = mkernel.merge_plain(part, torch.float32)
    torch.testing.assert_close(y, tcg.evaluate(spec, [a, x]), rtol=1e-5,
                               atol=1e-5)


def _coldot_geometry_cases():
    return [(n, isz, d) for n in (4096, 16384) for isz in (4, 2)
            for d in (1, 2, 4, 8)]


@pytest.mark.parametrize("n,isz,d", _coldot_geometry_cases())
def test_column_dot_geometry_at_the_bench_sizes(n, isz, d):
    """The column-dot's launch geometry on 132 SMs: 128-column blocks of
    128 threads, 16 bytes a thread (32 column threads by 4 row groups in
    f32, 16 by 8 in bf16), a step of K streams (the smallest power of
    two up to D) by 8 / K slots; a cluster of 8 at 4096^2 and 2 at
    16384^2, so 256 blocks, one wave at two blocks an SM; the ranks'
    slots cover each segment once; a card that keeps fewer clusters
    resident than the grid has gets a smaller cluster."""
    g = mkernel.geometry(n, n, d, isz, 132)
    assert g.ncb == n // 128 and g.seg == n // d
    assert (g.column_threads, g.row_groups) == ((32, 4) if isz == 4
                                                else (16, 8))
    assert g.streams == d and g.slots == 8 // d
    assert g.cluster == (8 if n == 4096 else 2)
    assert (g.blocks, g.waves) == (256, 1)
    assert g.rows_a_rank == g.seg // g.cluster
    assert g.cluster * g.rows_a_rank >= g.seg
    # the sweep's override, and the rule's limits: a cluster fits the
    # rows of a segment and the grid one wave
    assert mkernel.geometry(n, n, d, isz, 132, cluster=1).blocks == n // 128
    assert mkernel.geometry(8, 1024, 4, isz, 132).cluster == 2
    assert mkernel.geometry(n, n, d, isz, 1).cluster == 1
    # 30 resident clusters of 8 cannot hold 4096^2's 32 in one wave
    few = mkernel.geometry(n, n, d, isz, 132,
                           resident=lambda cs: 240 // cs)
    assert few.cluster == (4 if n == 4096 else 1)
    with pytest.raises(ValueError):
        mkernel.geometry(n, n, d, isz, 132, cluster=3)


@pytest.mark.parametrize("name", ["mxv_t", "bicg_s", "gemver_mxv1",
                                  "gemver_mxv1_sum"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("sms", [7, 132])
def test_column_dot_rank_fold_matches_jax_ref(name, d, sms, monkeypatch):
    """The column-dot's plain version in the kernel's order (each cluster
    rank's rows through the spec body, the ranks folded in order; the
    total of gemver_mxv1_sum from the folded row) against the JAX spec
    in ref mode on the same numpy inputs, at the registry row's
    rtol / atol, at 512 x 384 (clusters of 1-8 ranks)."""
    rng = np.random.default_rng(d + sms)
    a = rng.standard_normal((512, 384)).astype(np.float32)
    x = rng.standard_normal(512).astype(np.float32)
    jb, tb = {
        "mxv_t": (jmspecs.mxv_t_spec, tmspecs.mxv_t_spec),
        "bicg_s": (jbspecs.bicg_s_spec, tbspecs.bicg_s_spec),
        "gemver_mxv1": (jgspecs.gemver_mxv1_spec, tgspecs.gemver_mxv1_spec),
        "gemver_mxv1_sum": (jgspecs.gemver_mxv1_sum_spec,
                            tgspecs.gemver_mxv1_sum_spec)}[name]
    args = [a, x] + ([1.2] if name.startswith("gemver") else [])
    row = jreg.get(SPEC_ROWS[name][0])
    monkeypatch.setattr(mkernel, "_PLAIN_SMS", sms)
    want = jcg.run_spec(jb, _j(args), JConfig(d, 2), "ref")
    got = tcg.run_spec(tb, _t(args), TConfig(d, 2))
    _close(got, want, row)
    spec = tb(*_t(args))
    bp = tcg.plan_blocks(spec, TConfig(d, 2))
    g = mkernel.geometry(bp.rows, bp.cols, bp.d, 4, sms)
    part = mkernel.split_plain(spec, bp, _t(args[:2]), g, args[2:])
    assert part.shape == (g.cluster, 384)
    _close(mkernel.merge_plain(part, torch.float32),
           want[0] if name == "gemver_mxv1_sum" else want, row)


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
    assert set(cuda.KERNELS) >= {"mxv", "mxv_t", "gemver_outer",
                                 "gemver_sum"}
    # the column-dot folds its partial rows in its own launch
    assert not any(n.endswith("_merge") and n.startswith(("mxv", "gemver"))
                   for n in cuda.KERNELS)


# gemver_sum's launch (kernel.sum_geometry) worked by hand: the §5.1.1
# tiling [ceil(n / 256), 256] at P = 2, its rows padded to D segments of
# seg rows = seg·256 / vec 16-byte vectors, steps of 2 units of 128
# vectors, D blocks of 128 threads a step, each thread its vector of both
# units in one pass; (n, D, itemsize) -> (vectors a segment, steps, blocks)
@pytest.mark.parametrize("n,d,itemsize,want", [
    (4 * 2 ** 20, 1, 4, (1048576, 4096, 4096)),
    (4 * 2 ** 20, 2, 4, (524288, 2048, 4096)),
    (4 * 2 ** 20, 4, 4, (262144, 1024, 4096)),
    (4 * 2 ** 20, 8, 4, (131072, 512, 4096)),
    (4 * 2 ** 20, 16, 4, (65536, 256, 4096)),
    (4 * 2 ** 20, 4, 2, (131072, 512, 2048)),
    (4 * 2 ** 20, 8, 2, (65536, 256, 2048)),
    # + 77: 16385 tile rows, padded to 16388 at D = 4 (seg 4097, the
    # last step 64 vectors in f32, 32 in bf16), to 16386 at D = 3
    (4 * 2 ** 20 + 77, 4, 4, (262208, 1025, 4100)),
    (4 * 2 ** 20 + 77, 4, 2, (131104, 513, 2052)),
    (4 * 2 ** 20 + 77, 3, 4, (349568, 1366, 4098)),
    # 2·256·4 + 77: 9 tile rows padded to 12, seg 3: one short step
    (2 * 256 * 4 + 77, 4, 4, (192, 1, 4)),
    (2 * 256 * 4 + 77, 4, 2, (96, 1, 4)),
])
def test_gemver_sum_geometry_by_d(n, d, itemsize, want):
    from repro_torch.codegen import block_1d, plan_blocks
    cfg = TConfig(d, 2)
    x = torch.empty(n)
    spec2, _ = block_1d(tgspecs.gemver_sum_spec(x, x), cfg)
    bp = plan_blocks(spec2, cfg)
    g = gkernel.sum_geometry(bp, itemsize)
    assert (g.segv, g.steps, g.blocks) == want
    assert g.vec == 16 // itemsize and g.units == 2 and g.threads == 128
    assert g.passes == 1
    step = g.units * gkernel.SUM_UNIT                  # vectors a step
    assert step == 256 and (g.steps - 1) * step < g.segv <= g.steps * step
    assert g.segv * g.vec * d == bp.rows * bp.cols      # every element once


@pytest.mark.parametrize("p,passes", [(1, 1), (2, 1), (3, 1), (8, 2),
                                      (16, 4)])
def test_gemver_sum_blocks_take_p_units(p, passes):
    """A block of 128 threads runs P units, a thread its vector of each,
    holding at most 4 units at once (a larger P takes more passes)."""
    from repro_torch.codegen.transforms import BlockPlan
    bp = BlockPlan(info=None, d=4, bm=8, bn=128 * p, rows=64, cols=128 * p)
    g = gkernel.sum_geometry(bp, 4)
    assert (g.units, g.threads, g.passes) == (p, 128, passes)
    assert gkernel.SUM_HELD == 4
    assert g.steps == 16 * 128 * p // 4 // (128 * p) == 4


@pytest.mark.parametrize("dt", [("bf16", torch.bfloat16, jnp.bfloat16),
                                ("f16", torch.float16, jnp.float16)],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("label,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_gemver_sum_16bit_matches_jax(dt, label, cfg):
    """gemver_sum in bf16 and f16 at n = 2·256·4 + 77 (a padded tiling):
    the port's op against the JAX op in ref mode, and the port's emitter
    front end against the JAX Pallas kernel in interpret mode, on one
    numpy draw rounded to the type, within the registry row's rtol /
    atol (both add in f32 and round once)."""
    _, tdt, jdt = dt
    rng = np.random.default_rng(11)
    n = 2 * 256 * 4 + 77
    jx, jz = (jnp.asarray(rng.standard_normal(n).astype(np.float32), jdt)
              for _ in range(2))
    tx, tz = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
              for a in (jx, jz))
    row = jreg.get("gemver_sum")
    want = jgops.gemver_sum(jx, jz, config=cfg, mode="ref")
    got = tgops.gemver_sum(tx, tz, config=_tcfg(cfg))
    assert got.dtype == tdt and tuple(got.shape) == (n,)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=row.rtol, atol=row.atol)
    want_i = jcg.emit_spec(jgspecs.gemver_sum_spec(jx, jz), [jx, jz], cfg,
                           interpret=True)
    got_i = _port_emit(tgspecs.gemver_sum_spec(tx, tz), [tx, tz],
                       _tcfg(cfg))
    np.testing.assert_allclose(got_i.float().numpy(),
                               np.asarray(want_i.astype(jnp.float32)),
                               rtol=row.rtol, atol=row.atol)


# ------------------------------------ 16-bit gemver_outer and row-dot

DT16 = {"bf16": (torch.bfloat16, jnp.bfloat16),
        "f16": (torch.float16, jnp.float16)}
# A [m, n]: the registry's default size, a ragged one (rows to D
# segments, 1000 columns to 8 sub-portions) and one of an odd number of
# sub-portions (300 columns to 3)
SHAPES16 = {"aligned": (48, 256), "ragged": (200, 1000), "odd": (40, 300)}


def _draw16(shapes, dt: str, seed: int):
    """One numpy draw rounded to the type: (JAX arrays, torch tensors)."""
    tdt, jdt = DT16[dt]
    rng = np.random.default_rng(seed)
    j = [jnp.asarray(rng.standard_normal(s).astype(np.float32), jdt)
         for s in shapes]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
         for a in j]
    return j, t


def _close16(got, want, tdt, rtol, atol):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == tuple(w.shape)
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        excess = np.abs(g - w) - (atol + rtol * np.abs(w))
        assert excess.max() <= 0, float(excess.max())


@pytest.mark.parametrize("dt", list(DT16))
@pytest.mark.parametrize("shape", list(SHAPES16))
@pytest.mark.parametrize("label,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_gemver_outer_16bit_matches_jax(dt, shape, label, cfg):
    """gemver_outer in bf16 and f16: the port's op against the JAX op in
    ref mode, and the port's emitter front end against the JAX Pallas
    kernel in interpret mode, on one numpy draw rounded to the type.
    bf16 within the registry row's rtol / atol.  In f16 the JAX package
    evaluates the body with excess precision (no rounding between its
    ops: one f16 ulp off the port's per-operation rounding at |o| ~ 8 on
    this draw), so in f16 the limit is what the two evaluations' own
    roundings allow: each rounds each of its four operations at most
    once, within 2^-11 of the value rounded, so they lie within 2^-10
    (|u1 v1| + |u2 v2| + |A + u1 v1| + |o|) of each other."""
    tdt, _ = DT16[dt]
    m, n = SHAPES16[shape]
    j, t = _draw16([(m, n), (m,), (n,), (m,), (n,)], dt, seed=13)
    row = jreg.get("gemver_outer")
    atol = row.atol
    if dt == "f16":
        a, u1, v1, u2, v2 = (x.float() for x in t)
        t1, t2 = u1[:, None] * v1[None, :], u2[:, None] * v2[None, :]
        o = np.abs(np.asarray(jgops.gemver_outer(*j, config=cfg,
                                                 mode="ref")
                              .astype(jnp.float32)))
        atol = row.atol + 2.0 ** -10 * (
            o + (t1.abs() + t2.abs() + (a + t1).abs()).numpy())
    want = jgops.gemver_outer(*j, config=cfg, mode="ref")
    got = tgops.gemver_outer(*t, config=_tcfg(cfg))
    _close16(got, want, tdt, row.rtol, atol)
    want_i = jcg.emit_spec(jgspecs.gemver_outer_spec(*j), j, cfg,
                           interpret=True)
    got_i = _port_emit(tgspecs.gemver_outer_spec(*t), t, _tcfg(cfg))
    _close16(got_i, want_i, tdt, row.rtol, atol)


# the row-dot's f16 rows: (registry row, JAX op, port op, JAX spec, port
# spec, inputs past A and x)
ROWDOT16 = {
    "mxv": ("mxv", jmops.mxv, tmops.mxv, jmspecs.mxv_spec,
            tmspecs.mxv_spec, ()),
    "bicg": ("bicg", jbops.bicg, tbops.bicg, jbspecs.bicg_q_spec,
             tbspecs.bicg_q_spec, ()),
    "gemver_mxv2": ("gemver_mxv2_gen", None, None, jgspecs.gemver_mxv2_spec,
                    tgspecs.gemver_mxv2_spec, (1.5,)),
}


@pytest.mark.parametrize("kernel", list(ROWDOT16))
@pytest.mark.parametrize("shape", list(SHAPES16))
@pytest.mark.parametrize("label,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_row_dot_f16_matches_jax(kernel, shape, label, cfg):
    """mxv, bicg and gemver_mxv2_gen in f16 (the row-dot's instances; bf16
    mxv is held above): the port's op against the JAX op in ref mode and
    the port's emitter front end against the JAX Pallas kernel in
    interpret mode, on one numpy draw rounded to f16.  Both sum in f32
    and round once to f16, in other orders, so the sums may round to
    neighbours: within the registry row's atol and one f16 ulp, rtol
    2^-10 (the bf16 test above allows one bf16 ulp, 2^-7)."""
    from repro.kernels import gen as jgen
    from repro_torch.kernels import gen as tgen
    name, jop, top, jspec, tspec, extra = ROWDOT16[kernel]
    if jop is None:
        jop, top = jgen.gemver_mxv2_gen, tgen.gemver_mxv2_gen
    tdt, _ = DT16["f16"]
    m, n = SHAPES16[shape]
    shapes = [(m, n), (n,)] + ([(m,)] if kernel == "bicg" else [])
    j, t = _draw16(shapes, "f16", seed=17)
    row = jreg.get(name)
    if kernel == "bicg":          # bicg(A, r, p): q = A p, s = Aᵀ r
        jargs, targs = [j[0], j[2], j[1]], [t[0], t[2], t[1]]
    else:
        jargs, targs = j + list(extra), t + list(extra)
    rtol = max(row.rtol, 2.0 ** -10)
    want = jop(*jargs, config=cfg, mode="ref")
    got = top(*targs, config=_tcfg(cfg))
    _close16(got, want, tdt, rtol, row.atol)
    want_i = jcg.emit_spec(jspec(*j[:2], *extra), j[:2] + list(extra), cfg,
                           interpret=True)
    got_i = _port_emit(tspec(*t[:2], *extra), t[:2] + list(extra),
                       _tcfg(cfg))
    _close16(got_i, want_i, tdt, rtol, row.atol)


# gemver_outer's launch (kernel.outer_geometry) worked by hand: 16-byte
# vectors of 16 / itemsize elements, 128 a column tile (the last tile's
# `last` of them holding a vector); K the smallest power of two up to D
# (at most 4), U = 4 / K slots a step; a run of max(2, U) slots, halved
# (not under U) while tiles * runs < 8 blocks an SM; (rows, cols,
# itemsize, D, SMs) -> (vec, tiles, last, K, U, groups, run, runs,
# blocks, steps)
@pytest.mark.parametrize("rows,cols,isz,d,sms,want", [
    # 16384^2 at D = 4: 32 / 16 tiles x 2048 runs of 2 of 4096 slots
    (16384, 16384, 4, 4, 132, (4, 32, 128, 4, 1, 1, 2, 2048, 65536, 2)),
    (16384, 16384, 2, 4, 132, (8, 16, 128, 4, 1, 1, 2, 2048, 32768, 2)),
    (16384, 16384, 2, 4, 114, (8, 16, 128, 4, 1, 1, 2, 2048, 32768, 2)),
    # D = 1: a step is 4 slots of one stream, a run one step
    (16384, 16384, 2, 1, 132, (8, 16, 128, 1, 4, 1, 4, 4096, 65536, 1)),
    (16384, 16384, 2, 2, 132, (8, 16, 128, 2, 2, 1, 2, 4096, 65536, 1)),
    # D = 8: two groups of 4 streams, so a run of 2 slots is 4 steps
    (16384, 16384, 2, 8, 132, (8, 16, 128, 4, 1, 2, 2, 1024, 16384, 4)),
    # 4096^2: 2048 (bf16) and 4096 (f32) blocks already fill 8 an SM
    (4096, 4096, 4, 4, 132, (4, 8, 128, 4, 1, 1, 2, 512, 4096, 2)),
    (4096, 4096, 2, 4, 132, (8, 4, 128, 4, 1, 1, 2, 512, 2048, 2)),
    (4096, 4096, 2, 4, 114, (8, 4, 128, 4, 1, 1, 2, 512, 2048, 2)),
    (4096, 4096, 4, 4, 114, (4, 8, 128, 4, 1, 1, 2, 512, 4096, 2)),
    # ragged [200, 1000] padded to 1024 columns: one tile; 25 blocks are
    # under 8 an SM, so runs of 1 slot
    (200, 1024, 2, 4, 132, (8, 1, 128, 4, 1, 1, 1, 50, 50, 1)),
    # 5 sub-portions: 80 bf16 vectors (one tile, 48 threads idle), 160
    # f32 vectors (the second tile 32); D = 8 over 64 rows: seg 8
    (64, 640, 2, 8, 132, (8, 1, 80, 4, 1, 2, 1, 8, 8, 2)),
    (64, 640, 4, 8, 114, (4, 2, 32, 4, 1, 2, 1, 8, 16, 2)),
    # 2^21 rows at D = 1: runs of 4 would be 524288 grid rows, so 33 (the
    # last step of a run one slot of four)
    (2 ** 21, 128, 2, 1, 132, (8, 1, 16, 1, 4, 1, 33, 63551, 63551, 9)),
])
def test_outer_geometry_by_hand(rows, cols, isz, d, sms, want):
    g = gkernel.outer_geometry(rows, cols, isz, d, sms)
    assert (g.vec, g.tiles, g.last, g.streams, g.slots, g.groups, g.run,
            g.runs, g.blocks, g.steps) == want
    assert g.threads == gkernel.OUTER_THREADS == 128
    assert g.streams * g.slots == gkernel.OUTER_LOADS
    assert (g.tiles - 1) * 128 + g.last == cols // g.vec    # every vector
    assert (g.runs - 1) * g.run < rows // d <= g.runs * g.run  # every slot
    assert g.runs <= 65535


# the row-dot's launch (kernel.rowdot_geometry) worked by hand: rowstat's
# sweep, a wave of 2 blocks an SM of 8 warps; parts double while seg * 2
# * parts <= 16 * SMs and 4 * parts * (8 / K) <= units; x staged where
# cols * itemsize <= 64 KiB; (rows, cols, itemsize, D, SMs) -> (K, parts,
# units, per_part, slots, blocks, tail, smem)
@pytest.mark.parametrize("rows,cols,isz,d,sms,want", [
    # 16384^2: 4096 slots need no parts; 512 rounds of 8 over 264 blocks
    (16384, 16384, 4, 4, 132, (4, 1, 128, 128, 16, 256, False, 65536)),
    (16384, 16384, 2, 4, 132, (4, 1, 64, 64, 16, 256, False, 32768)),
    # at 114 SMs: 512 rounds over 228 blocks, 3 rounds a block
    (16384, 16384, 2, 4, 114, (4, 1, 64, 64, 24, 171, False, 32768)),
    # 4096^2: 1024 slots x 2 parts = 2048 warps <= 2112
    (4096, 4096, 4, 4, 132, (4, 2, 32, 16, 4, 256, False, 16384)),
    (4096, 4096, 2, 4, 132, (4, 2, 16, 8, 4, 256, False, 8192)),
    (4096, 4096, 2, 4, 114, (4, 1, 16, 16, 8, 128, False, 8192)),
    # [1024, 16384]: 256 slots cut into 8 parts of 8 units
    (1024, 16384, 2, 4, 132, (4, 8, 64, 8, 1, 256, False, 32768)),
    # 129 sub-portions: bf16 64 pairs and an 8-byte tail; f32 x over
    # 64 KiB read through __ldg
    (96, 16512, 2, 4, 132, (4, 8, 64, 8, 1, 24, True, 33024)),
    (96, 16512, 4, 4, 132, (4, 8, 129, 17, 1, 24, False, 0)),
    # 257 sub-portions, D = 1: bf16 x over 64 KiB, a tail
    (64, 32896, 2, 1, 132, (1, 8, 128, 16, 1, 64, True, 0)),
    # ragged [200, 1000] -> 1024; 5 sub-portions over 64 rows at D = 8
    (200, 1024, 2, 4, 132, (4, 1, 4, 4, 8, 7, False, 2048)),
    (64, 640, 2, 8, 132, (4, 1, 2, 2, 8, 1, True, 1280)),
    (64, 640, 4, 8, 114, (4, 1, 5, 5, 8, 1, False, 2560)),
])
def test_rowdot_geometry_by_hand(rows, cols, isz, d, sms, want):
    g = mkernel.rowdot_geometry(rows, cols, isz, d, sms)
    assert (g.streams, g.parts, g.units, g.per_part, g.slots, g.blocks,
            g.tail, g.smem) == want
    seg = rows // d
    assert (g.blocks - 1) * g.slots < seg <= g.blocks * g.slots
    assert g.blocks <= 2 * sms                               # one wave
    # every 16-byte unit (and the tail's 8 bytes) once, in part order
    from repro_torch.kernels.gen.kernel import rowstat_units
    loads = rowstat_units(cols // 128, isz, g.parts)
    assert sum(b for part in loads for _, b in part) == (
        cols // 128 * 128 * 16 // (16 // isz) // 32)
    assert any(b == 8 for part in loads for _, b in part) == g.tail
