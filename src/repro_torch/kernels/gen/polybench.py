"""Codegen variants of the PolyBench paper families: bicg, the four
gemver steps, conv3x3 and doitgen (``src/repro/kernels/gen/
polybench.py``).

The spec builders live with their families and are shared verbatim by
the hand-named ops and the ``*_gen`` rows here; each row registers with
its hand family's problem sizes and oracle.  Archetypes:

  * ``bicg_s`` / ``gemver_mxv1`` — *stride-axis* reduction (K3): the
    streamed axis itself is reduced, the D partial rows merge into one
    row (``csrc/stream_reduction.cu``); ``gemver_mxv1_sum`` also emits
    the row's total from the same state (``SumWithTotal``).
  * ``gemver_mxv2``             — vector-axis reduction (K2,
    ``csrc/reduction.cu``), α applied by the kernel.
  * ``gemver_outer``            — rank-1 row streams (K1).
  * ``gemver_sum``              — 1-D nest, loop-blocked into a
    ``[rows, 128·P]`` tile grid before striding (K1).
  * ``conv3x3``                 — row+column stencil halo, the nine
    weights as scalars (K1).
  * ``doitgen``                 — batched 3-D nest with a free axis (K1).

The composite ops (``bicg_gen``, ``gemver_mxv1_gen``,
``gemver_mxv1_sum_gen``, ``conv3x3_gen``, and ``framework``'s) resolve
one config under their own name (explicit > tuned > planned > default,
with the JAX ops' Traffic), run every inner spec with it, and dispatch
through the same static gate and guard as ``make_kernel_op`` kernels
(``codegen.emit.guarded``).
"""
from repro_torch.codegen import make_kernel_op, run_spec, traffic_of
from repro_torch.codegen.emit import guarded
from repro_torch.core import Traffic
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.bicg import ref as _bicg_ref
from repro_torch.kernels.bicg.specs import bicg_q_spec, bicg_s_spec
from repro_torch.kernels.common import example_input as _rand
from repro_torch.kernels.common import placeholder
from repro_torch.kernels.conv3x3 import ref as _conv_ref
from repro_torch.kernels.conv3x3.specs import conv3x3_spec
from repro_torch.kernels.doitgen import ref as _doit_ref
from repro_torch.kernels.doitgen.specs import doitgen_spec
from repro_torch.kernels.gemver import ref as _gem_ref
from repro_torch.kernels.gemver.specs import (SumWithTotal, gemver_mxv1_spec,
                                              gemver_mxv1_sum_spec,
                                              gemver_mxv2_spec,
                                              gemver_outer_spec,
                                              gemver_sum_spec)
from repro_torch.registry.base import KernelSpec, register

__all__ = ["bicg_gen", "gemver_outer_gen", "gemver_sum_gen",
           "gemver_mxv1_gen", "gemver_mxv1_sum_gen", "gemver_mxv2_gen",
           "conv3x3_gen", "doitgen_gen",
           # family specs re-exported for spec-level consumers
           "bicg_q_spec", "bicg_s_spec", "gemver_outer_spec",
           "gemver_sum_spec", "gemver_mxv1_spec", "gemver_mxv1_sum_spec",
           "gemver_mxv2_spec", "SumWithTotal", "conv3x3_spec",
           "doitgen_spec"]

_D4P2, _D4P1 = StridingConfig(4, 2), StridingConfig(4, 1)


# the composites' screened and guarded launches (emit.guarded)
_bicg = guarded("bicg_gen")
_mxv1 = guarded("gemver_mxv1_gen")
_mxv1_sum = guarded("gemver_mxv1_sum_gen")
_conv = guarded("conv3x3_gen")


def _mn_traffic(a) -> Traffic:
    """The composite ops' signature: two sweeps of A [m, n]."""
    m, n = a.shape
    return Traffic(rows=m, cols=n, dtype=a.dtype, read_arrays=2)


# ---------------------------------------------------------------- bicg

def bicg_gen(a, r, p, config=None, mode=None):
    """q = A p ; s = Aᵀ r (generated; two specs under one config)."""
    m, n = a.shape
    traffic = _mn_traffic(a)
    cfg = common.resolve_for("bicg_gen", a, config, m, _D4P2, traffic, mode)
    return _bicg(
        lambda c: (run_spec(bicg_q_spec, (a, p), c, mode),
                   run_spec(bicg_s_spec, (a, r), c, mode)),
        (a, r, p), lambda: (bicg_q_spec(a, p), bicg_s_spec(a, r)), cfg,
        mode, m, traffic)


# -------------------------------------------------------------- gemver

gemver_outer_gen = make_kernel_op("gemver_outer_gen", gemver_outer_spec,
                                  default=_D4P2)
gemver_sum_gen = make_kernel_op("gemver_sum_gen", gemver_sum_spec,
                                default=_D4P2)
gemver_mxv2_gen = make_kernel_op("gemver_mxv2_gen", gemver_mxv2_spec,
                                 default=_D4P2)


def gemver_mxv1_gen(a, y, x, beta, config=None, mode=None):
    """x = x + β Aᵀ y (generated core + affine update)."""
    traffic = _mn_traffic(a)
    cfg = common.resolve_for("gemver_mxv1_gen", a, config, a.shape[0],
                             _D4P2, traffic, mode)
    return x + _mxv1(
        lambda c: run_spec(gemver_mxv1_spec, (a, y, beta), c, mode),
        (a, y, x, beta), lambda: (gemver_mxv1_spec(a, y, beta),), cfg, mode,
        a.shape[0], traffic)


def gemver_mxv1_sum_gen(a, y, x, z, beta, config=None, mode=None):
    """Fused gemver mxv1 + sum steps: x' = x + β Aᵀ y + z, with the
    sweep's own reduction Σⱼ(βAᵀy)ⱼ as a native side output — one sweep
    of A.  Returns (x', ssum), ssum a 0-d f32."""
    traffic = _mn_traffic(a)
    cfg = common.resolve_for("gemver_mxv1_sum_gen", a, config, a.shape[0],
                             _D4P2, traffic, mode)
    s, total = _mxv1_sum(
        lambda c: run_spec(gemver_mxv1_sum_spec, (a, y, beta), c, mode),
        (a, y, x, z, beta), lambda: (gemver_mxv1_sum_spec(a, y, beta),),
        cfg, mode, a.shape[0], traffic)
    return x + s.to(x.dtype) + z, total.reshape(())


# ------------------------------------------------------------- conv3x3

def conv3x3_gen(x, w, config=None, mode=None):
    """3x3 correlation stencil (generated; weights lowered as scalars)."""
    h_out = max(x.shape[0] - 2, 1)
    traffic = Traffic(rows=h_out, cols=max(x.shape[1] - 2, 1),
                      dtype=x.dtype, read_arrays=3, write_arrays=1)
    cfg = common.resolve_for("conv3x3_gen", x, config, h_out, _D4P1,
                             traffic, mode)
    w9 = [w[r, c] for r in range(3) for c in range(3)]
    return _conv(
        lambda c: run_spec(conv3x3_spec, (x, *w9), c, mode),
        (x, w), lambda: (conv3x3_spec(x, *w9),), cfg, mode, h_out, traffic)


# ------------------------------------------------------------- doitgen

doitgen_gen = make_kernel_op("doitgen_gen", doitgen_spec, default=_D4P1)


# ---------------------------------------------------------- registry

_MN_SIZES = {"m": 48, "n": 256}
_MN_ALIASED = {"m": 32, "n": 128}
_MN_BENCH = {"m": 4096, "n": 4096}


def _mn(s):
    return (s["m"], s["n"])


def _traffic2(s, dt):
    return Traffic(rows=s["m"], cols=s["n"], dtype=dt, read_arrays=2)


register(KernelSpec(
    name="bicg_gen", family="gen", fn=bicg_gen,
    make_inputs=lambda s, dt, dev: (_rand(_mn(s), 0, dt, dev),
                                    _rand((s["m"],), 1, dt, dev),
                                    _rand((s["n"],), 2, dt, dev)),
    run=lambda inp, cfg, mode: bicg_gen(inp[0], inp[1], inp[2], config=cfg,
                                        mode=mode),
    ref=lambda inp, cfg: _bicg_ref.bicg_ref(inp[0], inp[1], inp[2]),
    default_sizes=_MN_SIZES, aliased_sizes=_MN_ALIASED,
    traffic=_traffic2,
    # composite: both specs under one config
    traversal=lambda s, dt: (
        bicg_q_spec(placeholder(_mn(s), dt), placeholder((s["n"],), dt)),
        bicg_s_spec(placeholder(_mn(s), dt), placeholder((s["m"],), dt))),
    cache_shape=_mn, bench_sizes=_MN_BENCH, tags=("paper", "gen")))

register(KernelSpec(
    name="gemver_outer_gen", family="gen", fn=gemver_outer_gen,
    make_inputs=lambda s, dt, dev: (
        _rand(_mn(s), 0, dt, dev), _rand((s["m"],), 1, dt, dev),
        _rand((s["n"],), 2, dt, dev), _rand((s["m"],), 3, dt, dev),
        _rand((s["n"],), 4, dt, dev)),
    run=lambda inp, cfg, mode: gemver_outer_gen(*inp, config=cfg,
                                                mode=mode),
    ref=lambda inp, cfg: _gem_ref.outer_ref(*inp),
    default_sizes=_MN_SIZES, aliased_sizes=_MN_ALIASED,
    traffic=lambda s, dt: traffic_of(
        gemver_outer_spec(placeholder(_mn(s), dt), *(None,) * 4), dt),
    traversal=lambda s, dt: gemver_outer_spec(placeholder(_mn(s), dt),
                                              *(None,) * 4),
    cache_shape=_mn, bench_sizes=_MN_BENCH, tags=("paper", "gen")))

register(KernelSpec(
    name="gemver_sum_gen", family="gen", fn=gemver_sum_gen,
    make_inputs=lambda s, dt, dev: (_rand((s["vn"],), 0, dt, dev),
                                    _rand((s["vn"],), 1, dt, dev)),
    run=lambda inp, cfg, mode: gemver_sum_gen(inp[0], inp[1], config=cfg,
                                              mode=mode),
    ref=lambda inp, cfg: _gem_ref.sum_ref(inp[0], inp[1]),
    default_sizes={"vn": 1000}, aliased_sizes={"vn": 2048},
    traffic=lambda s, dt: traffic_of(
        gemver_sum_spec(placeholder((s["vn"],), dt), None), dt),
    traversal=lambda s, dt: gemver_sum_spec(placeholder((s["vn"],), dt), None),
    cache_shape=lambda s: (s["vn"],),
    bench_sizes={"vn": 4 * 2**20}, tags=("paper", "gen")))

register(KernelSpec(
    name="gemver_mxv1_gen", family="gen", fn=gemver_mxv1_gen,
    make_inputs=lambda s, dt, dev: (_rand(_mn(s), 0, dt, dev),
                                    _rand((s["m"],), 1, dt, dev),
                                    _rand((s["n"],), 2, dt, dev), 1.2),
    run=lambda inp, cfg, mode: gemver_mxv1_gen(inp[0], inp[1], inp[2],
                                               inp[3], config=cfg,
                                               mode=mode),
    ref=lambda inp, cfg: _gem_ref.mxv1_ref(inp[0], inp[1], inp[2], inp[3]),
    default_sizes=_MN_SIZES, aliased_sizes=_MN_ALIASED,
    traffic=_traffic2,
    traversal=lambda s, dt: gemver_mxv1_spec(placeholder(_mn(s), dt), None),
    cache_shape=_mn, bench_sizes=_MN_BENCH, tags=("paper", "gen")))

register(KernelSpec(
    name="gemver_mxv1_sum_gen", family="gen", fn=gemver_mxv1_sum_gen,
    make_inputs=lambda s, dt, dev: (_rand(_mn(s), 0, dt, dev),
                                    _rand((s["m"],), 1, dt, dev),
                                    _rand((s["n"],), 2, dt, dev),
                                    _rand((s["n"],), 3, dt, dev), 1.2),
    run=lambda inp, cfg, mode: gemver_mxv1_sum_gen(*inp, config=cfg,
                                                   mode=mode),
    ref=lambda inp, cfg: _gem_ref.mxv1_sum_ref(*inp),
    default_sizes=_MN_SIZES, aliased_sizes=_MN_ALIASED,
    traffic=_traffic2,
    traversal=lambda s, dt: gemver_mxv1_sum_spec(placeholder(_mn(s), dt), None),
    cache_shape=_mn, bench_sizes=_MN_BENCH, tags=("paper", "gen")))

register(KernelSpec(
    name="gemver_mxv2_gen", family="gen", fn=gemver_mxv2_gen,
    make_inputs=lambda s, dt, dev: (_rand(_mn(s), 0, dt, dev),
                                    _rand((s["n"],), 1, dt, dev), 1.5),
    run=lambda inp, cfg, mode: gemver_mxv2_gen(inp[0], inp[1], inp[2],
                                               config=cfg, mode=mode),
    ref=lambda inp, cfg: _gem_ref.mxv2_ref(inp[0], inp[1], inp[2]),
    default_sizes=_MN_SIZES, aliased_sizes=_MN_ALIASED,
    traffic=lambda s, dt: Traffic(rows=s["m"], cols=s["n"], dtype=dt,
                                  read_arrays=1),
    traversal=lambda s, dt: gemver_mxv2_spec(placeholder(_mn(s), dt),
                                             placeholder((s["n"],), dt)),
    cache_shape=_mn, bench_sizes=_MN_BENCH, tags=("paper", "gen")))

register(KernelSpec(
    name="conv3x3_gen", family="gen", fn=conv3x3_gen,
    make_inputs=lambda s, dt, dev: (_rand((s["h"], s["w"]), 0, dt, dev),
                                    _rand((3, 3), 1, dt, dev)),
    run=lambda inp, cfg, mode: conv3x3_gen(inp[0], inp[1], config=cfg,
                                           mode=mode),
    ref=lambda inp, cfg: _conv_ref.conv3x3_ref(inp[0], inp[1]),
    default_sizes={"h": 34, "w": 130}, aliased_sizes={"h": 34, "w": 128},
    traffic=lambda s, dt: traffic_of(
        conv3x3_spec(placeholder((s["h"], s["w"]), dt)), dt),
    traversal=lambda s, dt: conv3x3_spec(placeholder((s["h"], s["w"]), dt)),
    cache_shape=lambda s: (s["h"], s["w"]),
    bench_sizes={"h": 2050, "w": 2048}, tags=("paper", "gen")))

register(KernelSpec(
    name="doitgen_gen", family="gen", fn=doitgen_gen,
    make_inputs=lambda s, dt, dev: (
        _rand((s["r"], s["q"], s["s"]), 0, dt, dev),
        _rand((s["s"], s["s"]), 1, dt, dev)),
    run=lambda inp, cfg, mode: doitgen_gen(inp[0], inp[1], config=cfg,
                                           mode=mode),
    ref=lambda inp, cfg: _doit_ref.doitgen_ref(inp[0], inp[1]),
    default_sizes={"r": 4, "q": 8, "s": 32},
    aliased_sizes={"r": 8, "q": 16, "s": 32},
    traffic=lambda s, dt: traffic_of(
        doitgen_spec(placeholder((s["r"], s["q"], s["s"]), dt),
                     placeholder((s["s"], s["s"]), dt)), dt),
    traversal=lambda s, dt: doitgen_spec(
        placeholder((s["r"], s["q"], s["s"]), dt), placeholder((s["s"], s["s"]), dt)),
    cache_shape=lambda s: (s["r"], s["q"], s["s"]),
    bench_sizes={"r": 16, "q": 256, "s": 256}, tags=("paper", "gen")))
