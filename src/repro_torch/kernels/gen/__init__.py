"""Codegen-derived kernel family: the ``*_gen`` registry rows.

Each ``*_gen`` op lowers a ``TraversalSpec`` through
``repro_torch.codegen`` (:func:`~repro_torch.codegen.emit.make_kernel_op`,
or a composite wrapper that resolves one config under its own name),
sharing the family's spec builder with the hand-named op: one
definition, two registry rows, as in the JAX package
(``src/repro/kernels/gen/``).  Every spec reaches the Hopper kernel
keyed by its name in ``codegen.emit.HAND_KERNELS``.

This module holds the first archetypes and two specs of its own, each
exercising an emitter feature:

  * ``stream_copy_gen``  — streaming elementwise
  * ``stream_triad_gen`` — STREAM triad a = b + αc
  * ``mxv_gen``          — vector-axis reduction
  * ``jacobi2d_gen``     — 5-point stencil
  * ``rowstat_gen``      — row max AND row sum in ONE sweep: two writes
    with *per-write combinators* (``reduce=("max", "sum")``); its kernel
    is ``rowstat`` in ``csrc/reduction.cu`` (``kernel.py``).
  * ``transpose_gen``    — y = xᵀ via a *transposed store*: the write's
    access map is the (vector, stride) pair; its kernel is
    ``csrc/transpose.cu`` (``kernel.py``).

The remaining families live in sibling modules: ``polybench`` (bicg,
the gemver steps, conv3x3, doitgen) and ``framework`` (decode_attn,
rmsnorm, adamw).  Each ``*_gen`` row registers with the hand family's
problem sizes and oracle.
"""
import torch

from repro_torch.codegen import (Access, Axis, TraversalSpec, make_kernel_op,
                                 traffic_of)
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels.common import example_input as _rand
from repro_torch.kernels.common import placeholder
from repro_torch.kernels.jacobi2d import ref as _jac_ref
from repro_torch.kernels.jacobi2d.specs import jacobi_spec
from repro_torch.kernels.mxv import ref as _mxv_ref
from repro_torch.kernels.mxv.specs import mxv_spec
from repro_torch.kernels.stream import ref as _stream_ref
from repro_torch.kernels.stream.specs import copy_spec, triad_spec
from repro_torch.registry.base import KernelSpec, register

__all__ = [
    "stream_copy_gen", "stream_triad_gen", "mxv_gen", "jacobi2d_gen",
    "rowstat_gen", "transpose_gen",
    "bicg_gen", "gemver_outer_gen", "gemver_sum_gen", "gemver_mxv1_gen",
    "gemver_mxv1_sum_gen", "gemver_mxv2_gen", "conv3x3_gen",
    "doitgen_gen", "decode_attn_gen", "rmsnorm_gen", "adamw_update_gen",
    "rowstat_spec", "transpose_spec",
]


# ------------------------------------------------------------- specs

def rowstat_spec(x) -> TraversalSpec:
    """Row max AND row sum in ONE sweep of x: two rank-1 writes off the
    same vector-axis reduction, each with its own combinator
    (``reduce=("max", "sum")``).  Extents stay lane multiples: zero-padded
    lanes would poison the max, and the emitter refuses them.

    The sum accumulates in f64 and rounds once to f32, here and in the
    kernel, so both lie within one rounding of the exact sum: two f32
    sums of a 4096-wide row taken in other orders differ by more than the
    registry row's rtol 1e-5 where the sum is near zero."""
    m, n = x.shape
    return TraversalSpec(
        name="rowstat",
        axes=(Axis("i", m), Axis("j", n, kind="reduction")),
        reads=(Access("x", ("i", "j")),),
        writes=(Access("mx", ("i",)), Access("sm", ("i",))),
        body=lambda env: (env["x"].float().amax(dim=-1),
                          env["x"].double().sum(dim=-1).float()),
        out_dtype=(torch.float32, torch.float32),
        reduce=("max", "sum"),
    )


def transpose_spec(x) -> TraversalSpec:
    """y = xᵀ: the write's access map is the (vector, stride) pair, so
    each of the D streams stores its block transposed — no separate
    transpose copy after the sweep."""
    m, n = x.shape
    return TraversalSpec(
        name="transpose",
        axes=(Axis("i", m), Axis("j", n)),
        reads=(Access("x", ("i", "j")),),
        writes=(Access("xt", ("j", "i")),),
        body=lambda env: env["x"].transpose(-1, -2),
    )


# --------------------------------------------------------------- ops

stream_copy_gen = make_kernel_op("stream_copy_gen", copy_spec,
                                 default=StridingConfig(4, 2))
stream_triad_gen = make_kernel_op("stream_triad_gen", triad_spec,
                                  default=StridingConfig(4, 2))
mxv_gen = make_kernel_op("mxv_gen", mxv_spec, default=StridingConfig(4, 2))
jacobi2d_gen = make_kernel_op("jacobi2d_gen", jacobi_spec,
                              default=StridingConfig(4, 1))
rowstat_gen = make_kernel_op("rowstat_gen", rowstat_spec,
                             default=StridingConfig(4, 2))
transpose_gen = make_kernel_op("transpose_gen", transpose_spec,
                               default=StridingConfig(4, 1))


# ---------------------------------------------------------- registry


def _ir(build, shapes_fn):
    """``traversal`` adapter: build the variant's TraversalSpec on meta
    tensors (no data) — the IR the planner and the analysis screen."""
    def t(sizes, dtype):
        return build(*(placeholder(s, dtype) for s in shapes_fn(sizes)))
    return t


def _traffic(build, shapes_fn):
    """Planner signature derived from the IR's access maps."""
    ir = _ir(build, shapes_fn)

    def t(sizes, dtype):
        return traffic_of(ir(sizes, dtype), dtype)
    return t


# problem sizes mirror the hand families so the conformance matrix
# exercises identical (sizes × (D,P)) points for hand and generated
_STREAM_SIZES = {"rows": 32, "cols": 256}
_STREAM_ALIASED = {"rows": 32, "cols": 128}
_STREAM_BENCH = {"rows": 8192, "cols": 4096}
_MXV_SIZES = {"m": 48, "n": 256}
_MXV_ALIASED = {"m": 32, "n": 128}
_MXV_BENCH = {"m": 4096, "n": 4096}
_JAC_SIZES = {"h": 34, "w": 130}
_JAC_ALIASED = {"h": 34, "w": 128}
_JAC_BENCH = {"h": 2050, "w": 2048}


def _rc(s):
    return (s["rows"], s["cols"])


def _mn(s):
    return (s["m"], s["n"])


register(KernelSpec(
    name="stream_copy_gen", family="gen", fn=stream_copy_gen,
    make_inputs=lambda s, dt, dev: (_rand(_rc(s), 0, dt, dev),),
    run=lambda inp, cfg, mode: stream_copy_gen(inp[0], config=cfg,
                                               mode=mode),
    ref=lambda inp, cfg: _stream_ref.copy_ref(inp[0]),
    default_sizes=_STREAM_SIZES, aliased_sizes=_STREAM_ALIASED,
    traffic=_traffic(copy_spec, lambda s: (_rc(s),)),
    traversal=_ir(copy_spec, lambda s: (_rc(s),)),
    cache_shape=_rc, bench_sizes=_STREAM_BENCH, tags=("paper", "gen")))

register(KernelSpec(
    name="stream_triad_gen", family="gen", fn=stream_triad_gen,
    make_inputs=lambda s, dt, dev: (
        _rand(_rc(s), 0, dt, dev), _rand(_rc(s), 1, dt, dev),
        torch.tensor(1.5, dtype=dt, device=dev)),
    run=lambda inp, cfg, mode: stream_triad_gen(inp[0], inp[1], inp[2],
                                                config=cfg, mode=mode),
    ref=lambda inp, cfg: (inp[0] + inp[2] * inp[1]).to(inp[0].dtype),
    default_sizes=_STREAM_SIZES, aliased_sizes=_STREAM_ALIASED,
    traffic=_traffic(triad_spec, lambda s: (_rc(s), _rc(s))),
    traversal=_ir(triad_spec, lambda s: (_rc(s), _rc(s))),
    cache_shape=_rc, bench_sizes=_STREAM_BENCH, tags=("paper", "gen")))

register(KernelSpec(
    name="mxv_gen", family="gen", fn=mxv_gen,
    make_inputs=lambda s, dt, dev: (_rand(_mn(s), 0, dt, dev),
                                    _rand((s["n"],), 1, dt, dev)),
    run=lambda inp, cfg, mode: mxv_gen(inp[0], inp[1], config=cfg,
                                       mode=mode),
    ref=lambda inp, cfg: _mxv_ref.mxv_ref(inp[0], inp[1]),
    default_sizes=_MXV_SIZES, aliased_sizes=_MXV_ALIASED,
    traffic=_traffic(mxv_spec, lambda s: ((s["m"], s["n"]), (s["n"],))),
    traversal=_ir(mxv_spec, lambda s: ((s["m"], s["n"]), (s["n"],))),
    cache_shape=_mn, bench_sizes=_MXV_BENCH, tags=("paper", "gen")))

register(KernelSpec(
    name="jacobi2d_gen", family="gen", fn=jacobi2d_gen,
    make_inputs=lambda s, dt, dev: (_rand((s["h"], s["w"]), 0, dt, dev),),
    run=lambda inp, cfg, mode: jacobi2d_gen(inp[0], config=cfg, mode=mode),
    ref=lambda inp, cfg: _jac_ref.jacobi2d_ref(inp[0]),
    default_sizes=_JAC_SIZES, aliased_sizes=_JAC_ALIASED,
    traffic=_traffic(jacobi_spec, lambda s: ((s["h"], s["w"]),)),
    traversal=_ir(jacobi_spec, lambda s: ((s["h"], s["w"]),)),
    cache_shape=lambda s: (s["h"], s["w"]),
    bench_sizes=_JAC_BENCH,
    rtol=1e-5, atol=1e-5, tags=("paper", "gen")))

# lane-multiple extents: the padded-lanes refusal under a non-'sum'
# per-write combinator never triggers at these sizes
register(KernelSpec(
    name="rowstat_gen", family="gen", fn=rowstat_gen,
    make_inputs=lambda s, dt, dev: (_rand(_mn(s), 0, dt, dev),),
    run=lambda inp, cfg, mode: rowstat_gen(inp[0], config=cfg, mode=mode),
    ref=lambda inp, cfg: (inp[0].float().amax(dim=-1),
                          inp[0].float().sum(dim=-1)),
    default_sizes=_MXV_SIZES, aliased_sizes=_MXV_ALIASED,
    traffic=_traffic(rowstat_spec, lambda s: (_mn(s),)),
    traversal=_ir(rowstat_spec, lambda s: (_mn(s),)),
    cache_shape=_mn, bench_sizes=_MXV_BENCH,
    rtol=1e-5, atol=1e-5, tags=("paper", "gen")))

register(KernelSpec(
    name="transpose_gen", family="gen", fn=transpose_gen,
    make_inputs=lambda s, dt, dev: (_rand(_mn(s), 0, dt, dev),),
    run=lambda inp, cfg, mode: transpose_gen(inp[0], config=cfg,
                                             mode=mode),
    ref=lambda inp, cfg: inp[0].T,
    default_sizes=_MXV_SIZES, aliased_sizes=_MXV_ALIASED,
    traffic=_traffic(transpose_spec, lambda s: (_mn(s),)),
    traversal=_ir(transpose_spec, lambda s: (_mn(s),)),
    cache_shape=_mn, bench_sizes=_MXV_BENCH, tags=("paper", "gen")))


# the remaining families register on import
from repro_torch.kernels.gen.polybench import (  # noqa: E402
    bicg_gen, conv3x3_gen, doitgen_gen, gemver_mxv1_gen, gemver_mxv1_sum_gen,
    gemver_mxv2_gen, gemver_outer_gen, gemver_sum_gen)
from repro_torch.kernels.gen.framework import (  # noqa: E402
    adamw_update_gen, decode_attn_gen, rmsnorm_gen)
