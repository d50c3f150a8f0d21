"""Emitter front end: plan a spec's blocks, pad, run its hand kernel, crop.

The JAX package lowers every scheduled nest through one of four Pallas
templates in ``src/repro/codegen/emit.py``:

  * K1 ``_emit_streaming``        — elementwise / stencil / free-axis nests
  * K2 ``_emit_reduction``        — vector-axis reductions per stride row
  * K3 ``_emit_stream_reduction`` — the stride axis itself is reduced
  * K4 ``_emit_manual``           — explicit ``lookahead``-deep DMA rings

On Hopper each *instance* of a template (a template plus one family's
spec body) is a CUDA kernel written by hand (``csrc/``).  This front end
keeps everything around the template that is not the kernel: the block
plan (D streams, bm rows, bn lanes), the §5.1.2 pad-and-crop of the
operands, the §5.1.1 loop blocking of 1-D nests into a 2-D tile grid
(:func:`block_1d`), and the template's refusals.  It then hands the padded
operands and the :class:`~repro_torch.codegen.transforms.BlockPlan` to
the kernel registered for the spec's name in :data:`HAND_KERNELS`, or,
for a spec the JAX package lowers through K4, to the K4 ring
(``kernels/manual.py``), which takes the bodies in its ``BODIES``.  A
spec with no ported kernel raises ``NotImplementedError`` naming the
template and the instance still to port — there is no silent fallback
to the plain version.

``mode="ref"`` runs :func:`~repro_torch.codegen.loopir.evaluate`, the
plain PyTorch version, on whatever device the inputs lie on.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.codegen import loopir, transforms
from repro_torch.core.striding import StridingConfig

__all__ = ["HAND_KERNELS", "template_of", "block_1d", "emit_spec",
           "run_spec"]

# spec name → module whose ``emit(spec, bp, arrays, scalars, config)``
# launches the hand-written K1-K3 kernel for that instance (imported at
# first use); K4 specs go to _MANUAL whatever their name
HAND_KERNELS = {
    "rmsnorm": "repro_torch.kernels.rmsnorm.kernel",
    "decode_attn_spec": "repro_torch.kernels.decode_attn.kernel",
    "decode_attn_masked": "repro_torch.kernels.decode_attn.kernel",
    "mxv": "repro_torch.kernels.mxv.kernel",
    "bicg_q": "repro_torch.kernels.mxv.kernel",
    "mxv_t": "repro_torch.kernels.mxv.kernel",
    "bicg_s": "repro_torch.kernels.mxv.kernel",
    "gemver_outer": "repro_torch.kernels.gemver.kernel",
    "gemver_sum": "repro_torch.kernels.gemver.kernel",
    "stream_copy": "repro_torch.kernels.stream.kernel",
    "stream_triad": "repro_torch.kernels.stream.kernel",
    "stream_init": "repro_torch.kernels.stream.kernel",
    "stream_read": "repro_torch.kernels.stream.kernel",
    "jacobi2d": "repro_torch.kernels.stencil",
    "conv3x3": "repro_torch.kernels.stencil",
    "doitgen": "repro_torch.kernels.doitgen.kernel",
    "adamw_update": "repro_torch.kernels.adamw.kernel",
}
_MANUAL = "repro_torch.kernels.manual"

_TEMPLATES = {
    "K1": "_emit_streaming (src/repro/codegen/emit.py:410)",
    "K2": "_emit_reduction (src/repro/codegen/emit.py:491)",
    "K3": "_emit_stream_reduction (src/repro/codegen/emit.py:564)",
    "K4": "_emit_manual (src/repro/codegen/emit.py:708)",
}


def _write_rest(acc: loopir.Access, info: loopir.NestInfo) -> tuple:
    """A write's non-batch index vars, in declared order."""
    return tuple(v for v in acc.index if v not in info.batch_axes)


def _manual_eligible(spec: loopir.TraversalSpec,
                     info: loopir.NestInfo) -> bool:
    """The JAX template K4 takes plain ``(stride, vector)`` reads and
    ``(stride, vector)`` or ``(stride,)`` writes only."""
    if (info.reduction or info.stride_reduction
            or info.batch_axes or info.free_axes
            or info.row_halo != (0, 0) or info.col_halo != (0, 0)):
        return False
    sv = (info.stride_axis, info.vector_axis)
    if not all(a.index == sv and not a.has_halo for a in spec.reads):
        return False
    return all(w.index in (sv, (info.stride_axis,)) for w in spec.writes)


def template_of(spec: loopir.TraversalSpec, config: StridingConfig,
                info: Optional[loopir.NestInfo] = None) -> str:
    """Which of the JAX package's four Pallas templates lowers ``spec``
    under ``config`` (the selection rule of its ``emit_scheduled``; 1-D
    nests are loop-blocked into 2-D first, §5.1.1).  ``info`` is
    ``loopir.classify(spec)`` where the caller has it already."""
    if info is None:
        info = loopir.classify(spec)
    if info.blocked:
        return "K4" if config.lookahead != 2 else "K1"
    if info.stride_reduction:
        return "K3"
    if info.reduction and all(_write_rest(w, info) == (info.stride_axis,)
                              for w in spec.writes):
        return "K2"
    if config.lookahead != 2 and _manual_eligible(spec, info):
        return "K4"
    return "K1"


def _hand_kernel(spec: loopir.TraversalSpec, config: StridingConfig,
                 info: loopir.NestInfo) -> Callable:
    t = template_of(spec, config, info)
    if t == "K4":
        manual = importlib.import_module(_MANUAL)
        path = _MANUAL if spec.name in manual.BODIES else None
    else:
        path = HAND_KERNELS.get(spec.name)
    if path is None:
        raise NotImplementedError(
            f"{spec.name}: no hand-written Hopper kernel yet — its TPU "
            f"kernel is template {t} {_TEMPLATES[t]} with the "
            f"{spec.name!r} body; that instance is still to port "
            "(ROADMAP Queue 1). Use mode='ref' for the plain version.")
    return importlib.import_module(path).emit


# ---------------------------------------------------- pad / crop / run

def _pad_dim(x: torch.Tensor, dim: int, target: int) -> torch.Tensor:
    if x.shape[dim] == target:
        return x
    pads = [0, 0] * x.ndim          # F.pad lists the LAST dim first
    pads[2 * (x.ndim - 1 - dim) + 1] = target - x.shape[dim]
    return F.pad(x, pads)


def _pad_arrays(spec: loopir.TraversalSpec, bp: transforms.BlockPlan,
                arrays: Sequence) -> list:
    """Zero-pad every operand to the BlockPlan's extents (§5.1.2
    divisibility — pad+crop instead of leftover loops).  Batch and free
    dims keep their natural extents."""
    info = bp.info
    targets = {info.stride_axis: bp.rows, info.vector_axis: bp.cols}
    padded = []
    for acc, x in zip(spec.reads, arrays):
        for dim, (var, (lo, hi)) in enumerate(zip(acc.index, acc.halo)):
            target = targets.get(var, spec.axis(var).extent) + lo + hi
            x = _pad_dim(x, dim, target)
        padded.append(x)
    return padded


def block_1d(spec: loopir.TraversalSpec, config: StridingConfig,
             info: Optional[loopir.NestInfo] = None,
             ) -> tuple[loopir.TraversalSpec, int]:
    """§5.1.1 loop blocking of a 1-D nest, as the JAX package's
    ``_emit_blocked``: the single axis of extent n is tiled into a
    ``[ceil(n / 128·P), 128·P]`` grid.  Returns the 2-D spec (its
    accesses remapped to ``(<axis>__blk, <axis>__lane)``) and n.
    ``info`` is ``loopir.classify(spec)`` where the caller has it
    already."""
    if info is None:
        info = loopir.classify(spec)
    ax = spec.axis(info.stride_axis)
    n = ax.extent
    cols = transforms.LANE * config.portion_unroll
    rows = max(-(-n // cols), 1)
    row_ax, lane_ax = ax.name + "__blk", ax.name + "__lane"

    def remap(acc):
        return dataclasses.replace(acc, index=(row_ax, lane_ax), halo=None)

    spec2 = dataclasses.replace(
        spec,
        axes=(loopir.Axis(row_ax, rows), loopir.Axis(lane_ax, cols)),
        reads=tuple(remap(a) for a in spec.reads),
        writes=tuple(remap(a) for a in spec.writes),
    )
    return spec2, n


def _emit_blocked(spec: loopir.TraversalSpec, info: loopir.NestInfo,
                  arrays: Sequence, scalars: Sequence,
                  config: StridingConfig):
    """Run a 1-D nest on its :func:`block_1d` tiling: pad each operand
    to whole tiles, run the 2-D spec's pipeline, crop back to n."""
    spec2, n = block_1d(spec, config, info)
    rows, cols = (ax.extent for ax in spec2.axes)

    def to2d(x):
        return _pad_dim(x, 0, rows * cols).reshape(rows, cols)

    out = emit_spec(spec2, [to2d(x) for x in arrays] + list(scalars),
                    config)
    outs = out if isinstance(out, tuple) else (out,)
    res = tuple(o.reshape(-1)[:n] for o in outs)
    return res[0] if len(res) == 1 else res


def emit_spec(spec: loopir.TraversalSpec, inputs: Sequence,
              config: StridingConfig, device=None):
    """The whole pipeline for one call on the card: plan blocks → refuse
    what the template refuses → pad operands → hand kernel → crop to
    the original domain.  1-D nests are loop-blocked into a 2-D tile
    grid first (§5.1.1).  A writes-only spec has no operand to take a
    device from: its kernel makes its output on ``device``."""
    n = len(spec.reads)
    if len(inputs) != n + len(spec.scalars):
        raise ValueError(f"{spec.name}: expected {n} arrays + "
                         f"{len(spec.scalars)} scalars")
    arrays, scalars = list(inputs[:n]), list(inputs[n:])
    info = loopir.classify(spec)        # once, shared by the steps below
    if info.blocked:
        return _emit_blocked(spec, info, arrays, scalars, config)
    kernel = _hand_kernel(spec, config, info)
    bp = transforms.plan_blocks(spec, config, info=info)
    rows = spec.axis(bp.info.stride_axis).extent
    if bp.info.stride_reduction and bp.rows != rows:
        # zero-padded rows would have to contribute the combine identity
        # through the body, which no generic body guarantees (and max /
        # online_softmax structurally cannot) — refuse rather than
        # silently corrupt, for EVERY combinator
        raise ValueError(
            f"{spec.name}: a stride-axis reduction cannot pad the stride "
            f"axis ({rows} rows, D={bp.d}); pick a D dividing the extent")
    arrays = _pad_arrays(spec, bp, arrays)
    targets = {bp.info.stride_axis: bp.rows, bp.info.vector_axis: bp.cols}
    spec_p = dataclasses.replace(spec, axes=tuple(
        dataclasses.replace(ax, extent=targets.get(ax.name, ax.extent))
        for ax in spec.axes))
    if spec.reads:
        out = kernel(spec_p, bp, arrays, scalars, config)
    else:
        if device is None:
            raise ValueError(f"{spec.name}: a writes-only spec needs the "
                             "device to make its output on")
        out = kernel(spec_p, bp, arrays, scalars, config,
                     device=torch.device(device))
    outs = out if isinstance(out, tuple) else (out,)
    res = tuple(o[tuple(slice(0, s) for s in shape)]
                for o, shape in zip(outs, spec.out_shapes()))
    return res[0] if len(res) == 1 else res


def run_spec(build_spec: Callable[..., loopir.TraversalSpec],
             inputs: Sequence, config: StridingConfig,
             mode: Optional[str] = None, device=None):
    """Device-dispatched spec execution: ``mode="ref"`` (or CPU inputs)
    runs the plain PyTorch version; CUDA inputs run the hand kernel or
    raise.  The route follows the first input's device, or ``device``
    where it is given; a writes-only spec (whose inputs are scalars
    only) must give it."""
    # imported here: the kernels package imports the codegen at its top
    from repro_torch.kernels import common
    spec = build_spec(*inputs)
    if device is None:
        if not spec.reads:
            raise ValueError(f"{spec.name}: a writes-only spec needs an "
                             "explicit device")
        device = inputs[0].device
    device = torch.device(device)
    if common.kernel_mode(device, mode) == "ref":
        return loopir.evaluate(spec, inputs, device=device)
    return emit_spec(spec, inputs, config, device=device)
