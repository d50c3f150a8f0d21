"""The K4 template, ``_emit_manual`` (``src/repro/codegen/emit.py:708``),
as a CUDA kernel (``csrc/manual_ring.cu``): explicit ``lookahead``-deep
rings of bulk copies into shared memory on mbarriers, the body fused
between load and store, and bulk stores out of a 2-deep staging ring.

The JAX package selects K4 at a ``lookahead`` other than 2 for specs
with plain ``(stride, vector)`` reads and ``(stride, vector)`` or
``(stride,)`` writes (``codegen.emit.template_of``).  The port's ring
has the bodies in :data:`BODIES`, each with one or more ``(stride,
vector)`` writes (adamw's three: p', m', v'); it raises
``NotImplementedError`` naming ``_emit_manual`` for a rank-1
``(stride,)`` side write and for an eligible spec whose body is not
ported yet.  Every operand of a ring has one dtype (``csrc/
manual_ring.cu``): adamw's ring takes f32 parameters, and a bf16 one
raises ``TypeError`` in ``cuda.check_operands``.

A step of the ring is a (row block, column tile) of every stream: the
TPU ring streamed whole rows, which do not fit a block's shared memory
at the paper's widths.  :func:`ring_tile` picks the widest tile of whole
128-element sub-portions that fits, or raises ``ValueError`` naming the
bytes; it never changes D or ``lookahead``.  The grid splits each
segment's steps into contiguous runs, about two blocks per SM
(:func:`ring_runs`).

:func:`emit` launches the kernel on CUDA tensors (or raises) and runs
the spec's plain version (``loopir.evaluate``) on CPU tensors: every
ported body is elementwise, so the tile walk gives the same bits.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import LANE, BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["BODIES", "OUT_STAGES", "ring_smem", "ring_tile", "ring_runs",
           "emit"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GEOM = [_I] * 8     # rows, cols, d, bm, tw, la, per, interleaved

# one launcher per body: spec name → its kernel
BODIES = {
    # manual_copy_launch(dtype, x, o, <geometry>, stream)
    "stream_copy": cuda.CudaKernel("manual_ring_copy", "manual_ring",
                                   "manual_copy_launch", [_I, _P, _P, *_GEOM]),
    # manual_triad_launch(dtype, b, c, o, alpha, <geometry>, stream)
    "stream_triad": cuda.CudaKernel("manual_ring_triad", "manual_ring",
                                    "manual_triad_launch",
                                    [_I, _P, _P, _P, _F, *_GEOM]),
    # manual_fill_launch(dtype, o, value, <geometry>, stream)
    "stream_init": cuda.CudaKernel("manual_ring_fill", "manual_ring",
                                   "manual_fill_launch", [_I, _P, _F, *_GEOM]),
    # manual_sum_launch(dtype, x, z, o, <geometry>, stream)
    "gemver_sum": cuda.CudaKernel("manual_ring_gemver_sum", "manual_ring",
                                  "manual_sum_launch",
                                  [_I, _P, _P, _P, *_GEOM]),
    # manual_adamw_launch(dtype, p, g, m, v, s, po, mo, vo, <geometry>,
    #                     stream); s the f32 [7] scalars on the card
    "adamw_update": cuda.CudaKernel("manual_ring_adamw", "manual_ring",
                                    "manual_adamw_launch",
                                    [_I, *[_P] * 8, *_GEOM]),
}

OUT_STAGES = 2            # the staging ring's depth, as the TPU kernel's


def ring_smem(n_in: int, n_out: int, d: int, bm: int, tw: int, la: int,
              itemsize: int) -> int:
    """Dynamic shared memory of a ring: the mbarrier header (8 bytes per
    input slot, padded to 128) and ``la·D`` stages per input plus
    ``2·D`` per output, each ``bm × tw`` elements (``csrc/manual_ring.cu``
    ``ring_t``)."""
    header = -(-8 * n_in * la // 128) * 128
    return header + (la * n_in + OUT_STAGES * n_out) * d * bm * tw * itemsize


def ring_tile(bp: BlockPlan, config: StridingConfig, dtype: torch.dtype,
              limit: int, n_in: int = 1, n_out: int = 1) -> int:
    """The column width of a ring step: the widest multiple of 128
    dividing ``bp.cols`` whose ring fits ``limit`` bytes.  Raises
    ``ValueError`` naming the bytes where even 128 columns do not fit
    (as the JAX checker's manual-ring budget does); D and ``lookahead``
    are never changed to make it fit."""
    la, isz = config.lookahead, dtype.itemsize
    need = ring_smem(n_in, n_out, bp.d, bp.bm, LANE, la, isz)
    if need > limit:
        raise ValueError(
            f"K4 ring does not fit shared memory: {need} bytes for a "
            f"128-column step (lookahead {la} x D {bp.d} stages of "
            f"{bp.bm} x 128 x {isz} bytes for each of {n_in} inputs, 2 x D "
            f"for each of {n_out} outputs, and the barriers) against a "
            f"limit of {limit} bytes")
    nsub = bp.cols // LANE
    for units in range(nsub, 0, -1):
        if nsub % units == 0 and ring_smem(n_in, n_out, bp.d, bp.bm,
                                           units * LANE, la, isz) <= limit:
            return units * LANE
    raise AssertionError("unreachable: 128 columns fit")


def ring_runs(steps: int, sms: int) -> tuple[int, int]:
    """``(steps per block, blocks)``: each segment's steps cut into
    contiguous runs, about two blocks per SM, none empty."""
    per = -(-steps // max(1, min(steps, 2 * sms)))
    return per, -(-steps // per)


def _refuse(spec: loopir.TraversalSpec) -> Optional[str]:
    if any(len(w.index) != 2 for w in spec.writes):
        return "rank-1 (stride,) side writes are not ported"
    if spec.name not in BODIES:
        return (f"no body for {spec.name!r} in the ring yet (ported: "
                f"{', '.join(BODIES)})")
    return None


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig, device=None):
    """Run a (padded) K4 spec: its output, ``[rows, cols]``, or a tuple
    of them for a spec with several writes."""
    why = _refuse(spec)
    if why is not None:
        raise NotImplementedError(
            f"{spec.name}: the K4 template _emit_manual "
            f"(src/repro/codegen/emit.py:708) on Hopper: {why} "
            "(ROADMAP Queue 2). Use mode='ref' for the plain version.")
    dev = arrays[0].device if arrays else torch.device(device)
    if dev.type != "cuda":
        return loopir.evaluate(spec, [*arrays, *scalars], device=dev)
    out_dtypes = spec.out_dtypes(arrays)
    dtype = out_dtypes[0]
    n_in, n_out = len(spec.reads), len(spec.writes)
    outs = [torch.empty(bp.rows, bp.cols, dtype=dt, device=dev)
            for dt in out_dtypes]
    cuda.check_operands(spec.name, [*arrays, *outs],
                        [(bp.rows, bp.cols)] * (n_in + n_out))
    props = torch.cuda.get_device_properties(dev)
    tw = ring_tile(bp, config, dtype, props.shared_memory_per_block_optin,
                   n_in, n_out)
    steps = bp.rows // bp.d // bp.bm * (bp.cols // tw)
    per, _ = ring_runs(steps, props.multi_processor_count)
    geometry = (bp.rows, bp.cols, bp.d, bp.bm, tw, config.lookahead, per,
                int(config.arrangement == "interleaved"))
    ptrs = [t.data_ptr() for t in arrays]
    optrs = [o.data_ptr() for o in outs]
    kernel = BODIES[spec.name]
    code = cuda.dtype_code(dtype)
    if spec.name == "stream_triad":
        kernel(dev, code, *ptrs, *optrs, float(scalars[0]), *geometry)
    elif spec.name == "stream_init":
        kernel(dev, code, *optrs, float(scalars[0]), *geometry)
    elif spec.name == "adamw_update":
        s = cuda.f32_scalars(scalars, dev)        # [7] on the card
        kernel(dev, code, *ptrs, s.data_ptr(), *optrs, *geometry)
    else:
        kernel(dev, code, *ptrs, *optrs, *geometry)
    return outs[0] if n_out == 1 else tuple(outs)
