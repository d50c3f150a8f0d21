"""The doitgen instance of the K1 template as a CUDA kernel
(``csrc/doitgen.cu``), replacing ``_emit_streaming``
(``src/repro/codegen/emit.py:410``) with the doitgen body
(``specs.py``: ``einsum("bqs,sp->bqp")`` in f32).

The TPU kernel's grid is (batch ``r``, row block); each step loads the
D stream blocks ``A[r, i + k·seg, :]`` at whole width (``s`` is a free
axis), holds ``C4 [s, p]`` resident and contracts over ``s`` on the MXU.
Here a block owns one batch element, a run of ``rb`` rows of every
stream (the D·rb rows ``k·seg + j·rb + t``, walked in passes of a 64- or
128-row tile) and a tile of ``p`` columns (:func:`geometry`); bf16 and
f16 contract on the tensor cores (``mma.sync``, f32 accumulators), f32
with fused multiply-adds.  Any ``s`` and ``p`` are taken (``cuda.check_arrays``):
the 16-byte instance where ``s``, ``p`` and the operands' addresses
allow it, the element-wise staging instance elsewhere.

:func:`emit` launches the kernel on CUDA tensors (or raises); on CPU
tensors it runs the kernel's plain version, the spec through
``loopir.evaluate``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["DOITGEN", "TILES", "MMA_COLS", "Geometry", "geometry", "smem",
           "smem_of", "emit"]

_P, _I = ctypes.c_void_p, ctypes.c_int

# doitgen_launch(dtype, A, C4, o, r, rows, s, p, d, rb, tile, vec, blocks,
#                stream)
DOITGEN = cuda.CudaKernel("doitgen", "doitgen", "doitgen_launch",
                          [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I])

# rows of a block's pass (csrc/doitgen.cu instances), the largest first;
# a block's p columns: the tile in f32, MMA_COLS in bf16 and f16 (so a
# thread of the tensor-core kernel holds at most 32 accumulators)
TILES = (128, 64)
MMA_COLS = 64


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch of ``csrc/doitgen.cu``.

    ``tile``: rows of a pass; ``cols``: ``p`` columns of a block; ``rb``:
    rows of each stream a block owns (its D·rb rows are walked in passes
    of ``tile``); ``vec``: the 16-byte instance (else the element-wise
    staging one); ``blocks``: the grid, batch × ``seg / rb`` runs ×
    ``ceil(p / cols)`` tiles."""
    tile: int
    cols: int
    rb: int
    vec: bool
    blocks: int


def _run_rows(bp: BlockPlan, tile: int) -> int:
    """The largest multiple of ``bm`` that divides the segment with D·rb
    at most ``tile`` (``bm`` itself where even that is more)."""
    slots = bp.rows // bp.d // bp.bm
    best = 1
    for spb in range(2, slots + 1):
        if bp.d * bp.bm * spb > tile:
            break
        if slots % spb == 0:
            best = spb
    return bp.bm * best


def geometry(bp: BlockPlan, batch: int, s: int, p: int, itemsize: int,
             ptrs, sms: int) -> Geometry:
    """The launch of a ``[batch, rows, s] × [s, p]`` doitgen of
    ``itemsize``-byte elements on a card of ``sms`` SMs: the largest
    tile of :data:`TILES` whose grid keeps at least 15/16 of the SMs
    busy (the smallest where none does), ``rb`` the most rows a stream
    that fit it, and the 16-byte instance where ``s`` and ``p`` are
    whole 16-byte groups of elements and every address in ``ptrs`` (A,
    C4, o) is 16-byte aligned.  A larger tile re-reads C4 from L2 fewer
    times; a grid well below the SM count leaves SMs idle, while one
    that leaves a few idle for a single wave of larger tiles does not
    (the bench size in bf16: 128 blocks on 132 SMs)."""
    seg = bp.rows // bp.d
    per16 = 16 // itemsize
    vec = s % per16 == 0 and p % per16 == 0 and all(x % 16 == 0
                                                    for x in ptrs)
    for tile in TILES:
        cols = tile if itemsize == 4 else MMA_COLS
        rb = _run_rows(bp, tile)
        blocks = batch * (seg // rb) * -(-p // cols)
        if 16 * blocks >= 15 * sms:
            break
    return Geometry(tile, cols, rb, vec, blocks)


def smem(tile: int, itemsize: int) -> int:
    """Dynamic shared memory of the instance for ``tile`` rows a pass
    (``csrc/doitgen.cu``): bf16 / f16, ``mma_smem_bytes<tile>``, 4
    stages of an A chunk [tile][32 + 8] and a C4 chunk [32][64 + 8];
    f32, ``f32_smem_bytes<tile / 16>``, 3 stages of A transposed
    [bk][tile + 4] and C4 [bk][tile], bk = 8 at tile 128, else 16."""
    if itemsize == 2:
        return 4 * (tile * (32 + 8) + 32 * (MMA_COLS + 8)) * 2
    bk = 8 if tile > 64 else 16
    return 3 * bk * ((tile + 4) + tile) * 4


def smem_of(spec: loopir.TraversalSpec, bp: BlockPlan,
            config: StridingConfig | None, dtype: torch.dtype,
            sms: int) -> int:
    """Dynamic shared memory :func:`emit` requests for ``spec`` (the
    static verifier's RES001): :func:`smem` at :func:`geometry`'s tile
    (the tile does not depend on the operands' alignment)."""
    (batch,) = bp.info.batch_axes
    (free,) = bp.info.free_axes
    geo = geometry(bp, spec.axis(batch).extent, spec.axis(free).extent,
                   bp.cols, dtype.itemsize, (), sms)
    return smem(geo.tile, dtype.itemsize)


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig | None = None) -> torch.Tensor:
    """Run the (row-padded) doitgen spec: ``o [r, rows, p]`` in A's dtype
    from ``A [r, rows, s]`` and ``C4 [s, p]``."""
    a, c4 = arrays
    if not a.is_cuda:
        return loopir.evaluate(spec, list(arrays) + list(scalars))
    (batch,) = bp.info.batch_axes
    r = spec.axis(batch).extent
    s, p = c4.shape[0], bp.cols
    cuda.check_arrays(spec.name, [a, c4], [(r, bp.rows, s), (s, p)])
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    o = torch.empty(r, bp.rows, p, dtype=a.dtype, device=a.device)
    geo = geometry(bp, r, s, p, a.element_size(),
                   (a.data_ptr(), c4.data_ptr(), o.data_ptr()), sms)
    DOITGEN(a.device, cuda.dtype_code(a.dtype), a.data_ptr(), c4.data_ptr(),
            o.data_ptr(), r, bp.rows, s, p, bp.d, geo.rb, geo.tile,
            int(geo.vec), geo.blocks)
    return o
