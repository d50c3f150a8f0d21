"""The doitgen instance of the K1 template as a CUDA kernel
(``csrc/doitgen.cu``), replacing ``_emit_streaming``
(``src/repro/codegen/emit.py:410``) with the doitgen body
(``specs.py``: ``einsum("bqs,sp->bqp")`` in f32).

The TPU kernel's grid is (batch ``r``, row block); each step loads the
D stream blocks ``A[r, i + k·seg, :]`` at whole width (``s`` is a free
axis), holds ``C4 [s, p]`` resident and contracts over ``s`` inside the
body.  Here a block owns one batch element, a run of ``rb`` rows of
every stream (the D·rb rows ``k·seg + j·rb + t``; :func:`block_rows`)
and a tile of :data:`PT` columns of ``p``; the contraction runs inside
the kernel, in f32, in a fixed order over ``s``.  Any ``s`` and ``p``
are taken (``cuda.check_arrays``).

:func:`emit` launches the kernel on CUDA tensors (or raises); on CPU
tensors it runs the kernel's plain version, the spec through
``loopir.evaluate``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["DOITGEN", "PT", "block_rows", "emit"]

_P, _I = ctypes.c_void_p, ctypes.c_int

# doitgen_launch(dtype, A, C4, o, r, rows, s, p, d, rb, stream)
DOITGEN = cuda.CudaKernel("doitgen", "doitgen", "doitgen_launch",
                          [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I])


PT = 128            # p columns of a block (csrc/doitgen.cu)
_MAX_ROWS = 128     # rows of a block its thread tile is drawn for


def block_rows(bp: BlockPlan, batch: int, p: int, sms: int) -> int:
    """``rb``, the rows of each stream a block owns: a multiple of the
    plan's ``bm`` that divides the segment, the largest with at most
    :data:`_MAX_ROWS` rows a block (D·rb) whose grid keeps two blocks per
    SM.  Each block re-reads its C4 tile, so more rows a block read C4
    fewer times."""
    slots = bp.rows // bp.d // bp.bm
    tiles = -(-p // PT)
    best = 1
    for spb in range(2, slots + 1):
        if slots % spb:
            continue
        if (bp.d * bp.bm * spb > _MAX_ROWS
                or batch * (slots // spb) * tiles < 2 * sms):
            break
        best = spb
    return bp.bm * best


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
    DOITGEN(a.device, cuda.dtype_code(a.dtype), a.data_ptr(), c4.data_ptr(),
            o.data_ptr(), r, bp.rows, s, p, bp.d,
            block_rows(bp, r, p, sms))
    return o
