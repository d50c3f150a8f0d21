"""The rmsnorm instance of the K1 template as a CUDA kernel
(``csrc/rmsnorm.cu``), replacing ``_emit_streaming``
(``src/repro/codegen/emit.py:410``) with the rmsnorm body.

:func:`emit` launches it on CUDA tensors (or raises); on CPU tensors it
runs the kernel's plain version, the spec through ``loopir.evaluate``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import BlockPlan
from repro_torch.kernels import cuda

__all__ = ["RMSNORM", "emit"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# rmsnorm_ms_launch(dtype, x, w, o, r, rows, dm, d, bm, eps, stream)
RMSNORM = cuda.CudaKernel("rmsnorm", "rmsnorm", "rmsnorm_ms_launch",
                          [_I, _P, _P, _P, _P, _I, _I, _I, _I, _F])

_KMAX = 8                        # streams in registers per pass (rmsnorm.cu)
_SMEM_LIMIT = 227 * 1024         # dynamic shared memory a block may use


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config=None):
    """Run the (padded) rmsnorm spec: ``(o [rows, dm], r [rows] f32)``."""
    x, w = arrays
    (eps,) = scalars
    if not x.is_cuda:
        return loopir.evaluate(spec, [x, w, eps])
    rows, dm = x.shape
    if (rows, dm) != (bp.rows, bp.cols):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} does not match the "
                         f"block plan ({bp.rows}, {bp.cols})")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rmsnorm kernel: unsupported dtype {x.dtype}")
    if w.dtype != x.dtype or w.shape != (dm,) or w.device != x.device:
        raise TypeError(f"rmsnorm kernel: w must be [{dm}] {x.dtype} on "
                        f"{x.device}, got {tuple(w.shape)} {w.dtype} on "
                        f"{w.device}")
    if (dm * x.element_size()) % 16:
        raise ValueError(f"rmsnorm kernel: a row of {dm} elements is not "
                         "a whole number of 16-byte vectors")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rmsnorm kernel: x and w must be 16-byte aligned")
    smem = min(bp.d, _KMAX) * dm * x.element_size() + _KMAX * 32 * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"rmsnorm kernel: {smem} bytes of shared memory "
                         f"for d={bp.d}, dm={dm} exceed {_SMEM_LIMIT}")
    o = torch.empty_like(x)
    r = torch.empty(rows, dtype=torch.float32, device=x.device)
    RMSNORM(x.device, cuda.dtype_code(x.dtype), x.data_ptr(), w.data_ptr(),
            o.data_ptr(), r.data_ptr(), rows, dm, bp.d, bp.bm, float(eps))
    return o, r
