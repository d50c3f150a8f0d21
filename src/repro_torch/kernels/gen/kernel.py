"""The two instances of the ``*_gen`` family's own specs as CUDA kernels.

  * ``rowstat`` — ``csrc/reduction.cu`` ``RowStat``, replacing
    ``_emit_reduction`` (``src/repro/codegen/emit.py:491``) with the
    ``rowstat_spec`` body: the row max and the row sum in one sweep of x,
    two f32 ``[rows]`` outputs (the sum accumulated in f64, rounded
    once).  The row-dot's geometry: ``rows / (D·bm)``
    blocks, one warp per row slot, D rows in flight per column step.
  * ``transpose`` — ``csrc/transpose.cu``, replacing ``_emit_streaming``
    (``src/repro/codegen/emit.py:410``) with the ``transpose_spec`` body:
    y = xᵀ, written ``[cols, rows]`` directly; each block stages one
    32 × 33 shared-memory tile of each of the D row segments and stores
    it transposed.

:func:`emit` launches the kernel on CUDA tensors (or raises) and runs
the plain version, the spec through ``loopir.evaluate``, on CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["ROWSTAT", "TRANSPOSE", "emit"]

_P, _I = ctypes.c_void_p, ctypes.c_int

# rowstat_launch(dtype, x, mx, sm, rows, cols, d, bm, ns, interleaved,
#                stream)
ROWSTAT = cuda.CudaKernel("rowstat", "reduction", "rowstat_launch",
                          [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I])
# transpose_launch(dtype, x, y, rows, cols, d, stream)
TRANSPOSE = cuda.CudaKernel("transpose", "transpose", "transpose_launch",
                            [_I, _P, _P, _I, _I, _I])


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig | None = None):
    """Run the (padded) rowstat or transpose spec: ``(max, sum)`` f32
    ``[rows]`` each, or ``xᵀ`` in x's dtype."""
    (x,) = arrays
    if not x.is_cuda:
        return loopir.evaluate(spec, [x, *scalars])
    if spec.name == "rowstat":
        cuda.check_operands(spec.name, [x], [(bp.rows, bp.cols)])
        mx, sm = (torch.empty(bp.rows, dtype=torch.float32, device=x.device)
                  for _ in range(2))
        ROWSTAT(x.device, cuda.dtype_code(x.dtype), x.data_ptr(),
                mx.data_ptr(), sm.data_ptr(),
                *cuda.sweep_geometry(bp, config))
        return mx, sm
    if spec.name == "transpose":
        cuda.check_arrays(spec.name, [x], [(bp.rows, bp.cols)])
        y = torch.empty(bp.cols, bp.rows, dtype=x.dtype, device=x.device)
        TRANSPOSE(x.device, cuda.dtype_code(x.dtype), x.data_ptr(),
                  y.data_ptr(), bp.rows, bp.cols, bp.d)
        return y
    raise NotImplementedError(f"{spec.name}: not a gen-family instance")
