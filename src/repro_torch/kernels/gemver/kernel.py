"""The gemver_outer and gemver_sum instances of the K1 template as CUDA
kernels (``csrc/gemver.cu``), replacing ``_emit_streaming``
(``src/repro/codegen/emit.py:410``) with the gemver bodies.

Both sweep D row streams (rows ``r + k·seg``) with one warp per row
slot, ``seg / bm`` blocks: ``gemver_outer`` over A's rows, with the u
vectors riding the same split; ``gemver_sum`` over the tile rows of the
§5.1.1 blocking of its 1-D loop (``codegen.emit.block_1d``), which the
emitter applies before the kernel sees the operands.

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

__all__ = ["OUTER", "SUM", "emit"]

_P, _I = ctypes.c_void_p, ctypes.c_int

# gemver_outer_launch(dtype, A, u1, v1, u2, v2, o, rows, cols, d, bm, ns,
#                     interleaved, stream)
OUTER = cuda.CudaKernel(
    "gemver_outer", "gemver", "gemver_outer_launch",
    [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
# gemver_sum_launch(dtype, x, z, o, rows, cols, d, bm, ns, interleaved,
#                   stream)
SUM = cuda.CudaKernel("gemver_sum", "gemver", "gemver_sum_launch",
                      [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I])


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig | None = None) -> torch.Tensor:
    """Run the (padded) gemver_outer spec, or the blocked 2-D gemver_sum
    spec: ``o`` shaped like the first operand, in its dtype."""
    a = arrays[0]
    if not a.is_cuda:
        return loopir.evaluate(spec, list(arrays) + list(scalars))
    rows, cols = bp.rows, bp.cols
    geometry = cuda.sweep_geometry(bp, config)
    o = torch.empty(rows, cols, dtype=a.dtype, device=a.device)
    if spec.name == "gemver_outer":
        cuda.check_operands(spec.name, arrays, [(rows, cols), (rows,), (cols,),
                                                (rows,), (cols,)])
        OUTER(a.device, cuda.dtype_code(a.dtype),
              *(t.data_ptr() for t in arrays), o.data_ptr(), *geometry)
    elif spec.name == "gemver_sum":
        cuda.check_operands(spec.name, arrays, [(rows, cols), (rows, cols)])
        SUM(a.device, cuda.dtype_code(a.dtype),
            *(t.data_ptr() for t in arrays), o.data_ptr(), *geometry)
    else:
        raise NotImplementedError(f"{spec.name}: not a gemver K1 instance")
    return o
