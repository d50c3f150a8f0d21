"""The adamw_update instance of the K1 template as a CUDA kernel
(``csrc/adamw.cu``), replacing ``_emit_streaming``
(``src/repro/codegen/emit.py:410``) with the adamw body.

:func:`emit` launches it on CUDA tensors (or raises); on CPU tensors it
runs the kernel's plain version, the spec through ``loopir.evaluate``.
The kernel stores p' in p's dtype (one rounding of the body's f32 p',
which the op casts to p's dtype anyway), m' and v' in f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["ADAMW", "emit"]

_P, _I = ctypes.c_void_p, ctypes.c_int

# adamw_launch(dtype, p, g, m, v, s, po, mo, vo, rows, cols, d, bm, ns,
#              interleaved, stream)
ADAMW = cuda.CudaKernel("adamw_update", "adamw", "adamw_launch",
                        [_I, *[_P] * 8, _I, _I, _I, _I, _I, _I])


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig | None = None):
    """Run the adamw spec on its ``[rows, cols]`` tiles: ``(p', m', v')``."""
    p, g, m, v = arrays
    if not p.is_cuda:
        return loopir.evaluate(spec, list(arrays) + list(scalars))
    shape = (bp.rows, bp.cols)
    cuda.check_operands(spec.name, [p, g], [shape, shape])
    cuda.check_operands(spec.name, [m, v], [shape, shape])
    if m.dtype != torch.float32 or m.device != p.device:
        raise TypeError(f"{spec.name} kernel: m and v must be f32 on "
                        f"{p.device}, got {m.dtype} on {m.device}")
    s = cuda.f32_scalars(scalars, p.device)    # [7] on the card
    po = torch.empty_like(p)
    mo, vo = torch.empty_like(m), torch.empty_like(v)
    ADAMW(p.device, cuda.dtype_code(p.dtype), p.data_ptr(), g.data_ptr(),
          m.data_ptr(), v.data_ptr(), s.data_ptr(), po.data_ptr(),
          mo.data_ptr(), vo.data_ptr(), *cuda.sweep_geometry(bp, config))
    return po, mo, vo
