"""The gemver_outer and gemver_sum instances of the K1 template as CUDA
kernels (``csrc/gemver.cu``), replacing ``_emit_streaming``
(``src/repro/codegen/emit.py:410``) with the gemver bodies.

``gemver_outer`` sweeps D row streams (rows ``r + k·seg``) of A with
one warp per row slot, ``seg / bm`` blocks, the u vectors riding the
same split.  ``gemver_sum`` runs on the §5.1.1 blocking of its 1-D loop
(``codegen.emit.block_1d``, applied by the emitter before the kernel
sees the operands), whose D segments of tile rows are contiguous runs
of the flat arrays: a step of P units of 128 16-byte vectors at one
offset of every segment, D blocks of 128 threads a step, P units a
block, a thread a vector of each unit (:func:`sum_geometry`).

:func:`emit` launches the kernel on CUDA tensors (or raises); on CPU
tensors it runs the kernel's plain version, the spec through
``loopir.evaluate``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["OUTER", "SUM", "SUM_UNIT", "SUM_HELD", "SumGeometry",
           "sum_geometry", "sum_occupancy", "emit"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# gemver_outer_launch(dtype, A, u1, v1, u2, v2, o, rows, cols, d, bm, ns,
#                     interleaved, stream)
OUTER = cuda.CudaKernel(
    "gemver_outer", "gemver", "gemver_outer_launch",
    [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
# gemver_sum_launch(dtype, x, z, o, segv, d, np, interleaved, stream)
SUM = cuda.CudaKernel("gemver_sum", "gemver", "gemver_sum_launch",
                      [_I, _P, _P, _P, _L, _I, _I, _I])

SUM_UNIT = 128          # threads of a block, 16-byte vectors of a unit
SUM_HELD = 4            # units a thread holds at once (csrc/gemver.cu)
_LANE = 128             # elements of a sub-portion


@dataclass(frozen=True)
class SumGeometry:
    """gemver_sum's launch: ``d`` segments of ``segv`` 16-byte vectors of
    ``vec`` elements, cut into ``steps`` steps of ``units`` (P) units of
    :data:`SUM_UNIT` vectors (the last step may be short); ``d`` blocks
    of :data:`SUM_UNIT` threads a step, P units a block, a thread its
    vector of each unit, taken in ``passes`` of up to :data:`SUM_HELD`
    units whose loads are all issued before any add."""

    vec: int
    segv: int
    d: int
    units: int
    steps: int

    @property
    def threads(self) -> int:
        return SUM_UNIT

    @property
    def passes(self) -> int:
        return -(-self.units // SUM_HELD)

    @property
    def blocks(self) -> int:
        return self.d * self.steps


def sum_geometry(bp: BlockPlan, itemsize: int) -> SumGeometry:
    """The launch of gemver_sum on the blocked ``[rows, cols]`` tiles of
    ``bp``: each of the D segments holds ``rows / D · cols`` elements,
    whole 16-byte vectors (``cols`` is 128·P), taken P units a step."""
    vec = 16 // itemsize
    segv = bp.rows // bp.d * bp.cols // vec
    units = max(1, bp.bn // _LANE)
    return SumGeometry(vec=vec, segv=segv, d=bp.d, units=units,
                       steps=-(-segv // (units * SUM_UNIT)))


def sum_occupancy(dtype: torch.dtype, threads: int) -> int:
    """Blocks of gemver_sum of ``threads`` threads one SM keeps resident
    (the occupancy API on the current card)."""
    out = ctypes.c_int(0)
    fn = cuda.library("gemver").gemver_sum_occupancy
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(cuda.dtype_code(dtype), threads, ctypes.byref(out))
    if err:
        raise RuntimeError(f"gemver_sum occupancy: CUDA error {err}")
    return out.value


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig | None = None) -> torch.Tensor:
    """Run the (padded) gemver_outer spec, or the blocked 2-D gemver_sum
    spec: ``o`` shaped like the first operand, in its dtype."""
    a = arrays[0]
    if not a.is_cuda:
        return loopir.evaluate(spec, list(arrays) + list(scalars))
    rows, cols = bp.rows, bp.cols
    o = torch.empty(rows, cols, dtype=a.dtype, device=a.device)
    if spec.name == "gemver_outer":
        cuda.check_operands(spec.name, arrays, [(rows, cols), (rows,), (cols,),
                                                (rows,), (cols,)])
        OUTER(a.device, cuda.dtype_code(a.dtype),
              *(t.data_ptr() for t in arrays), o.data_ptr(),
              *cuda.sweep_geometry(bp, config))
    elif spec.name == "gemver_sum":
        cuda.check_operands(spec.name, arrays, [(rows, cols), (rows, cols)])
        g = sum_geometry(bp, a.element_size())
        interleaved = (config is not None
                       and config.arrangement == "interleaved")
        SUM(a.device, cuda.dtype_code(a.dtype),
            *(t.data_ptr() for t in arrays), o.data_ptr(), g.segv, bp.d,
            g.units, int(interleaved))
    else:
        raise NotImplementedError(f"{spec.name}: not a gemver K1 instance")
    return o
