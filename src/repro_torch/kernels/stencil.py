"""The jacobi2d and conv3x3 instances of the K1 template as CUDA kernels
(``csrc/stencil.cu``), replacing ``_emit_streaming``
(``src/repro/codegen/emit.py:410``) with the two stencil bodies
(``kernels/jacobi2d/specs.py``, ``kernels/conv3x3/specs.py``).

The TPU kernel lowers a row-haloed read as one-row blocks: each of the D
row streams loads its three tap rows ``i + k·seg + t``, t = 0, 1, 2
(``emit.py:186-215``), and a column halo keeps whole rows in one block,
``cols = w - 2`` wide with no 128-lane padding.  Here a block owns a
tile of :data:`TILE` output columns and a run of ``run`` rows of every
stream (:func:`stencil_runs`); each thread walks down its column of
each of the D streams with the two previous tap rows in registers.  Any
``cols`` and any row alignment are taken (``cuda.check_arrays``).

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

__all__ = ["JACOBI", "CONV", "TILE", "stencil_runs", "conv_weights", "emit"]

_P, _I = ctypes.c_void_p, ctypes.c_int

# jacobi2d_launch(dtype, x, o, rows, cols, d, run, stream)
JACOBI = cuda.CudaKernel("jacobi2d", "stencil", "jacobi2d_launch",
                         [_I, _P, _P, _I, _I, _I, _I])
# conv3x3_launch(dtype, x, w9, o, rows, cols, d, run, stream)
CONV = cuda.CudaKernel("conv3x3", "stencil", "conv3x3_launch",
                       [_I, _P, _P, _P, _I, _I, _I, _I])

TILE = 256              # output columns of a block (csrc/stencil.cu)
_BLOCKS_PER_SM = 16     # the grid the runs aim at
_MIN_RUN = 8            # a run re-reads two tap rows: keep that small
_HALO = ((1, 1), (1, 1))


def stencil_runs(bp: BlockPlan, sms: int) -> tuple[int, int]:
    """``(run, runs)``: each stream's ``seg = rows / D`` output rows are
    cut into runs of ``run`` rows (the last may be short), so the grid of
    column tiles × runs has about ``_BLOCKS_PER_SM`` blocks per SM, and
    no run is shorter than ``_MIN_RUN`` rows unless the segment is."""
    seg = bp.rows // bp.d
    tiles = -(-bp.cols // TILE)
    run = max(_MIN_RUN, -(-seg * tiles // (_BLOCKS_PER_SM * sms)))
    run = min(run, seg)
    return run, -(-seg // run)


# the nine weights as one f32 [9] tensor on the card, in C3_NAMES order
conv_weights = cuda.f32_scalars


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig | None = None) -> torch.Tensor:
    """Run the (row-padded) jacobi2d or conv3x3 spec: ``o [rows, cols]``
    in the input's dtype, from ``x [rows + 2, cols + 2]``."""
    x = arrays[0]
    if not x.is_cuda:
        return loopir.evaluate(spec, list(arrays) + list(scalars))
    if spec.reads[0].halo != _HALO or bp.bm != 1:
        raise NotImplementedError(f"{spec.name}: the stencil kernel takes "
                                  "a (1,1),(1,1) halo in one-row blocks")
    rows, cols = bp.rows, bp.cols
    cuda.check_arrays(spec.name, [x], [(rows + 2, cols + 2)])
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    run, _ = stencil_runs(bp, sms)
    o = torch.empty(rows, cols, dtype=x.dtype, device=x.device)
    code = cuda.dtype_code(x.dtype)
    if spec.name == "jacobi2d":
        JACOBI(x.device, code, x.data_ptr(), o.data_ptr(), rows, cols, bp.d,
               run)
    elif spec.name == "conv3x3":
        w9 = conv_weights(scalars, x.device)
        CONV(x.device, code, x.data_ptr(), w9.data_ptr(), o.data_ptr(), rows,
             cols, bp.d, run)
    else:
        raise NotImplementedError(f"{spec.name}: not a stencil instance")
    return o
