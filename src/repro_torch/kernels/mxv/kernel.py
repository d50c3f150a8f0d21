"""The mxv-family instances of the K2 and K3 templates as CUDA kernels.

  * :func:`rowdot` — ``csrc/reduction.cu``, replacing ``_emit_reduction``
    (``src/repro/codegen/emit.py:491``) with the ``mxv`` and ``bicg_q``
    bodies: y[i] = Σ_j A[i, j] x[j].  Grid ``rows / (D·bm)`` blocks, one
    warp per row slot, D rows in flight per column step.
  * :func:`split` and :func:`merge` — ``csrc/stream_reduction.cu``,
    replacing ``_emit_stream_reduction`` (``src/repro/codegen/emit.py:
    564``) with the ``mxv_t`` and ``bicg_s`` bodies and the "sum"
    combinator: y[j] = Σ_i x[i] A[i, j].  The TPU kernel carried one
    accumulator row across a row grid that runs in order; Hopper blocks
    run in no order, so pass 1 (grid column blocks × D × row chunks)
    writes f32 partial rows and pass 2 sums them in order k = 0 … D-1,
    chunk by chunk, and casts.

Each wrapper launches its kernel on CUDA tensors (or raises) and runs
its plain version on CPU tensors: the spec through ``loopir.evaluate``
for the row-dot, the spec body over each segment chunk and an in-order
sum for the two passes of the column-dot.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import LANE, BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["ROWDOT", "SPLIT", "MERGE", "emit", "rowdot", "split", "merge",
           "split_plain", "merge_plain", "row_chunks"]

_P, _I = ctypes.c_void_p, ctypes.c_int

# rowdot_launch(dtype, A, x, y, rows, cols, d, bm, ns, interleaved, stream)
ROWDOT = cuda.CudaKernel("mxv", "reduction", "rowdot_launch",
                         [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I])
# colsum_split_launch(dtype, A, x, part, rows, cols, d, bm, ns, tpc,
#                     chunks, stream)
SPLIT = cuda.CudaKernel("mxv_t", "stream_reduction", "colsum_split_launch",
                        [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I])
# colsum_merge_launch(dtype, part, y, cols, nparts, stream)
MERGE = cuda.CudaKernel("mxv_t_merge", "stream_reduction",
                        "colsum_merge_launch", [_I, _P, _P, _I, _I])

_ROW_DOT = ("mxv", "bicg_q")       # K2 instances
_COL_DOT = ("mxv_t", "bicg_s")     # K3 instances
_SPLIT_SUB = 8                     # sub-portions a split block spans at most
_PLAIN_SMS = 132                   # row chunks of the plain split on a CPU


def _split_sub(bp: BlockPlan) -> int:
    """Sub-portions per column block of the column-dot's pass 1: the
    step's (``bn / 128``, as the JAX package's ``_lane_slices``), at most
    the 256 threads of a block (one column thread per 4 columns)."""
    return min(max(1, bp.bn // LANE), _SPLIT_SUB)


def row_chunks(bp: BlockPlan, sms: int) -> tuple[int, int]:
    """``(tiles per chunk, chunks)`` of the column-dot's pass 1: each
    segment's ``seg / bm`` row tiles are cut into chunks so the grid has
    about two blocks per SM, no chunk empty."""
    tiles = bp.rows // bp.d // bp.bm
    ncb = -(-(bp.cols // LANE) // _split_sub(bp))
    want = -(-2 * sms // (ncb * bp.d))
    chunks = max(1, min(tiles, want))
    tpc = -(-tiles // chunks)
    return tpc, -(-tiles // tpc)


def rowdot(spec: loopir.TraversalSpec, bp: BlockPlan, arrays,
           config: StridingConfig | None = None) -> torch.Tensor:
    """The K2 row-dot: ``y [rows]`` in A's dtype."""
    A, x = arrays
    if not A.is_cuda:
        return loopir.evaluate(spec, [A, x])
    cuda.check_operands(spec.name, [A, x], [(bp.rows, bp.cols), (bp.cols,)])
    y = torch.empty(bp.rows, dtype=A.dtype, device=A.device)
    ROWDOT(A.device, cuda.dtype_code(A.dtype), A.data_ptr(), x.data_ptr(),
           y.data_ptr(), *cuda.sweep_geometry(bp, config))
    return y


def split_plain(spec: loopir.TraversalSpec, bp: BlockPlan, arrays,
                tpc: int, chunks: int) -> torch.Tensor:
    """Plain version of pass 1: the spec body over each chunk of each
    segment, ``[D · chunks, cols]`` f32 in order (k, chunk)."""
    A, x = arrays
    seg, tiles = bp.rows // bp.d, bp.rows // bp.d // bp.bm
    parts = []
    for k in range(bp.d):
        for c in range(chunks):
            lo = k * seg + c * tpc * bp.bm
            hi = k * seg + min((c + 1) * tpc, tiles) * bp.bm
            parts.append(spec.body({spec.reads[0].array: A[lo:hi],
                                    spec.reads[1].array: x[lo:hi]}).float())
    return torch.stack(parts)


def merge_plain(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of pass 2: the partial rows summed in order, from
    the sum's identity, then cast."""
    acc = torch.zeros(part.shape[1], dtype=torch.float32, device=part.device)
    for row in part:
        acc = acc + row
    return acc.to(dtype)


def split(spec: loopir.TraversalSpec, bp: BlockPlan, arrays) -> torch.Tensor:
    """Pass 1: f32 partial rows ``[D · chunks, cols]``."""
    A, x = arrays
    if not A.is_cuda:
        return split_plain(spec, bp, arrays, *row_chunks(bp, _PLAIN_SMS))
    cuda.check_operands(spec.name, [A, x], [(bp.rows, bp.cols), (bp.rows,)])
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    tpc, chunks = row_chunks(bp, sms)
    part = torch.empty(bp.d * chunks, bp.cols, dtype=torch.float32,
                       device=A.device)
    SPLIT(A.device, cuda.dtype_code(A.dtype), A.data_ptr(), x.data_ptr(),
          part.data_ptr(), bp.rows, bp.cols, bp.d, bp.bm, _split_sub(bp),
          tpc, chunks)
    return part


def merge(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Pass 2: ``y [cols]`` in ``dtype``."""
    if not part.is_cuda:
        return merge_plain(part, dtype)
    if (part.dtype != torch.float32 or part.ndim != 2
            or not part.is_contiguous() or dtype not in cuda.DTYPES):
        raise ValueError("mxv_t merge: partials must be contiguous 2-D f32 "
                         f"and the output f32, bf16 or f16, got {dtype}")
    y = torch.empty(part.shape[1], dtype=dtype, device=part.device)
    MERGE(part.device, cuda.dtype_code(dtype), part.data_ptr(), y.data_ptr(),
          part.shape[1], part.shape[0])
    return y


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig | None = None):
    """Run a (padded) mxv-family spec: ``y`` in A's dtype."""
    if scalars:
        raise NotImplementedError(f"{spec.name}: the mxv kernels take no "
                                  "scalars")
    if spec.name in _ROW_DOT:
        return rowdot(spec, bp, arrays, config)
    if spec.name in _COL_DOT:
        return merge(split(spec, bp, arrays), arrays[0].dtype)
    raise NotImplementedError(f"{spec.name}: not an mxv-family instance")
