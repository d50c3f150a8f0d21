"""The mxv-family instances of the K2 and K3 templates as CUDA kernels,
with gemver's matrix-vector steps, which are instances of the same two.

  * :func:`rowdot` — ``csrc/reduction.cu``, replacing ``_emit_reduction``
    (``src/repro/codegen/emit.py:491``) with the ``mxv``, ``bicg_q`` and
    ``gemver_mxv2`` bodies: y[i] = s · Σ_j A[i, j] x[j] (s = α for
    ``gemver_mxv2``, else 1).  Grid ``rows / (D·bm)`` blocks, one warp
    per row slot, D rows in flight per column step.
  * :func:`split` and :func:`merge` — ``csrc/stream_reduction.cu``,
    replacing ``_emit_stream_reduction`` (``src/repro/codegen/emit.py:
    564``) with the ``mxv_t``, ``bicg_s`` and ``gemver_mxv1`` bodies and
    the "sum" combinator: y[j] = s · Σ_i x[i] A[i, j] (s = β for
    ``gemver_mxv1``).  The TPU kernel carried one accumulator row across
    a row grid that runs in order; Hopper blocks run in no order, so
    pass 1 (grid column blocks × D × row chunks) writes f32 partial rows,
    each scaled by s as the TPU kernel scaled each block, and pass 2 sums
    them in order k = 0 … D-1, chunk by chunk, and casts.
    ``gemver_mxv1_sum`` (``SumWithTotal``) keeps the row in f32 and its
    pass 2 (:func:`merge_total`) also writes the row's total, summed in
    a fixed order by a one-block tail.

A scalar s reaches the kernel as an f32 argument when it is a Python
number, and as a pointer to a 0-d f32 on the card when it is a tensor
(no host sync).  Each instance has its own launch counts.  Each wrapper
launches its kernel on CUDA tensors (or raises) and runs its plain
version on CPU tensors: the spec through ``loopir.evaluate`` for the
row-dot, the spec body over each segment chunk and an in-order sum for
the two passes of the column-dot.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import LANE, BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["ROWDOT", "SPLIT", "MERGE", "MXV2", "MXV1", "MXV1_MERGE",
           "MXV1_SUM", "MXV1_SUM_MERGE", "emit", "rowdot", "split", "merge",
           "merge_total", "split_plain", "merge_plain", "row_chunks"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# rowdot_launch(dtype, A, x, y, scale_ptr, scale, rows, cols, d, bm, ns,
#               interleaved, stream)
_ROWDOT_ARGS = [_I, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I]
ROWDOT = cuda.CudaKernel("mxv", "reduction", "rowdot_launch", _ROWDOT_ARGS)
MXV2 = cuda.CudaKernel("gemver_mxv2", "reduction", "rowdot_launch",
                       _ROWDOT_ARGS)
# colsum_split_launch(dtype, A, x, part, scale_ptr, scale, rows, cols, d,
#                     bm, ns, tpc, chunks, stream)
_SPLIT_ARGS = [_I, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I]
SPLIT = cuda.CudaKernel("mxv_t", "stream_reduction", "colsum_split_launch",
                        _SPLIT_ARGS)
MXV1 = cuda.CudaKernel("gemver_mxv1", "stream_reduction",
                       "colsum_split_launch", _SPLIT_ARGS)
MXV1_SUM = cuda.CudaKernel("gemver_mxv1_sum", "stream_reduction",
                           "colsum_split_launch", _SPLIT_ARGS)
# colsum_merge_launch(dtype, part, y, cols, nparts, stream)
MERGE = cuda.CudaKernel("mxv_t_merge", "stream_reduction",
                        "colsum_merge_launch", [_I, _P, _P, _I, _I])
MXV1_MERGE = cuda.CudaKernel("gemver_mxv1_merge", "stream_reduction",
                             "colsum_merge_launch", [_I, _P, _P, _I, _I])
# colsum_merge_total_launch(part, y, total, cols, nparts, stream)
MXV1_SUM_MERGE = cuda.CudaKernel("gemver_mxv1_sum_merge", "stream_reduction",
                                 "colsum_merge_total_launch",
                                 [_P, _P, _P, _I, _I])

# K2 instances → their row-dot launch count
_ROW_DOT = {"mxv": ROWDOT, "bicg_q": ROWDOT, "gemver_mxv2": MXV2}
# K3 instances → (pass 1, pass 2) launch counts
_COL_DOT = {"mxv_t": (SPLIT, MERGE), "bicg_s": (SPLIT, MERGE),
            "gemver_mxv1": (MXV1, MXV1_MERGE),
            "gemver_mxv1_sum": (MXV1_SUM, MXV1_SUM_MERGE)}
_SPLIT_SUB = 8                     # sub-portions a split block spans at most
_PLAIN_SMS = 132                   # row chunks of the plain split on a CPU


def _scale(scalars, device):
    """The body's one scalar as the launchers take it: ``(pointer to a
    0-d f32 on the card or None, f32 value)`` and the tensor to keep
    alive until the launch; no scalar is a scale of 1."""
    if not scalars:
        return None, 1.0, None
    (s,) = scalars
    if isinstance(s, torch.Tensor):
        t = s.to(device=device, dtype=torch.float32).reshape(())
        return t.data_ptr(), 0.0, t
    return None, float(s), None


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
           config: StridingConfig | None = None,
           scalars=()) -> torch.Tensor:
    """The K2 row-dot: ``y [rows]`` in A's dtype."""
    A, x = arrays
    if not A.is_cuda:
        return loopir.evaluate(spec, [A, x, *scalars])
    cuda.check_operands(spec.name, [A, x], [(bp.rows, bp.cols), (bp.cols,)])
    y = torch.empty(bp.rows, dtype=A.dtype, device=A.device)
    ptr, scale, keep = _scale(scalars, A.device)
    _ROW_DOT[spec.name](A.device, cuda.dtype_code(A.dtype), A.data_ptr(),
                        x.data_ptr(), y.data_ptr(), ptr, scale,
                        *cuda.sweep_geometry(bp, config))
    return y


def split_plain(spec: loopir.TraversalSpec, bp: BlockPlan, arrays,
                tpc: int, chunks: int, scalars=()) -> torch.Tensor:
    """Plain version of pass 1: the spec body over each chunk of each
    segment, ``[D · chunks, cols]`` f32 in order (k, chunk)."""
    A, x = arrays
    seg, tiles = bp.rows // bp.d, bp.rows // bp.d // bp.bm
    env = dict(zip(spec.scalars, scalars))
    parts = []
    for k in range(bp.d):
        for c in range(chunks):
            lo = k * seg + c * tpc * bp.bm
            hi = k * seg + min((c + 1) * tpc, tiles) * bp.bm
            env[spec.reads[0].array] = A[lo:hi]
            env[spec.reads[1].array] = x[lo:hi]
            parts.append(spec.body(env).float())
    return torch.stack(parts)


def merge_plain(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of pass 2: the partial rows summed in order, from
    the sum's identity, then cast."""
    acc = torch.zeros(part.shape[1], dtype=torch.float32, device=part.device)
    for row in part:
        acc = acc + row
    return acc.to(dtype)


def split(spec: loopir.TraversalSpec, bp: BlockPlan, arrays,
          scalars=()) -> torch.Tensor:
    """Pass 1: f32 partial rows ``[D · chunks, cols]``."""
    A, x = arrays
    if not A.is_cuda:
        return split_plain(spec, bp, arrays, *row_chunks(bp, _PLAIN_SMS),
                           scalars=scalars)
    cuda.check_operands(spec.name, [A, x], [(bp.rows, bp.cols), (bp.rows,)])
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    tpc, chunks = row_chunks(bp, sms)
    part = torch.empty(bp.d * chunks, bp.cols, dtype=torch.float32,
                       device=A.device)
    ptr, scale, keep = _scale(scalars, A.device)
    _COL_DOT[spec.name][0](A.device, cuda.dtype_code(A.dtype), A.data_ptr(),
                           x.data_ptr(), part.data_ptr(), ptr, scale, bp.rows,
                           bp.cols, bp.d, bp.bm, _split_sub(bp), tpc, chunks)
    return part


def _check_part(part: torch.Tensor, dtype: torch.dtype) -> None:
    if (part.dtype != torch.float32 or part.ndim != 2
            or not part.is_contiguous() or dtype not in cuda.DTYPES):
        raise ValueError("column-dot merge: partials must be contiguous 2-D "
                         f"f32 and the output f32, bf16 or f16, got {dtype}")


def merge(part: torch.Tensor, dtype: torch.dtype,
          name: str = "mxv_t") -> torch.Tensor:
    """Pass 2: ``y [cols]`` in ``dtype``; ``name`` is the spec whose
    launch count it adds to."""
    if not part.is_cuda:
        return merge_plain(part, dtype)
    _check_part(part, dtype)
    y = torch.empty(part.shape[1], dtype=dtype, device=part.device)
    _COL_DOT[name][1](part.device, cuda.dtype_code(dtype), part.data_ptr(),
                      y.data_ptr(), part.shape[1], part.shape[0])
    return y


def merge_total(part: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 of ``gemver_mxv1_sum``: the f32 row ``[cols]`` and its
    total ``[1]``, summed from the row as stored."""
    if not part.is_cuda:
        row = merge_plain(part, torch.float32)
        return row, row.sum(dim=-1, keepdim=True)
    _check_part(part, torch.float32)
    y = torch.empty(part.shape[1], dtype=torch.float32, device=part.device)
    total = torch.empty(1, dtype=torch.float32, device=part.device)
    MXV1_SUM_MERGE(part.device, part.data_ptr(), y.data_ptr(),
                   total.data_ptr(), part.shape[1], part.shape[0])
    return y, total


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig | None = None):
    """Run a (padded) mxv-family or gemver matrix-vector spec."""
    if len(scalars) != len(spec.scalars) or len(scalars) > 1:
        raise NotImplementedError(f"{spec.name}: the mxv kernels take at "
                                  "most one scalar, a scale")
    if spec.name in _ROW_DOT:
        return rowdot(spec, bp, arrays, config, scalars)
    if spec.name == "gemver_mxv1_sum":
        # full_width: the plan keeps the whole row in one block, unpadded;
        # zero columns past a ragged width add exact zeros to the total
        A, x = arrays
        cols = bp.cols
        if A.is_cuda and cols % LANE:
            wide = -(-cols // LANE) * LANE
            A = F.pad(A, (0, wide - cols))
            bp = dataclasses.replace(bp, cols=wide, bn=wide)
        row, total = merge_total(split(spec, bp, [A, x], scalars))
        return row[:cols], total
    if spec.name in _COL_DOT:
        return merge(split(spec, bp, arrays, scalars), arrays[0].dtype,
                     spec.name)
    raise NotImplementedError(f"{spec.name}: not an mxv-family instance")
