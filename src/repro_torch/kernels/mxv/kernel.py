"""The mxv-family instances of the K2 and K3 templates as CUDA kernels,
with gemver's matrix-vector steps, which are instances of the same two.

  * :func:`rowdot` — ``csrc/reduction.cu``, replacing ``_emit_reduction``
    (``src/repro/codegen/emit.py:491``) with the ``mxv``, ``bicg_q`` and
    ``gemver_mxv2`` bodies: y[i] = s · Σ_j A[i, j] x[j] (s = α for
    ``gemver_mxv2``, else 1), on rowstat's sweep: one wave of blocks of
    8 warps, a warp a (row slot, column part), 16-byte lanes with the
    next step's loads in flight, x staged once a block in shared memory
    where it takes at most 64 KiB (:func:`rowdot_geometry`).
  * :func:`coldot` — ``csrc/stream_reduction.cu``, replacing
    ``_emit_stream_reduction`` (``src/repro/codegen/emit.py:564``) with
    the ``mxv_t``, ``bicg_s`` and ``gemver_mxv1`` bodies and the "sum"
    combinator: y[j] = s · Σ_i x[i] A[i, j] (s = β for ``gemver_mxv1``),
    in one launch.  The TPU kernel carried one accumulator row across a
    row grid that runs in order; here a block of a 128-column block
    keeps the D streams' loads in flight (16 bytes a thread, the next
    step's loads issued before the current one is folded) and one f32
    partial row, scaled by s as the TPU kernel scaled each block; the
    ``cluster`` blocks of a column block (:func:`geometry`) each take
    1/cluster of every segment's rows and fold their partial rows in
    rank order through distributed shared memory: no second pass.
    ``gemver_mxv1_sum`` (``SumWithTotal``) keeps the row in f32 and
    :func:`coldot_total` also writes its total: each cluster sums its
    columns in a fixed order, and the last cluster (a ticket on a
    per-device, per-stream counter) folds the column-block sums.

A scalar s reaches the kernel as an f32 argument when it is a Python
number, and as a pointer to a 0-d f32 on the card when it is a tensor
(no host sync).  Each instance has its own launch counts.  Each wrapper
launches its kernel on CUDA tensors (or raises) and runs its plain
version on CPU tensors: the spec through ``loopir.evaluate`` for the
row-dot; for the column-dot the spec body over each cluster rank's rows
(:func:`split_plain`) and their sum in rank order (:func:`merge_plain`),
the kernel's order up to f32 reassociation within a rank.
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import LANE, BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["ROWDOT", "COLDOT", "MXV2", "MXV1", "MXV1_SUM", "Geometry",
           "geometry", "launch_geometry", "clusters", "RowdotGeometry",
           "rowdot_geometry", "X_SHARED", "smem_of", "emit", "rowdot",
           "coldot", "coldot_total", "split_plain", "merge_plain",
           "rank_rows"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# rowdot_launch(dtype, A, x, y, scale_ptr, scale, rows, cols, d, bm,
#               parts, spb, grid, xs, interleaved, stream)
_ROWDOT_ARGS = [_I, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _I]
ROWDOT = cuda.CudaKernel("mxv", "reduction", "rowdot_launch", _ROWDOT_ARGS)
MXV2 = cuda.CudaKernel("gemver_mxv2", "reduction", "rowdot_launch",
                       _ROWDOT_ARGS)
# coldot_launch(dtype, A, x, y, csum, total, ticket, scale_ptr, scale,
#               rows, cols, d, spr, cs, stream)
_COLDOT_ARGS = [_I, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I]
COLDOT = cuda.CudaKernel("mxv_t", "stream_reduction", "coldot_launch",
                         _COLDOT_ARGS)
MXV1 = cuda.CudaKernel("gemver_mxv1", "stream_reduction", "coldot_launch",
                       _COLDOT_ARGS)
MXV1_SUM = cuda.CudaKernel("gemver_mxv1_sum", "stream_reduction",
                           "coldot_launch", _COLDOT_ARGS)

# K2 instances → their row-dot launch count
_ROW_DOT = {"mxv": ROWDOT, "bicg_q": ROWDOT, "gemver_mxv2": MXV2}
# K3 instances → their column-dot launch count
_COL_DOT = {"mxv_t": COLDOT, "bicg_s": COLDOT, "gemver_mxv1": MXV1,
            "gemver_mxv1_sum": MXV1_SUM}
COLS = 128                         # columns of a column block (COLS in .cu)
THREADS = 128                      # a block's threads (THREADS in .cu)
LOADS = 8                          # 16-byte loads a thread a step
BLOCKS_PER_SM = 2                  # blocks an SM the grid aims at
MAX_CLUSTER = 8                    # the portable cluster size
_PLAIN_SMS = 132                   # the plain version's geometry on a CPU
X_SHARED = 65536                   # most bytes of x a row-dot block stages


@dataclass(frozen=True)
class Geometry:
    """One launch of ``csrc/stream_reduction.cu`` ``coldot``: ``ncb``
    column blocks of :data:`COLS` columns, each a cluster of ``cluster``
    blocks; rank r takes the slots ``r·rows_a_rank ...`` of every one of
    the D segments of ``seg`` rows; a block's :data:`THREADS` threads
    are ``column_threads`` (16 bytes each) by ``row_groups``; a step is
    ``streams`` streams by ``slots`` consecutive slots; ``blocks`` blocks
    in ``waves`` waves of :data:`BLOCKS_PER_SM` blocks an SM."""
    ncb: int
    cluster: int
    seg: int
    rows_a_rank: int
    column_threads: int
    row_groups: int
    streams: int
    slots: int
    blocks: int
    waves: int


def geometry(rows: int, cols: int, d: int, itemsize: int, sms: int,
             cluster: int | None = None, resident=None) -> Geometry:
    """The column-dot's launch geometry for ``[rows, cols]`` (``cols`` a
    multiple of 128) in ``d`` streams on a card of ``sms`` SMs.

    Blocks are :data:`THREADS` threads.  The cluster is the largest power
    of two, at most ``MAX_CLUSTER`` and at most the ``rows / d`` rows of
    a segment, that keeps the grid of ``cols / 128`` clusters within
    ``BLOCKS_PER_SM`` blocks an SM and, where ``resident(cs)`` (the
    clusters of ``cs`` blocks the card keeps resident at once) is given,
    within one wave of resident clusters.  ``cluster`` (a power of two
    up to 8) replaces the rule's choice, for a sweep.  A step is K
    streams (the smallest power of two up to ``d``, at most 8) by
    ``8 / K`` slots."""
    seg = rows // d
    ncb = cols // COLS
    cs = 1
    while (cs * 2 <= MAX_CLUSTER and cs * 2 <= seg
           and ncb * cs * 2 <= BLOCKS_PER_SM * sms
           and (resident is None or ncb <= resident(cs * 2))):
        cs *= 2
    if cluster is not None:
        if cluster not in (1, 2, 4, 8):
            raise ValueError(f"column-dot: a cluster of {cluster} blocks")
        cs = cluster
    k = 1
    while k < min(d, LOADS):
        k *= 2
    ct = COLS * itemsize // 16
    blocks = ncb * cs
    return Geometry(ncb, cs, seg, -(-seg // cs), ct, THREADS // ct, k,
                    LOADS // k, blocks,
                    -(-blocks // (BLOCKS_PER_SM * sms)))


@dataclass(frozen=True)
class RowdotGeometry:
    """One launch of ``csrc/reduction.cu`` ``rowdot``: rowstat's sweep
    (:func:`~repro_torch.kernels.gen.kernel.rowstat_geometry`: ``streams``
    rows a group, ``parts`` warps a row slot of ``per_part`` of a row's
    ``units`` 16-byte lane units, ``blocks`` blocks of ``slots`` row
    slots), ``tail`` where a 16-bit row ends in an odd sub-portion (one
    8-byte load a lane, in the last part), and x staged in ``smem``
    bytes of shared memory a block (0: read through ``__ldg``)."""
    streams: int
    parts: int
    units: int
    per_part: int
    slots: int
    blocks: int
    tail: bool
    smem: int


def rowdot_geometry(rows: int, cols: int, itemsize: int, d: int,
                    sms: int, parts: int | None = None,
                    x_shared: bool = True) -> RowdotGeometry:
    """The row-dot's launch for A ``[rows, cols]`` (``cols`` a multiple
    of 128) of ``itemsize`` bytes in ``d`` streams on a card of ``sms``
    SMs: rowstat's geometry (x in shared memory adds no registers), and
    x staged where its ``cols · itemsize`` bytes are at most
    :data:`X_SHARED`.  ``parts`` replaces the rule's, and ``x_shared=
    False`` reads x through ``__ldg`` at every width, for a sweep."""
    from repro_torch.kernels.gen.kernel import rowstat_geometry
    g = rowstat_geometry(rows, cols, itemsize, d, sms, parts)
    xbytes = cols * itemsize
    return RowdotGeometry(g.streams, g.parts, g.units, g.per_part, g.slots,
                          g.blocks, itemsize == 2 and (cols // LANE) % 2 == 1,
                          xbytes if x_shared and xbytes <= X_SHARED else 0)


def smem_of(spec: loopir.TraversalSpec, bp: BlockPlan,
            config: StridingConfig | None, dtype: torch.dtype,
            sms: int) -> int:
    """Dynamic shared memory :func:`emit` requests for ``spec`` (the
    static verifier's RES001): the row-dot's staged x
    (:func:`rowdot_geometry`); the column-dot takes none."""
    if spec.name not in _ROW_DOT:
        return 0
    return rowdot_geometry(bp.rows, bp.cols, dtype.itemsize, bp.d,
                           sms).smem


def clusters(dtype: torch.dtype, d: int, cs: int) -> int:
    """Clusters of ``cs`` blocks of the instance for ``dtype`` (f32, or
    the 16-bit one) and ``d`` streams that the current card keeps
    resident at once (the occupancy API)."""
    out = ctypes.c_int(0)
    fn = cuda.library("stream_reduction").coldot_clusters
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(cuda.dtype_code(dtype), d, cs, ctypes.byref(out))
    if err:
        raise RuntimeError(f"column-dot clusters: CUDA error {err}")
    return out.value


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


def rowdot(spec: loopir.TraversalSpec, bp: BlockPlan, arrays,
           config: StridingConfig | None = None, scalars=(),
           parts: int | None = None, x_shared: bool = True) -> torch.Tensor:
    """The K2 row-dot: ``y [rows]`` in A's dtype (``parts`` and
    ``x_shared`` as :func:`rowdot_geometry` takes them, for a sweep)."""
    A, x = arrays
    if not A.is_cuda:
        return loopir.evaluate(spec, [A, x, *scalars])
    cuda.check_operands(spec.name, [A, x], [(bp.rows, bp.cols), (bp.cols,)])
    y = torch.empty(bp.rows, dtype=A.dtype, device=A.device)
    ptr, scale, keep = _scale(scalars, A.device)
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    g = rowdot_geometry(bp.rows, bp.cols, A.element_size(), bp.d, sms,
                        parts, x_shared)
    interleaved = config is not None and config.arrangement == "interleaved"
    _ROW_DOT[spec.name](A.device, cuda.dtype_code(A.dtype), A.data_ptr(),
                        x.data_ptr(), y.data_ptr(), ptr, scale, bp.rows,
                        bp.cols, bp.d, bp.bm, g.parts, g.slots, g.blocks,
                        int(g.smem > 0), int(interleaved))
    del keep
    return y


def rank_rows(bp: BlockPlan, g: Geometry, rank: int) -> torch.Tensor:
    """The rows cluster rank ``rank`` sums: its slots ``rank·rows_a_rank
    ...`` of each of the D segments, segment by segment."""
    lo = rank * g.rows_a_rank
    hi = min(g.seg, lo + g.rows_a_rank)
    return torch.cat([torch.arange(k * g.seg + lo, k * g.seg + hi)
                      for k in range(bp.d)]) if hi > lo else (
        torch.zeros(0, dtype=torch.long))


def split_plain(spec: loopir.TraversalSpec, bp: BlockPlan, arrays,
                g: Geometry, scalars=()) -> torch.Tensor:
    """Plain version of the ranks' partial rows: the spec body over each
    rank's rows, ``[cluster, cols]`` f32 in rank order."""
    A, x = arrays
    env = dict(zip(spec.scalars, scalars))
    parts = []
    for r in range(g.cluster):
        idx = rank_rows(bp, g, r).to(A.device)
        env[spec.reads[0].array] = A.index_select(0, idx)
        env[spec.reads[1].array] = x.index_select(0, idx)
        parts.append(spec.body(env).float())
    return torch.stack(parts)


def merge_plain(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the fold: the partial rows summed in rank order,
    from the sum's identity, then cast."""
    acc = torch.zeros(part.shape[1], dtype=torch.float32, device=part.device)
    for row in part:
        acc = acc + row
    return acc.to(dtype)


# (device, f32?, d, cluster) → clusters resident (the occupancy API,
# asked once)
_RESIDENT: dict = {}


def launch_geometry(bp: BlockPlan, A: torch.Tensor,
                    cluster=None) -> Geometry:
    """The geometry :func:`coldot` launches for ``A`` under ``bp``: on
    the card with its SM count and the clusters it keeps resident; on
    the CPU (the plain version's rank split) at 132 SMs."""
    if not A.is_cuda:
        return geometry(bp.rows, bp.cols, bp.d, A.element_size(),
                        _PLAIN_SMS, cluster)
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count

    def resident(cs):
        key = (A.device.index, A.dtype == torch.float32, bp.d, cs)
        if key not in _RESIDENT:
            with torch.cuda.device(A.device):
                _RESIDENT[key] = clusters(A.dtype, bp.d, cs)
        return _RESIDENT[key]
    return geometry(bp.rows, bp.cols, bp.d, A.element_size(), sms, cluster,
                    resident)


# per (device, stream): gemver_mxv1_sum's ticket counter, zeroed once;
# the last cluster of each launch leaves it 0 again
_TICKETS: dict = {}


def _ticket(device: torch.device) -> torch.Tensor:
    """The launch's ticket counter.  Under CUDA graph capture each launch
    gets a counter of its own, never shared or cached: it lies in the
    graph's memory pool and its zero fill is a node of the graph, run
    before the kernel on every replay, so graphs captured on one stream
    and replayed in any order, or on two streams at once, never share a
    counter."""
    with torch.cuda.device(device):
        if torch.cuda.is_current_stream_capturing():
            return torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def _launch(spec, bp, A, x, g, scalars, y, extra=(None, None, None)):
    ptr, scale, keep = _scale(scalars, A.device)
    _COL_DOT[spec.name](A.device, cuda.dtype_code(A.dtype), A.data_ptr(),
                        x.data_ptr(), y.data_ptr(), *extra, ptr, scale,
                        bp.rows, bp.cols, bp.d, g.rows_a_rank, g.cluster)
    del keep


def coldot(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars=(),
           cluster: int | None = None) -> torch.Tensor:
    """The column-dot: ``y [cols]`` in A's dtype, one launch
    (``cluster`` replaces the geometry's, for a sweep)."""
    A, x = arrays
    g = launch_geometry(bp, A, cluster)
    if not A.is_cuda:
        return merge_plain(split_plain(spec, bp, arrays, g, scalars),
                           A.dtype)
    cuda.check_operands(spec.name, [A, x], [(bp.rows, bp.cols), (bp.rows,)])
    y = torch.empty(bp.cols, dtype=A.dtype, device=A.device)
    _launch(spec, bp, A, x, g, scalars, y)
    return y


def coldot_total(spec: loopir.TraversalSpec, bp: BlockPlan, arrays,
                 scalars=(), cluster: int | None = None):
    """``gemver_mxv1_sum``'s column-dot: the f32 row ``[cols]`` and its
    total ``[1]``, one launch."""
    A, x = arrays
    g = launch_geometry(bp, A, cluster)
    if not A.is_cuda:
        row = merge_plain(split_plain(spec, bp, arrays, g, scalars),
                          torch.float32)
        return row, row.sum(dim=-1, keepdim=True)
    cuda.check_operands(spec.name, [A, x], [(bp.rows, bp.cols), (bp.rows,)])
    y = torch.empty(bp.cols, dtype=torch.float32, device=A.device)
    csum = torch.empty(g.ncb, dtype=torch.float32, device=A.device)
    total = torch.empty(1, dtype=torch.float32, device=A.device)
    ticket = _ticket(A.device)
    _launch(spec, bp, A, x, g, scalars, y,
            (csum.data_ptr(), total.data_ptr(), ticket.data_ptr()))
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
        row, total = coldot_total(spec, bp, [A, x], scalars)
        return row[:cols], total
    if spec.name in _COL_DOT:
        return coldot(spec, bp, arrays, scalars)
    raise NotImplementedError(f"{spec.name}: not an mxv-family instance")
