"""The gemver_outer and gemver_sum instances of the K1 template as CUDA
kernels (``csrc/gemver.cu``), replacing ``_emit_streaming``
(``src/repro/codegen/emit.py:410``) with the gemver bodies.

``gemver_outer`` gives a thread one 16-byte column vector of A, its v1
and v2 held in registers: blocks of 128 threads are column tiles, each
walking a run of row slots of the D segments (rows ``s + k·seg``), a
step U slots of K streams with the next step's loads in flight
(:func:`outer_geometry`).  ``gemver_sum`` runs on the §5.1.1 blocking of its 1-D loop
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

__all__ = ["OUTER", "SUM", "OUTER_THREADS", "OUTER_LOADS", "OUTER_RUN",
           "OUTER_AIM", "OuterGeometry", "outer_geometry", "outer_launch",
           "outer_occupancy",
           "SUM_UNIT", "SUM_HELD", "SumGeometry", "sum_geometry",
           "sum_occupancy", "emit"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# gemver_outer_launch(dtype, A, u1, v1, u2, v2, o, rows, cols, d, bm, run,
#                     interleaved, stream)
OUTER = cuda.CudaKernel(
    "gemver_outer", "gemver", "gemver_outer_launch",
    [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I])
# gemver_sum_launch(dtype, x, z, o, segv, d, np, interleaved, stream)
SUM = cuda.CudaKernel("gemver_sum", "gemver", "gemver_sum_launch",
                      [_I, _P, _P, _P, _L, _I, _I, _I])

OUTER_THREADS = 128     # threads of a block: a column tile's vectors
OUTER_LOADS = 4         # 16-byte loads of A a thread a step (K·U)
OUTER_RUN = 2           # row slots a block walks (at least a step's U)
OUTER_AIM = 8           # blocks an SM the runs are halved to reach
SUM_UNIT = 128          # threads of a block, 16-byte vectors of a unit
SUM_HELD = 4            # units a thread holds at once (csrc/gemver.cu)
_LANE = 128             # elements of a sub-portion


@dataclass(frozen=True)
class OuterGeometry:
    """gemver_outer's launch: ``tiles`` column tiles of
    :data:`OUTER_THREADS` 16-byte vectors of ``vec`` elements (``last``
    of them in the last tile, the rest of its threads idle) by ``runs``
    runs of ``run`` row slots of each of the D segments; a step is
    ``slots`` (U) slots of each of ``streams`` (K) streams, the D streams
    in ``groups`` groups of K; a block of a full run takes ``steps``
    steps."""

    vec: int
    tiles: int
    last: int
    streams: int
    slots: int
    groups: int
    run: int
    runs: int

    @property
    def threads(self) -> int:
        return OUTER_THREADS

    @property
    def blocks(self) -> int:
        return self.tiles * self.runs

    @property
    def steps(self) -> int:
        return -(-self.run // self.slots) * self.groups


def outer_geometry(rows: int, cols: int, itemsize: int, d: int, sms: int,
                   run: int | None = None) -> OuterGeometry:
    """The launch of gemver_outer on A ``[rows, cols]`` (``cols`` whole
    128-element sub-portions, ``rows`` whole D segments) of ``itemsize``
    bytes on a card of ``sms`` SMs.  K is the smallest power of two up to
    D, at most :data:`OUTER_LOADS`, and U = 4 / K.  A run is
    :data:`OUTER_RUN` slots or one step's U, whichever is more, halved
    (not under U) while the grid has fewer than :data:`OUTER_AIM` blocks
    an SM, and long enough that the runs fit a grid dimension (65535).
    Short runs are fastest on the H100: the blocks resident at once then
    cover a narrow band of whole rows (the run table of
    ``tools/torch_kernel_ab.py``).  ``run`` replaces the rule's run, for
    a sweep."""
    vec = 16 // itemsize
    nvec = cols // vec
    tiles = -(-nvec // OUTER_THREADS)
    seg = rows // d
    k = 1
    while k < min(d, OUTER_LOADS):
        k *= 2
    u = OUTER_LOADS // k
    if run is None:
        run = max(OUTER_RUN, u)
        while run > u and tiles * -(-seg // run) < OUTER_AIM * sms:
            run //= 2
    run = max(run, -(-seg // 65535))
    return OuterGeometry(vec=vec, tiles=tiles,
                         last=nvec - (tiles - 1) * OUTER_THREADS, streams=k,
                         slots=u, groups=-(-d // k), run=run,
                         runs=-(-seg // run))


def outer_launch(arrays, o: torch.Tensor, bp: BlockPlan, g: OuterGeometry,
                 interleaved: bool = False) -> None:
    """Launch gemver_outer on the (padded, checked) operands ``arrays``
    = (A, u1, v1, u2, v2) into ``o`` with the launch geometry ``g``."""
    a = arrays[0]
    OUTER(a.device, cuda.dtype_code(a.dtype),
          *(t.data_ptr() for t in arrays), o.data_ptr(), bp.rows, bp.cols,
          bp.d, bp.bm, g.run, int(interleaved))


def outer_occupancy(dtype: torch.dtype, d: int) -> int:
    """Blocks of gemver_outer's instance for ``d`` streams one SM keeps
    resident (the occupancy API on the current card)."""
    out = ctypes.c_int(0)
    fn = cuda.library("gemver").gemver_outer_occupancy
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(cuda.dtype_code(dtype), d, ctypes.byref(out))
    if err:
        raise RuntimeError(f"gemver_outer occupancy: CUDA error {err}")
    return out.value


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
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        g = outer_geometry(rows, cols, a.element_size(), bp.d, sms)
        outer_launch(arrays, o, bp, g, config is not None
                     and config.arrangement == "interleaved")
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
