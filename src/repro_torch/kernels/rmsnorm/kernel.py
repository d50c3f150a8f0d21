"""The rmsnorm instance of the K1 template as a CUDA kernel
(``csrc/rmsnorm.cu``), replacing ``_emit_streaming``
(``src/repro/codegen/emit.py:410``) with the rmsnorm body.

A thread keeps its vectors of the rows in registers (16 bytes each,
or, where a row is not a whole number of 16-byte vectors, the widest of
8, 4, 2 bytes that keeps every row's start on a vector boundary); a
block takes a short run of items (an item: a row slot's D rows
``s + k·seg`` in groups of K), two in flight; a row too long for one
block's registers is split over a thread-block cluster
(:func:`geometry`).

:func:`emit` launches it on CUDA tensors (or raises); on CPU tensors it
runs the kernel's plain version, the spec through ``loopir.evaluate``.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import BlockPlan
from repro_torch.kernels import cuda

__all__ = ["RMSNORM", "Geometry", "geometry", "smem_of", "occupancy",
           "launch", "emit"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# rmsnorm_ms_launch(dtype, x, w, o, r, rows, dm, d, bm, vb, vecs, cs,
#                   chunk, ipb, grid, threads, eps, stream)
RMSNORM = cuda.CudaKernel("rmsnorm", "rmsnorm", "rmsnorm_ms_launch",
                          [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _F])

THREADS = 256          # at most, a block (rmsnorm.cu THREADS)
PREFER_THREADS = 128   # a block's threads where the row allows
HOLD = 8               # 16-byte vectors a thread holds an item (K * V)
MAX_CLUSTER = 8        # blocks of a cluster (the portable size)
ONE_ITEM_PER_SM = 2    # blocks of one item an SM before runs of two
_WARP = 32


@dataclass(frozen=True)
class Geometry:
    """One launch of ``csrc/rmsnorm.cu``: ``cluster`` blocks split each
    row's ``nvec`` vectors of ``vector_bytes`` into chunks of ``chunk``
    (the last rank's may be shorter); a thread holds ``vectors`` of a
    row's chunk for ``streams`` rows at a time (an item: ``streams ·
    vectors = HOLD``); a cluster takes a run of ``items`` consecutive
    items; ``blocks`` blocks of ``threads`` threads."""
    vector_bytes: int
    nvec: int
    cluster: int
    chunk: int
    vectors: int
    streams: int
    threads: int
    items: int
    blocks: int


def geometry(rows: int, dm: int, itemsize: int, d: int, sms: int,
             cluster: int | None = None,
             items: int | None = None) -> Geometry:
    """The launch geometry for ``rows`` rows of ``dm`` elements of
    ``itemsize`` bytes in ``d`` streams on a card of ``sms`` SMs.

    A vector is 16 bytes where ``dm · itemsize`` is a multiple of 16,
    else the widest of 8, 4, 2 bytes that divides it, so every row
    starts on a vector boundary.  The cluster is the fewest blocks (a
    power of two) whose registers hold a row, ``THREADS · HOLD`` vectors
    a block; a row over ``MAX_CLUSTER`` such blocks (256 KB of 16-byte
    vectors, less of narrower ones) is refused (``ValueError``).  A
    thread holds the fewest vectors of a row (a power of two, at most
    ``HOLD``) that let ``PREFER_THREADS`` threads cover a chunk, so what
    it holds follows ``dm · itemsize``; narrower vectors are held
    ``HOLD`` a thread (one instance a width); it holds ``HOLD /
    vectors`` rows at a time.  The ``rows / d`` slots in groups of those rows are the
    items: one a cluster where they fit ``ONE_ITEM_PER_SM`` an SM, else
    runs of two (the second's loads in flight while the first is
    reduced).  ``cluster`` (a larger power of two) and ``items`` replace
    the rule's choices, for a sweep."""
    vb = math.gcd(dm * itemsize, 16)
    nvec, seg = dm * itemsize // vb, rows // d
    cs = 1
    while cs * THREADS * HOLD < nvec:
        cs *= 2
    if cs > MAX_CLUSTER:
        raise ValueError(f"rmsnorm kernel: a row of {dm * itemsize} bytes "
                         f"exceeds the {MAX_CLUSTER * THREADS * HOLD * vb} "
                         f"a cluster holds in registers as {vb}-byte "
                         "vectors")
    cs = max(cs, cluster or 1)
    chunk = -(-nvec // cs)
    v = 1 if vb == 16 else HOLD
    while v < HOLD and v * PREFER_THREADS < chunk:
        v *= 2
    threads = -(-chunk // (v * _WARP)) * _WARP
    k = HOLD // v
    n = seg * -(-d // k)
    ipb = items or (1 if n <= ONE_ITEM_PER_SM * sms else 2)
    return Geometry(vb, nvec, cs, chunk, v, k, threads, ipb,
                    -(-n // ipb) * cs)


def smem_of(spec: loopir.TraversalSpec, bp: BlockPlan, config,
            dtype: torch.dtype, sms: int) -> int:
    """Dynamic shared memory :func:`emit` requests (the static verifier's
    RES001): none (w and the partials are static arrays), but
    :func:`geometry`'s ``ValueError`` for a row no cluster holds."""
    geometry(bp.rows, bp.cols, dtype.itemsize, bp.d, sms)
    return 0


def occupancy(dtype: torch.dtype, g: Geometry) -> int:
    """Blocks of ``g``'s instance one SM keeps resident (the occupancy
    API on the current card)."""
    out = ctypes.c_int(0)
    lib = cuda.library("rmsnorm")
    fn = lib.rmsnorm_ms_occupancy
    fn.argtypes = [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(cuda.dtype_code(dtype), g.vector_bytes, g.vectors, g.threads,
             ctypes.byref(out))
    if err:
        raise RuntimeError(f"rmsnorm occupancy: CUDA error {err}")
    return out.value


def launch(x: torch.Tensor, w: torch.Tensor, eps: float, bp: BlockPlan,
           g: Geometry):
    """Launch the kernel on ``x [rows, dm]`` and ``w [dm]`` (checked by
    :func:`emit`) with the geometry ``g``: ``(o, r)``."""
    rows, dm = x.shape
    o = torch.empty_like(x)
    r = torch.empty(rows, dtype=torch.float32, device=x.device)
    RMSNORM(x.device, cuda.dtype_code(x.dtype), x.data_ptr(), w.data_ptr(),
            o.data_ptr(), r.data_ptr(), rows, dm, bp.d, bp.bm,
            g.vector_bytes, g.vectors, g.cluster, g.chunk, g.items,
            g.blocks, g.threads, float(eps))
    return o, r


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
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("rmsnorm kernel: x and w must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return launch(x, w, eps, bp,
                  geometry(rows, dm, x.element_size(), bp.d, sms))
