"""The jacobi2d and conv3x3 instances of the K1 template as CUDA kernels
(``csrc/stencil.cu``), replacing ``_emit_streaming``
(``src/repro/codegen/emit.py:410``) with the two stencil bodies
(``kernels/jacobi2d/specs.py``, ``kernels/conv3x3/specs.py``).

The TPU kernel lowers a row-haloed read as one-row blocks: each of the D
row streams loads its three tap rows ``i + k·seg + t``, t = 0, 1, 2
(``emit.py:186-215``), and a column halo keeps whole rows in one block,
``cols = w - 2`` wide with no 128-lane padding.  Here a thread computes
16 bytes of adjacent output columns (:func:`vector`) of one stream, a
block of :data:`THREADS` threads a tile of them over a run of ``run``
rows, the D streams' blocks of one (tile, run) issued together
(:func:`geometry`); each thread walks down its columns with the taps of
the last input rows in registers and the next rows in flight.  Any
``cols`` and any row alignment are taken (``cuda.check_arrays``): each
row is loaded and stored in the widest pieces that divide its address
(:func:`piece_bytes`), the columns past the last whole vector element
by element (:func:`split`).  conv3x3's weights reach the kernel as a
contiguous weight tensor's own storage where they can
(:func:`kernel_weights`).

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

__all__ = ["JACOBI", "CONV", "THREADS", "Geometry", "vector", "split",
           "piece_bytes", "stencil_runs", "geometry", "occupancy",
           "kernel_weights", "conv_weights", "launch", "emit"]

_P, _I = ctypes.c_void_p, ctypes.c_int

# jacobi2d_launch(dtype, x, o, rows, cols, d, run, stream)
JACOBI = cuda.CudaKernel("jacobi2d", "stencil", "jacobi2d_launch",
                         [_I, _P, _P, _I, _I, _I, _I])
# conv3x3_launch(dtype, x, w9, w9 dtype, o, rows, cols, d, run, stream)
CONV = cuda.CudaKernel("conv3x3", "stencil", "conv3x3_launch",
                       [_I, _P, _P, _I, _P, _I, _I, _I, _I])

THREADS = 128           # threads of a block (csrc/stencil.cu)
_RUN = 8                # rows of a run, halved while the grid is small
_MIN_BLOCKS_PER_SM = 15  # the grid a halving aims at
_MAX_RUNS = 65535       # the grid's z extent
_HALO = ((1, 1), (1, 1))


def vector(itemsize: int) -> int:
    """Output columns a thread computes: 16 bytes (4 f32, 8 bf16/f16)."""
    return 16 // itemsize


def split(cols: int, itemsize: int) -> tuple[int, int]:
    """``(whole vectors, tail columns)`` of an output row: the threads
    whose :func:`vector` columns lie in the row load and store in
    pieces; the one over the row's end (``tail`` > 0 columns) element by
    element."""
    v = vector(itemsize)
    return cols // v, cols % v


def piece_bytes(address: int) -> int:
    """The widest of 16, 8, 4, 2 bytes that divides ``address``: the
    pieces in which the kernel loads (stores) a row starting there."""
    a = address & 15
    return 16 if a == 0 else a & -a


@dataclass(frozen=True)
class Geometry:
    """A launch: ``d`` streams × ``tiles`` column tiles of ``tile`` =
    THREADS·``vec`` output columns × ``runs`` runs of ``run`` rows of
    each segment, a block each."""

    vec: int
    d: int
    tiles: int
    run: int
    runs: int

    @property
    def tile(self) -> int:
        return THREADS * self.vec

    @property
    def blocks(self) -> int:
        return self.d * self.tiles * self.runs


def stencil_runs(bp: BlockPlan, sms: int,
                 itemsize: int = 4) -> tuple[int, int]:
    """``(run, runs)``: each stream's ``seg = rows / D`` output rows are
    cut into runs of ``run`` rows (the last may be short): 8 rows,
    halved while the grid of streams × column tiles × runs has fewer
    than ``_MIN_BLOCKS_PER_SM`` blocks an SM, at most the segment, and
    long enough that the runs fit the grid.  A run opens by loading its
    first two tap rows again (the previous run's last two): ``run + 2``
    rows read for ``run`` written: a fifth of the reads at runs of 8 (x
    [16386, 16384]), a third at 4 (x [2050, 2048] in f32), half at 2
    (2050 in bf16).  The 50 MB L2 serves most of them: on an H100, with
    every output written to HBM, runs of 8 beat longer ones at 16386,
    and at 2050 the runs that give about 15 blocks an SM beat runs of 8
    by 3-4% (`tools/torch_kernel_ab.py`'s run table)."""
    seg = bp.rows // bp.d
    cells = bp.d * -(-bp.cols // (THREADS * vector(itemsize)))
    run = _RUN
    while run > 1 and cells * -(-seg // run) < _MIN_BLOCKS_PER_SM * sms:
        run //= 2
    run = min(max(run, -(-seg // _MAX_RUNS)), seg)
    return run, -(-seg // run)


def geometry(bp: BlockPlan, itemsize: int, sms: int,
             run: int | None = None) -> Geometry:
    """The launch for ``bp`` in a dtype of ``itemsize`` bytes: runs by
    :func:`stencil_runs`, or of ``run`` rows."""
    seg = bp.rows // bp.d
    if run is None:
        run, runs = stencil_runs(bp, sms, itemsize)
    else:
        run = min(run, seg)
        runs = -(-seg // run)
    v = vector(itemsize)
    return Geometry(vec=v, d=bp.d, tiles=-(-bp.cols // (THREADS * v)),
                    run=run, runs=runs)


def occupancy(dtype: torch.dtype, conv: bool) -> int:
    """Blocks of a stencil instance one SM keeps resident (the occupancy
    API on the current card)."""
    out = ctypes.c_int(0)
    fn = cuda.library("stencil").stencil_occupancy
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(cuda.dtype_code(dtype), int(conv), ctypes.byref(out))
    if err:
        raise RuntimeError(f"stencil occupancy: CUDA error {err}")
    return out.value


def _one_storage(scalars, device) -> torch.Tensor | None:
    """The scalars as one [n] view where they are 0-d tensors on
    ``device`` at consecutive elements of one storage (a contiguous
    weight tensor's elements in order), else None."""
    if not scalars or not all(isinstance(s, torch.Tensor) and s.dim() == 0
                              for s in scalars):
        return None
    s0 = scalars[0]
    isz = s0.element_size()
    base = s0.untyped_storage().data_ptr()
    for i, s in enumerate(scalars):
        if (s.dtype != s0.dtype or s.device != torch.device(device)
                or s.untyped_storage().data_ptr() != base
                or s.data_ptr() != s0.data_ptr() + i * isz):
            return None
    return s0.as_strided((len(scalars),), (1,))


def kernel_weights(scalars, device) -> torch.Tensor:
    """The nine weights as the conv3x3 kernel reads them, a [9] tensor on
    ``device`` in C3_NAMES order: where they are the elements of one
    contiguous f32, bf16 or f16 tensor in row-major order (what the op
    hands over for a contiguous [3, 3] weight), that storage itself,
    with no launch (the kernel widens each weight exactly, as the body
    does); else one stack and a cast to f32 on the card
    (``cuda.f32_scalars``).  No host copy of a tensor, so a call can be
    captured in a CUDA graph."""
    w9 = _one_storage(scalars, device)
    if w9 is not None and w9.dtype in cuda.DTYPES:
        return w9
    return cuda.f32_scalars(scalars, device)


def conv_weights(scalars, device) -> torch.Tensor:
    """The nine weights as one f32 [9] tensor on ``device``, in
    C3_NAMES order: :func:`kernel_weights` widened (no launch for an f32
    [3, 3]'s elements, one cast for another dtype's)."""
    return kernel_weights(scalars, device).float()


def launch(name: str, x: torch.Tensor, w9: torch.Tensor | None,
           bp: BlockPlan, g: Geometry) -> torch.Tensor:
    """Launch the ``name`` kernel (jacobi2d or conv3x3, with ``w9``, the
    nine weights of :func:`kernel_weights`) on the checked ``x [rows +
    2, cols + 2]`` with the geometry ``g``: ``o [rows, cols]``."""
    rows, cols = bp.rows, bp.cols
    o = torch.empty(rows, cols, dtype=x.dtype, device=x.device)
    code = cuda.dtype_code(x.dtype)
    if name == "jacobi2d":
        JACOBI(x.device, code, x.data_ptr(), o.data_ptr(), rows, cols, bp.d,
               g.run)
    else:
        CONV(x.device, code, x.data_ptr(), w9.data_ptr(),
             cuda.dtype_code(w9.dtype), o.data_ptr(), rows, cols, bp.d, g.run)
    return o


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
    if spec.name not in ("jacobi2d", "conv3x3"):
        raise NotImplementedError(f"{spec.name}: not a stencil instance")
    cuda.check_arrays(spec.name, [x], [(bp.rows + 2, bp.cols + 2)])
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    w9 = (kernel_weights(scalars, x.device) if spec.name == "conv3x3"
          else None)
    return launch(spec.name, x, w9, bp,
                  geometry(bp, x.element_size(), sms))
