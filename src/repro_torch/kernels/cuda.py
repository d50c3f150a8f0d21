"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Every source has a plain C interface.  At first use it is compiled by
``nvcc`` for ``sm_90a`` into one shared library per source under
``build/repro_torch/`` at the repository root (the name carries a hash
of the source, so an edited source rebuilds), and loaded with
``ctypes``.  :func:`build` compiles several sources at once, one
``nvcc`` process each, all started together.  Nothing is built when a
module is imported.

:class:`WalkGeometry` is the host side of ``csrc/common.cuh``'s flat
walk, which the K1 elementwise kernels share (``gemver_sum``, stream
copy / triad / init, adamw), and :func:`walk_units` mirrors its index
arithmetic.

A :class:`CudaKernel` is one ``extern "C"`` launcher: it launches on
PyTorch's current stream, raises :class:`LaunchError` (with the CUDA
error code) if the launcher returns a non-zero ``cudaGetLastError()``,
and counts its launches in ``launches`` — a plain integer a caller may
reset to 0 before a run it wants to audit.  A source that does not
build raises :class:`BuildError`; both are ``RuntimeError`` subclasses.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Iterator, Optional, Sequence

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "KERNELS", "CudaKernel",
           "BuildError", "LaunchError", "STICKY_ERRORS",
           "build", "library", "source_hash", "DTYPES", "dtype_code",
           "check_arrays",
           "check_operands", "f32_scalars", "WALK_UNIT", "WALK_HELD",
           "WalkGeometry", "walk_geometry", "plan_walk", "walk_units"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every CudaKernel by name (the launch counts a run can audit)
KERNELS: dict[str, "CudaKernel"] = {}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the element types every launcher is compiled for
DTYPES = tuple(_DTYPE_CODES)
# elements of a sub-portion, a warp's row unit (csrc/common.cuh SUB)
_SUB = 128
WALK_UNIT = 128     # threads of a walk block, 16-byte vectors of a unit
WALK_HELD = 4       # units a thread holds at once (csrc/common.cuh)


class BuildError(RuntimeError):
    """A kernel source that does not build (``nvcc`` or ``ptxas``), or no
    ``nvcc`` at all: no config of any kernel of that source can run."""


class LaunchError(RuntimeError):
    """A launcher returned a CUDA error; ``code`` is its ``cudaError_t``."""

    def __init__(self, message: str, code: int):
        super().__init__(message)
        self.code = code


# cudaError_t codes after which the context is unusable: every later
# call in the process returns the same error
STICKY_ERRORS = frozenset({
    700,    # cudaErrorIllegalAddress
    710,    # cudaErrorAssert
    714,    # cudaErrorHardwareStackError
    715,    # cudaErrorIllegalInstruction
    716,    # cudaErrorMisalignedAddress
    717,    # cudaErrorInvalidAddressSpace
    718,    # cudaErrorInvalidPc
    719,    # cudaErrorLaunchFailure
})


def dtype_code(dtype: torch.dtype) -> int:
    """The element-type code the C launchers switch on."""
    return _DTYPE_CODES[dtype]


def check_arrays(name: str, arrays: Sequence[torch.Tensor],
                 shapes: Sequence[tuple]) -> None:
    """Refuse what no launcher takes: a dtype with no compiled instance
    or mixed dtypes (``TypeError``); an operand of another shape than
    ``shapes`` gives, or one that is not contiguous and on the first
    operand's device (``ValueError``).  Any row width and any element
    alignment pass: the launchers that call only this (the stencils,
    doitgen) load element by element."""
    a = arrays[0]
    if a.dtype not in DTYPES:
        raise TypeError(f"{name} kernel: unsupported dtype {a.dtype}")
    for t, shape in zip(arrays, shapes):
        if t.dtype != a.dtype:
            raise TypeError(f"{name} kernel: operands must all be "
                            f"{a.dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} kernel: operand must be {tuple(shape)},"
                             f" got {tuple(t.shape)}")
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"{name} kernel: operands must be contiguous "
                             "and on one device")


def check_operands(name: str, arrays: Sequence[torch.Tensor],
                   shapes: Sequence[tuple]) -> None:
    """:func:`check_arrays`, and what the row kernels (K1, K2, K3 over
    ``[rows, cols]`` operands, 16-byte vector loads) refuse besides:
    a row of other than whole 128-element sub-portions, or an operand
    that is not 16-byte aligned (``ValueError``)."""
    check_arrays(name, arrays, shapes)
    if arrays[0].shape[-1] % _SUB:
        raise ValueError(f"{name} kernel: {arrays[0].shape[-1]} columns are "
                         f"not whole {_SUB}-element sub-portions")
    if any(t.data_ptr() % 16 for t in arrays):
        raise ValueError(f"{name} kernel: operands must be contiguous, "
                         "16-byte aligned and on one device")


def f32_scalars(scalars, device) -> torch.Tensor:
    """A spec's scalars as one f32 vector on ``device``, in order: a
    scalar widens to f32 as the spec bodies widen it.  0-d tensors (what
    the ops pass) take one stack on their device and, unless already
    f32, one cast: no host copy, so a call can be captured in a CUDA
    graph.  Python numbers are copied from the host."""
    if all(isinstance(w, torch.Tensor) for w in scalars):
        return torch.stack(list(scalars)).to(device=device,
                                             dtype=torch.float32)
    return torch.tensor([float(w) for w in scalars], dtype=torch.float32,
                        device=device)


@dataclasses.dataclass(frozen=True)
class WalkGeometry:
    """One launch of ``csrc/common.cuh``'s flat walk: ``d`` segments of
    ``segv`` 16-byte vectors of ``vec`` elements, cut into ``steps``
    steps of ``units`` (P) units of :data:`WALK_UNIT` vectors (the last
    step may be short); ``d`` blocks of :data:`WALK_UNIT` threads a step,
    P units a block, a thread its vector of each unit, taken in
    ``passes`` of up to ``held`` units whose loads are all issued before
    any is used."""

    vec: int
    segv: int
    d: int
    units: int
    steps: int
    held: int = WALK_HELD

    @property
    def threads(self) -> int:
        return WALK_UNIT

    @property
    def passes(self) -> int:
        return -(-self.units // self.held)

    @property
    def blocks(self) -> int:
        return self.d * self.steps


def walk_geometry(segv: int, d: int, units: int, itemsize: int,
                  held: int = WALK_HELD) -> WalkGeometry:
    """The walk over ``d`` segments of ``segv`` 16-byte vectors of a type
    of ``itemsize`` bytes, ``units`` units a block a step."""
    units = max(1, units)
    return WalkGeometry(vec=16 // itemsize, segv=segv, d=d, units=units,
                        steps=-(-segv // (units * WALK_UNIT)), held=held)


def plan_walk(bp, itemsize: int) -> WalkGeometry:
    """The walk of a K1 elementwise kernel over the (padded) ``[rows,
    cols]`` arrays of a BlockPlan (``gemver_sum``'s tiles, the stream
    arrays): each of the D segments holds ``rows / D · cols`` elements,
    whole 16-byte vectors (``cols`` is whole 128-element sub-portions),
    P = ``bn / 128`` units a block a step.  ``bm`` does not enter: the
    walk has no row slots."""
    return walk_geometry(bp.rows // bp.d * bp.cols * itemsize // 16, bp.d,
                         bp.bn // _SUB, itemsize)


def walk_units(g: WalkGeometry, interleaved: bool,
               ) -> Iterator[tuple[int, int, int, int, int]]:
    """The flat walk's index arithmetic, as ``flat_walk`` computes it:
    for each step ``c``, each of its blocks ``j`` and each of the block's
    units ``s`` in order, ``(c, j, k, first, live)``: the unit lies in
    segment ``k`` (grouped: ``k = j``; interleaved: unit ``j·P + s`` of
    the step goes to stream ``(j·P + s) mod D``), thread ``t`` takes the
    flat vector ``first + t`` for ``t < live`` (the rest lie past the
    segment and are masked)."""
    np_ = g.units
    for c in range(g.steps):
        for j in range(g.d):
            for s in range(np_):
                item = j * np_ + s
                k = item % g.d if interleaved else j
                p = item // g.d if interleaved else s
                v0 = (c * np_ + p) * WALK_UNIT
                yield (c, j, k, k * g.segv + v0,
                       max(0, min(WALK_UNIT, g.segv - v0)))


def _nvcc() -> str:
    path = shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    if not Path(path).exists():
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                         "PATH); the CUDA kernels cannot be built")
    return path


@functools.lru_cache(maxsize=None)
def source_hash(stem: str) -> str:
    """12 hex digits of the SHA-256 of ``csrc/<stem>.cu``, the shared
    headers and the compiler flags: the tag of its library's name, and
    the provenance the tune cache checks an entry's freshness by."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in (CSRC / f"{stem}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(part.read_bytes())
    return h.hexdigest()[:12]


def _lib_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{source.stem}-{source_hash(source.stem)}.so"


def build(stems: Optional[Iterable[str]] = None) -> dict[str, str]:
    """Compile ``csrc/<stem>.cu`` for every stem (default: all sources)
    whose library is missing, one ``nvcc`` per source, all at once.

    Returns ``{stem: compiler report}`` (``-Xptxas -v`` register,
    shared-memory and spill lines) for the sources built now; raises
    :class:`BuildError` with the compiler's output if any build fails."""
    sources = ([CSRC / f"{s}.cu" for s in stems] if stems is not None
               else sorted(CSRC.glob("*.cu")))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        lib = _lib_path(src)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs.append((src, lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failures = {}, []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {src.name} "
                            f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)
        reports[src.stem] = out
    if failures:
        raise BuildError("\n".join(failures))
    return reports


_LIBS: dict[str, ctypes.CDLL] = {}


def library(stem: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<stem>.cu`` (built if
    missing)."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = _lib_path(CSRC / f"{stem}.cu")
        if not path.exists():
            build([stem])
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[stem] = lib
    return lib


class CudaKernel:
    """One ``extern "C"`` launcher of a CUDA source, with a launch count.

    ``argtypes`` lists the launcher's arguments before the trailing
    stream pointer; the launcher returns ``cudaGetLastError()``."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        if name in KERNELS:
            raise ValueError(f"duplicate CUDA kernel name {name!r}")
        self.name, self.source, self.symbol = name, source, symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def _launcher(self):
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, device: torch.device, *args) -> None:
        fn = self._launcher()
        if device.index is not None and device.index != torch.cuda.current_device():
            with torch.cuda.device(device):
                err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        else:
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            msg = library(self.source).repro_cuda_error_string(err).decode()
            raise LaunchError(f"{self.name}: launch failed with CUDA "
                              f"error {err} ({msg})", err)
        self.launches += 1
