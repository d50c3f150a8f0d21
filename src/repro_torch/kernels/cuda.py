"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Every source has a plain C interface.  At first use it is compiled by
``nvcc`` for ``sm_90a`` into one shared library per source under
``build/repro_torch/`` at the repository root (the name carries a hash
of the source, so an edited source rebuilds), and loaded with
``ctypes``.  :func:`build` compiles several sources at once, one
``nvcc`` process each, all started together.  Nothing is built when a
module is imported.

A :class:`CudaKernel` is one ``extern "C"`` launcher: it launches on
PyTorch's current stream, raises if the launcher returns a non-zero
``cudaGetLastError()``, and counts its launches in ``launches`` — a
plain integer a caller may reset to 0 before a run it wants to audit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Optional, Sequence

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "KERNELS", "CudaKernel",
           "build", "library", "DTYPES", "dtype_code", "check_arrays",
           "check_operands", "sweep_geometry", "f32_scalars"]

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
    """:func:`check_arrays`, and what the row-sweep kernels (K1, K2, K3
    over ``[rows, cols]`` operands, 16-byte vector loads) refuse besides:
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


def sweep_geometry(bp, config) -> tuple[int, int, int, int, int, int]:
    """The launch geometry of a D-stream row sweep (``csrc/common.cuh``
    ``row_sweep``) from a BlockPlan and its config: ``(rows, cols, d, bm,
    sub-portions per column step, interleaved)``."""
    interleaved = config is not None and config.arrangement == "interleaved"
    return (bp.rows, bp.cols, bp.d, bp.bm, max(1, bp.bn // _SUB),
            int(interleaved))


def _nvcc() -> str:
    path = shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    if not Path(path).exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return path


def _lib_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in (source, *sorted(CSRC.glob("*.cuh"))):   # shared headers
        h.update(part.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def build(stems: Optional[Iterable[str]] = None) -> dict[str, str]:
    """Compile ``csrc/<stem>.cu`` for every stem (default: all sources)
    whose library is missing, one ``nvcc`` per source, all at once.

    Returns ``{stem: compiler report}`` (``-Xptxas -v`` register,
    shared-memory and spill lines) for the sources built now; raises
    ``RuntimeError`` with the compiler's output if any build fails."""
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
        raise RuntimeError("\n".join(failures))
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
            raise RuntimeError(f"{self.name}: launch failed with CUDA "
                               f"error {err} ({msg})")
        self.launches += 1
