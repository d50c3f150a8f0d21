"""doitgen (PolyBench: MADNESS multi-resolution analysis): spec, op,
oracle and its K1-instance CUDA kernel (``kernel.py``,
``csrc/doitgen.cu``).

The JAX package registers the op with the sizes below
(``src/repro/kernels/doitgen/__init__.py``); the port has no registry
yet, so it keeps its own copy of them."""
from repro_torch.kernels.doitgen.ops import doitgen

__all__ = ["doitgen"]

_SIZES = {"r": 4, "q": 8, "s": 32}
# m = r*q = 128 rows of 32 f32 → (128/4)*32*4 B = 4 KiB spacing (§4.5)
_ALIASED = {"r": 8, "q": 16, "s": 32}
bench_sizes = {"r": 16, "q": 256, "s": 256}
