"""2D Jacobi 5-point stencil sweep (PolyBench jacobi-2d): spec, op,
oracle; its K1-instance CUDA kernel is ``kernels/stencil.py``
(``csrc/stencil.cu``).

The JAX package registers the op with the sizes below
(``src/repro/kernels/jacobi2d/__init__.py``); the port has no registry
yet, so it keeps its own copy of them."""
from repro_torch.kernels.jacobi2d.ops import jacobi2d

__all__ = ["jacobi2d"]

_SIZES = {"h": 34, "w": 130}
_ALIASED = {"h": 34, "w": 128}   # pow-2 input row length → aliased streams
bench_sizes = {"h": 2050, "w": 2048}
