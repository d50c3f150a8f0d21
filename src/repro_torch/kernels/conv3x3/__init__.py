"""3x3 correlation stencil (paper conv): spec, op, oracle; its
K1-instance CUDA kernel is ``kernels/stencil.py``
(``csrc/stencil.cu``).

The JAX package registers the op with the sizes below
(``src/repro/kernels/conv3x3/__init__.py``); the port has no registry
yet, so it keeps its own copy of them."""
from repro_torch.kernels.conv3x3.ops import conv3x3

__all__ = ["conv3x3"]

# h_out = h - 2 must be divisible by the conformance D points
_SIZES = {"h": 34, "w": 130}
_ALIASED = {"h": 34, "w": 128}   # pow-2 input row length → aliased streams
bench_sizes = {"h": 2050, "w": 2048}
