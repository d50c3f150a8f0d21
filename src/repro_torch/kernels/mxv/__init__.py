"""Matrix-vector kernels (paper mxv / Listing 1 mxv_t): specs, ops,
oracles and the K2 row-dot and K3 column-dot CUDA kernels."""
from repro_torch.kernels.mxv.ops import mxv, mxv_t

__all__ = ["mxv", "mxv_t"]
