"""Fused BiCG kernel (paper Table 1, PolyBench bicg): specs, op and
oracle; its sweeps run the mxv family's K2 and K3 CUDA kernels."""
from repro_torch.kernels.bicg.ops import bicg

__all__ = ["bicg"]
