"""Fused RMSNorm (spec, op, oracle and its K1-instance CUDA kernel)."""
from repro_torch.kernels.rmsnorm.ops import rmsnorm

__all__ = ["rmsnorm"]
