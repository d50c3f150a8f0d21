"""Multi-strided flash-decode attention (spec, op, oracle and its
K3-instance CUDA kernels)."""
from repro_torch.kernels.decode_attn.ops import decode_attn

__all__ = ["decode_attn"]
