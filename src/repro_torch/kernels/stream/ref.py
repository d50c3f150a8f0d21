"""Plain PyTorch oracles for the stream micro-kernels (paper §4)."""
from __future__ import annotations

import torch

__all__ = ["read_ref", "copy_ref", "init_ref"]


def read_ref(x: torch.Tensor, d: int) -> torch.Tensor:
    """Per-stream checksums: x viewed as [rows, cols], streams = d equal
    row segments.  Returns [d] sums (f32 accumulation)."""
    seg = x.shape[0] // d
    return x.float().reshape(d, seg * x.shape[1]).sum(dim=1)


def copy_ref(x: torch.Tensor) -> torch.Tensor:
    return x


def init_ref(shape: tuple[int, int], value, dtype,
             device="cpu") -> torch.Tensor:
    return torch.full(tuple(shape), value, dtype=dtype, device=device)
