"""Oracle for fused RMSNorm."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm_ref", "rmsnorm_stats_ref"]


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    rms = torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf / rms) * w.float()).to(x.dtype)


def rmsnorm_stats_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """(normalized, inv_rms): the f32 inverse-rms row statistic."""
    xf = x.float()
    inv = 1.0 / torch.sqrt((xf * xf).mean(dim=-1) + eps)
    out = (xf * inv[..., None]) * w.float()
    return out.to(x.dtype), inv
