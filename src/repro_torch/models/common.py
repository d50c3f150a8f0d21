"""Shared model components: initializers, the norm (with its gradient),
RoPE, the loss."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops


def _truncated_normal(shape, generator: torch.Generator, device,
                      lo: float = -2.0, hi: float = 2.0) -> torch.Tensor:
    """Standard normal truncated to [lo, hi], by inverse CDF (the same
    distribution as ``jax.random.truncated_normal``; not the same draws)."""
    a, b = math.erf(lo / math.sqrt(2.0)), math.erf(hi / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(a, b, generator=generator)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(lo, hi)


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-ish, standard for LMs)."""
    std = 1.0 / math.sqrt(shape[in_axis])
    return (_truncated_normal(shape, generator, device) * std).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    x = torch.empty((vocab, d), dtype=torch.float32, device=device)
    x.normal_(generator=generator)
    return (x * (1.0 / math.sqrt(d))).to(dtype)


class _RMSNorm(torch.autograd.Function):
    """rmsnorm with a gradient.  Forward is the K1 kernel (its plain
    version on the CPU or with ``mode="ref"``), which also returns the f32
    inverse rms of each row; backward is the closed form in f32 from the
    saved x, w and inverse rms, cast back to their dtypes.  The JAX
    package has no backward kernel (XLA differentiates its reference),
    so this one is plain PyTorch too."""

    @staticmethod
    def forward(ctx, x, w, eps, mode):
        out, inv = rmsnorm_ops.rmsnorm(x, w, eps=eps, mode=mode,
                                       with_inv_rms=True)
        ctx.save_for_backward(x, w, inv)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, inv = ctx.saved_tensors
        inv = inv.unsqueeze(-1)
        xhat = x.float() * inv
        g = dy.float() * w.float()
        # d/dx of x * inv(x) * w, inv = (mean(x^2) + eps)^-1/2
        dx = inv * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
        dw = (dy.float() * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             mode: Optional[str] = None) -> torch.Tensor:
    """The multi-strided rmsnorm kernel on the card; its plain version on
    the CPU or with ``mode="ref"``.  Differentiable in x and scale."""
    return _RMSNorm.apply(x, scale.to(x.dtype), eps, mode)


def make_rope(positions: torch.Tensor, head_dim: int, theta: float,
              style: str) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
    """Rotary embedding tables for given positions [*(B,) S].

    style 'full': rotate all head dims (llama). 'half': rotate only the
    first half of the head dims (ChatGLM's 2D-RoPE layout). 'none': None.
    """
    if style == "none":
        return None
    rot = head_dim if style == "full" else head_dim // 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), -exps)
    ang = positions[..., None].float() * freqs            # [..., rot/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, rope, style: str) -> torch.Tensor:
    """x: [B, S, H, dh]; rope cos/sin: [B?, S, rot/2] or [S, rot/2].

    Rotates INTERLEAVED pairs (dims 0::2 with 1::2), as the JAX package
    does — not the rotate-half layout of other implementations."""
    if rope is None or style == "none":
        return x
    cos, sin = rope
    while cos.ndim < x.ndim - 1:  # broadcast over batch/head dims
        cos, sin = cos[None], sin[None]
    cos, sin = cos[..., None, :], sin[..., None, :]  # add head axis
    dh = x.shape[-1]
    rot = dh if style == "full" else dh // 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp.to(yr.dtype)], dim=-1) if rot != dh else yr


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token NLL with optional z-loss, f32 stable."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp(min=1)
    return nll.mean()
