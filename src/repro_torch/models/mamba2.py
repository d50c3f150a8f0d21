"""Mamba-2 (SSD — state-space duality) block. arXiv:2405.21060.

The forward and prefill path is the chunked SSD algorithm (quadratic
within a chunk, the state passed from chunk to chunk); decode is the
O(1) recurrent update.  The block's layout is the JAX package's:

  in_proj → [z | xBC | dt];  xBC → causal depthwise conv →  [x | B | C]
  y = SSD(x·dt, A·dt, B, C) + D·x ;  out = out_proj(rmsnorm(y · silu(z)))

Plain PyTorch as the JAX package's is plain ``jnp`` (no Pallas kernel);
the gated norm is the K1 rmsnorm kernel, as every norm of the port.
``dt_bias``, ``a_log`` and ``d_skip`` are f32 whatever the weights'
dtype, as the JAX package creates and uses them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common

__all__ = ["Mamba", "init_mamba", "mamba_forward", "init_state",
           "mamba_decode", "chunk_size"]

F32_PARAMS = ("dt_bias", "a_log", "d_skip")


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return s, d, di, nh, conv_dim


class Mamba(nn.Module):
    """in_proj [D, 2·Di + 2·G·N + H], conv_w [K, C], conv_b [C],
    dt_bias / a_log / d_skip [H] (f32), norm [Di], out_proj [Di, D]."""

    def __init__(self, in_proj, conv_w, conv_b, dt_bias, a_log, d_skip,
                 norm, out_proj):
        super().__init__()
        for name, t in (("in_proj", in_proj), ("conv_w", conv_w),
                        ("conv_b", conv_b), ("dt_bias", dt_bias),
                        ("a_log", a_log), ("d_skip", d_skip),
                        ("norm", norm), ("out_proj", out_proj)):
            if name in F32_PARAMS:
                t = t.float()
            setattr(self, name, nn.Parameter(t, requires_grad=False))


def init_mamba(generator: torch.Generator, cfg: ModelConfig, dtype,
               device) -> Mamba:
    """The JAX package's distributions (not its numbers); ``dt_bias`` so
    that softplus(dt_bias) spans [dt_min, dt_max]."""
    s, d, di, nh, conv_dim = _dims(cfg)
    d_in_proj = 2 * di + 2 * s.n_groups * s.d_state + nh
    in_proj = common.dense_init(generator, (d, d_in_proj), dtype=dtype,
                                device=device)
    conv_w = torch.empty((s.d_conv, conv_dim), dtype=torch.float32,
                         device=device)
    conv_w.normal_(generator=generator)
    u = torch.empty((nh,), dtype=torch.float32, device=device)
    u.uniform_(0.0, 1.0, generator=generator)
    dt0 = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min))
                    + math.log(s.dt_min))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))         # inverse softplus
    out_proj = common.dense_init(generator, (di, d), dtype=dtype,
                                 device=device)
    return Mamba(in_proj, (conv_w * 0.1).to(dtype),
                 torch.zeros(conv_dim, dtype=dtype, device=device), dt_bias,
                 torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=device)),
                 torch.ones(nh, dtype=torch.float32, device=device),
                 torch.ones(di, dtype=dtype, device=device), out_proj)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, d, di, nh, conv_dim = _dims(cfg)
    return (zxbcdt[..., :di], zxbcdt[..., di:di + conv_dim],
            zxbcdt[..., di + conv_dim:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence, then silu.  xbc:
    [B, L, C]; w: [K, C]; the taps added in the JAX package's order."""
    k, l = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + l, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out + b[None, None, :])


def _ssd_chunked(x, dt, a, b, c, chunk: int):
    """Chunked SSD: one sequential walk over the chunks carrying the SSM
    state; each step does the intra-chunk quadratic part and the state
    update.

    x: [B, L, H, P]; dt: [B, L, H] (softplus'd, f32); a: [H] (negative);
    b, c: [B, L, G, N].  Returns (y [B, L, H, P] f32, final state
    [B, H, P, N] f32).  Every product is in f32: the JAX package's
    ``C·Bᵀ`` takes compute-dtype operands with f32 products
    (``preferred_element_type``), which widening first gives exactly."""
    bs, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = l // chunk
    rep = h // g
    xc = x.reshape(bs, nc, chunk, h, p).float()
    dtc = dt.reshape(bs, nc, chunk, h)
    bc = b.reshape(bs, nc, chunk, g, n).float()
    cc = c.reshape(bs, nc, chunk, g, n).float()
    qi = torch.arange(chunk, device=x.device)
    causal = (qi[:, None] >= qi[None, :])[None, :, :, None]
    hstate = torch.zeros((bs, h, p, n), dtype=torch.float32,
                         device=x.device)
    ys = []
    for ci in range(nc):
        xq, dtq, bq, cq = xc[:, ci], dtc[:, ci], bc[:, ci], cc[:, ci]
        cum = torch.cumsum(dtq * a[None, None, :], dim=1)      # [b,q,h]
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # [b,i,j,h]
        # masked before exp: above the diagonal seg > 0 overflows exp
        # at published widths, and the JAX package's where(causal,
        # exp(seg), 0) then has the masked gradient 0 * inf = NaN in
        # eager PyTorch (XLA folds it); the values are the same
        decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
        cbg = torch.einsum("bign,bjgn->bijg", cq, bq)
        cbh = torch.repeat_interleave(cbg, rep, dim=-1)        # [b,i,j,h]
        scores = cbh * decay * dtq[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", scores, xq)
        # off-diagonal: the carried state's contribution
        ch = torch.repeat_interleave(cq, rep, dim=2)           # [b,q,h,n]
        y = y + torch.einsum("bqhn,bhpn,bqh->bqhp", ch, hstate,
                             torch.exp(cum))
        # state update
        tail = torch.exp(cum[:, -1:, :] - cum) * dtq           # [b,q,h]
        bh = torch.repeat_interleave(bq, rep, dim=2)           # [b,q,h,n]
        st = torch.einsum("bqh,bqhn,bqhp->bhpn", tail, bh, xq)
        hstate = hstate * torch.exp(cum[:, -1, :])[..., None, None] + st
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(bs, l, h, p), hstate


def chunk_size(cfg: ModelConfig, l: int) -> int:
    """The JAX package's chunk rule: ``min(chunk, L)``, and where L is not
    a multiple of it, ``gcd(L, chunk)`` (so an odd L runs chunks of 1:
    L sequential steps a layer)."""
    chunk = min(cfg.ssm.chunk, l)
    if l % chunk:
        chunk = 1 if l == 1 else math.gcd(l, chunk)
    return chunk


def mamba_forward(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False, mode: Optional[str] = None):
    """Forward / prefill path. x: [B, L, D] → [B, L, D], and with
    ``return_state`` the decode state ``{"conv", "ssm"}`` after it: the
    last ``d_conv - 1`` pre-activation conv inputs (zeros on the left
    for a prompt shorter than the window) and the final SSM state."""
    s, d, di, nh, conv_dim = _dims(cfg)
    bsz, l, _ = x.shape
    zxbcdt = x @ p.in_proj.to(x.dtype)
    z, xbc_pre, dt_raw = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc_pre, p.conv_w.to(x.dtype), p.conv_b.to(x.dtype))
    gn = s.n_groups * s.d_state
    xs = xbc[..., :di].reshape(bsz, l, nh, s.head_dim)
    b = xbc[..., di:di + gn].reshape(bsz, l, s.n_groups, s.d_state)
    c = xbc[..., di + gn:].reshape(bsz, l, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p.dt_bias[None, None, :])
    a = -torch.exp(p.a_log)
    y, h_final = _ssd_chunked(xs, dt, a, b, c, chunk_size(cfg, l))
    y = y + p.d_skip[None, None, :, None] * xs.float()
    y = y.reshape(bsz, l, di).to(x.dtype)
    y = y * F.silu(z)
    y = common.rms_norm(y, p.norm, cfg.norm_eps, mode)
    out = y @ p.out_proj.to(x.dtype)
    if not return_state:
        return out
    k = s.d_conv - 1
    pad = torch.zeros((bsz, max(k - l, 0), conv_dim), dtype=x.dtype,
                      device=x.device)
    window = torch.cat([pad, xbc_pre[:, max(l - k, 0):]], dim=1)
    return out, {"conv": window, "ssm": h_final}


def init_state(cfg: ModelConfig, batch: int, dtype,
               device) -> dict[str, torch.Tensor]:
    s, d, di, nh, conv_dim = _dims(cfg)
    return {"conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state),
                               dtype=torch.float32, device=device)}


def mamba_decode(p: Mamba, x: torch.Tensor, cfg: ModelConfig, state,
                 mode: Optional[str] = None):
    """One-token recurrent update. x: [B, 1, D] → ([B, 1, D], the new
    state): the conv window rolled by one input, the SSM state advanced
    one step.  The state given is not changed."""
    s, d, di, nh, conv_dim = _dims(cfg)
    bsz = x.shape[0]
    zxbcdt = x[:, 0] @ p.in_proj.to(x.dtype)                  # [B, *]
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    window = torch.cat([state["conv"], xbc[:, None, :]], dim=1)
    conv_out = ((window * p.conv_w.to(x.dtype)[None]).sum(dim=1)
                + p.conv_b.to(x.dtype))
    xbc = F.silu(conv_out)
    gn = s.n_groups * s.d_state
    xs = xbc[..., :di].reshape(bsz, nh, s.head_dim)
    b = xbc[..., di:di + gn].reshape(bsz, s.n_groups, s.d_state)
    c = xbc[..., di + gn:].reshape(bsz, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p.dt_bias[None, :])
    a = -torch.exp(p.a_log)
    da = torch.exp(dt * a[None, :])                           # [B, H]
    rep = nh // s.n_groups
    bh = torch.repeat_interleave(b, rep, dim=1).float()       # [B, H, N]
    ch = torch.repeat_interleave(c, rep, dim=1).float()
    h_new = (state["ssm"] * da[..., None, None]
             + dt[..., None, None] * xs.float()[..., None]
             * bh[:, :, None, :])
    y = (h_new * ch[:, :, None, :]).sum(-1)                   # [B, H, P]
    y = y + p.d_skip[None, :, None] * xs.float()
    y = y.reshape(bsz, di).to(x.dtype) * F.silu(z)
    y = common.rms_norm(y, p.norm, cfg.norm_eps, mode)
    out = (y @ p.out_proj.to(x.dtype))[:, None, :]
    return out, {"conv": window[:, 1:], "ssm": h_new}
