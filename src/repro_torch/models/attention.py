"""GQA attention, decode path: one token against the KV cache through
the multi-strided flash-decode kernel.

Weights layout: wq [D, Hq*dh], wk [D, Hkv*dh], wv [D, Hkv*dh],
wo [Hq*dh, D].
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attn import ops as da_ops
from repro_torch.models import common


class Attention(nn.Module):
    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq = nn.Parameter(wq, requires_grad=False)
        self.wk = nn.Parameter(wk, requires_grad=False)
        self.wv = nn.Parameter(wv, requires_grad=False)
        self.wo = nn.Parameter(wo, requires_grad=False)


def init_attn(generator: torch.Generator, cfg: ModelConfig, dtype,
              device) -> Attention:
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    return Attention(*(common.dense_init(generator, shape, dtype=dtype,
                                         device=device)
                       for shape in ((d, hq * dh), (d, hkv * dh),
                                     (d, hkv * dh), (hq * dh, d))))


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig, rope):
    b, s, _ = x.shape
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p.wq.to(x.dtype)).reshape(b, s, hq, dh)
    k = (x @ p.wk.to(x.dtype)).reshape(b, s, hkv, dh)
    v = (x @ p.wv.to(x.dtype)).reshape(b, s, hkv, dh)
    q = common.apply_rope(q, rope, cfg.rope_style).to(x.dtype)
    k = common.apply_rope(k, rope, cfg.rope_style).to(x.dtype)
    return q, k, v


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device) -> dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig, cache,
                pos: torch.Tensor, rope, mode: Optional[str] = None):
    """One-token decode: write the cache at `pos`, then flash-decode.

    x: [B, 1, D]; pos: a scalar (current length) or a per-row [B] vector
    (ragged continuous batching — each row writes its own cache position
    and attends to its own ``kv_len = pos + 1``).  The cache is updated
    IN PLACE with one index per row, where the JAX package returns an
    updated copy (a vmapped ``dynamic_update_slice``).
    """
    q, k, v = _qkv(p, x, cfg, rope)
    kc, vc = cache["k"], cache["v"]
    if pos.ndim:
        rows = torch.arange(x.shape[0], device=x.device)
        kc[rows, pos] = k[:, 0].to(kc.dtype)
        vc[rows, pos] = v[:, 0].to(vc.dtype)
    else:
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
    out = da_ops.decode_attn(q[:, 0], kc, vc, kv_len=pos + 1, mode=mode)
    b = x.shape[0]
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return out @ p.wo.to(x.dtype), cache
