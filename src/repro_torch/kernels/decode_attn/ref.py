"""Oracle for GQA decode attention (one query token, long KV cache)."""
from __future__ import annotations

import torch

__all__ = ["decode_attn_ref", "decode_attn_lse_ref"]


def _scores(q, k, kv_len=None):
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / dh ** 0.5
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1)
        kv_len = kv_len.expand(b)
        mask = torch.arange(s, device=q.device)[None, :] < kv_len[:, None]
        scores = torch.where(mask[:, None, None, :], scores, -1e30)
    return scores


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len=None) -> torch.Tensor:
    """q: [B, Hq, dh]; k, v: [B, S, Hkv, dh]; returns [B, Hq, dh].

    Standard softmax attention with grouped KV heads, f32 accumulation.
    ``kv_len`` (scalar or [B]) masks positions >= kv_len.
    """
    b, hq, dh = q.shape
    p = torch.softmax(_scores(q, k, kv_len), dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(b, hq, dh).to(q.dtype)


def decode_attn_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len=None):
    """(out, lse): attention output plus the per-(batch, query-head)
    log-sum-exp of the scaled scores."""
    b, hq, dh = q.shape
    scores = _scores(q, k, kv_len)
    lse = torch.logsumexp(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd",
                       torch.exp(scores - lse[..., None]), v.float())
    return out.reshape(b, hq, dh).to(q.dtype), lse.reshape(b, hq)
