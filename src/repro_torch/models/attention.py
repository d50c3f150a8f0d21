"""GQA attention: train (full causal attention over the sequence, plain
PyTorch as the JAX package leaves it to XLA) and decode (one token
against the KV cache through the multi-strided flash-decode kernel).

Weights layout: wq [D, Hq*dh], wk [D, Hkv*dh], wv [D, Hkv*dh],
wo [Hq*dh, D].
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attn import ops as da_ops
from repro_torch.models import common

_NEG = -1e30


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


def _sdpa_block(q, k, v, causal: bool, q_offset: int):
    """q: [B,Sq,Hq,dh]; k/v already expanded to [B,Sk,Hq,dh].

    The JAX package takes the scores of its bf16 einsum in f32
    (``preferred_element_type``); a bf16 ``torch.matmul`` rounds them to
    bf16 once before they widen to f32 here.  In f32 the two are the
    same.  The second product sums in f32 and rounds once to the compute
    dtype in both."""
    dh = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))     # [B,H,S,dh]
    # scale and mask in place: neither saves its input for the backward,
    # and out of place each would be one more [B, H, Sq, Sk] f32 pass
    scores = torch.matmul(qh, kh.transpose(-1, -2)).float()
    scores.div_(math.sqrt(dh))
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores.masked_fill_(~mask, _NEG)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(p, vh).transpose(1, 2)               # [B,Sq,H,dh]


def _pick_q_chunk(b, hq, sq, sk, budget=2 ** 33):
    """Largest q-chunk keeping the score tensor under budget elements;
    must divide sq."""
    qc = max(int(budget // max(b * hq * sk, 1)), 128)
    qc = min(qc, sq)
    while sq % qc:
        qc -= 1
    return qc


def _sdpa(q, k, v, causal: bool, q_offset: int = 0):
    """Memory-efficient exact attention: KV expanded to query heads, the
    query axis processed in chunks under activation checkpointing
    (scores never exceed ~budget elements), as the JAX package's scan of
    checkpointed chunks."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    if hkv != hq:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
    sk = k.shape[1]
    qc = _pick_q_chunk(b, hq, sq, sk)
    if qc >= sq:
        return _sdpa_block(q, k, v, causal, q_offset)
    outs = [checkpoint(_sdpa_block, q[:, i * qc:(i + 1) * qc], k, v,
                       causal, q_offset + i * qc, use_reentrant=False)
            for i in range(sq // qc)]
    return torch.cat(outs, dim=1)


def attn_forward(p: Attention, x: torch.Tensor, cfg: ModelConfig, rope,
                 causal: bool = True):
    """Train/prefill full attention. Returns (out, (k, v))."""
    q, k, v = _qkv(p, x, cfg, rope)
    out = _sdpa(q, k, v, causal)
    b, s, _ = x.shape
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return out @ p.wo.to(x.dtype), (k, v)


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
