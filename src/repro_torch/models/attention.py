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


class _ScoresF32(torch.autograd.Function):
    """q kᵀ in f32 from bf16 or f16 operands ``[N, S, dh]`` on the card:
    ``torch.bmm(..., out_dtype=torch.float32)`` (the products summed in
    f32 and never rounded to the operands' dtype), which has no gradient
    in torch.  The backward is JAX's transpose of its
    ``preferred_element_type=float32`` einsum: the f32 cotangent times
    the other operand in f32, narrowed to the operand's dtype."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return torch.bmm(q, k.transpose(1, 2), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        dq = dk = None
        if ctx.needs_input_grad[0]:
            dq = torch.bmm(g, k.float()).to(q.dtype)
        if ctx.needs_input_grad[1]:
            dk = torch.bmm(g.transpose(1, 2), q.float()).to(k.dtype)
        return dq, dk


def _scores_f32(qh: torch.Tensor, kh: torch.Tensor) -> torch.Tensor:
    """q kᵀ in f32 for q ``[..., Sq, dh]`` and k ``[..., Sk, dh]``, with
    the leading dims flattened: ``[N, Sq, Sk]``, a tensor of its own (no
    view), so the caller can scale and mask it in place without autograd
    copying it in the backward.  As the JAX package's einsum with
    ``preferred_element_type=float32``: products of the compute-dtype
    operands summed in f32, never rounded to the compute dtype.  On the
    card a bf16 or f16 pair goes through :class:`_ScoresF32`; elsewhere
    the operands are widened first (a bf16 or f16 value is exact in f32,
    so each product is exact and only the f32 sum rounds)."""
    sq, sk, dh = qh.shape[-2], kh.shape[-2], qh.shape[-1]
    q3, k3 = qh.reshape(-1, sq, dh), kh.reshape(-1, sk, dh)
    if q3.dtype != torch.float32 and q3.is_cuda:
        return _ScoresF32.apply(q3, k3)
    return torch.bmm(q3.float(), k3.float().transpose(1, 2))


def _sdpa_block(q, k, v, causal: bool, q_offset: int):
    """q: [B,Sq,Hq,dh]; k/v already expanded to [B,Sk,Hq,dh].

    The scores are f32 whatever the compute dtype (:func:`_scores_f32`).
    The second product sums in f32 and rounds once to the compute dtype,
    as in the JAX package."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))     # [B,H,S,dh]
    # scale and mask in place: neither saves its input for the backward,
    # and out of place each would be one more [B, H, Sq, Sk] f32 pass
    scores = _scores_f32(qh, kh)                             # [B·H,Sq,Sk]
    scores.div_(math.sqrt(dh))
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores.masked_fill_(~mask, _NEG)
    p = torch.softmax(scores, dim=-1).to(q.dtype).view(b, h, sq, sk)
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
