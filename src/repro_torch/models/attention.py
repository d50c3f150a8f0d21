"""GQA attention: train (full causal attention over the sequence, plain
PyTorch as the JAX package leaves it to XLA), decode (one token against
the KV cache through the multi-strided flash-decode kernel), and
Whisper's cross-attention against the encoder's K/V (plain, in every
path, as the JAX package's).

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
from repro_torch.kernels.decode_attn import sharded as da_sharded
from repro_torch.models import common
from repro_torch.roofline.hw import H100_HW

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


def _kv_weights(p: Attention, cfg: ModelConfig, ctx):
    """(wk, wv, heads): the K and V weights this rank projects with, and
    for each of its query heads the index of its KV head among theirs
    (None: the stock ``repeat_interleave``).  In a tensor-parallel
    forward wq holds this rank's Hq / tp query heads; where the rules cut
    wk and wv too (``n_kv_heads % tp == 0``) they hold exactly those
    heads' KV heads, and where the rules leave them whole, this rank
    projects only the KV heads its query heads read (query head j reads
    KV head j // (Hq / Hkv), as ``repeat_interleave`` pairs them)."""
    if not common.tensor_parallel(ctx) or cfg.n_kv_heads % ctx.tp == 0:
        return p.wk, p.wv, None
    dh, g = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    hl = cfg.n_heads // ctx.tp
    mine = [(ctx.tp_rank * hl + i) // g for i in range(hl)]
    lo, hi = mine[0], mine[-1] + 1
    cols = slice(lo * dh, hi * dh)
    return p.wk[:, cols], p.wv[:, cols], [h - lo for h in mine]


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig, rope, ctx=None,
         dtype=None):
    """q [B, S, Hq, dh], k and v [B, S, Hkv, dh] of x, in ``dtype``
    (default x's: the f32 rows of ``common.tp_enter`` narrowed by
    ``common.entry_mm``); in a tensor-parallel forward this rank's heads
    (:func:`_kv_weights`)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    dt = dtype or x.dtype
    wk, wv, heads = _kv_weights(p, cfg, ctx)
    q = common.entry_mm(x, p.wq, dt).reshape(b, s, -1, dh)
    k = common.entry_mm(x, wk, dt).reshape(b, s, -1, dh)
    v = common.entry_mm(x, wv, dt).reshape(b, s, -1, dh)
    if heads is not None:
        idx = torch.tensor(heads, device=x.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    q = common.apply_rope(q, rope, cfg.rope_style).to(dt)
    k = common.apply_rope(k, rope, cfg.rope_style).to(dt)
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


# One q-chunk's f32 scores may take an eighth of the card's memory: the
# chunk also holds softmax's f32 output and its compute-dtype copy (2.5x
# the scores in all), beside the weights and the KV cache.  The JAX
# package's budget, 2**33 elements over a whole TPU mesh, is 34 GB of
# scores on one card.
SCORE_BUDGET_BYTES = H100_HW.hbm_bytes // 8


def _pick_q_chunk(b, hq, sq, sk):
    """Largest q-chunk keeping the f32 score tensor ``[b, hq, qc, sk]``
    under ``SCORE_BUDGET_BYTES``; must divide sq."""
    qc = max(int(SCORE_BUDGET_BYTES // max(4 * b * hq * sk, 1)), 128)
    qc = min(qc, sq)
    while sq % qc:
        qc -= 1
    return qc


def _sdpa(q, k, v, causal: bool, q_offset: int = 0):
    """Memory-efficient exact attention: KV expanded to query heads, the
    query axis processed in chunks under activation checkpointing
    (scores never exceed ~``SCORE_BUDGET_BYTES``), as the JAX package's
    scan of checkpointed chunks."""
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
                 causal: bool = True, ctx=None, dtype=None):
    """Train/prefill full attention. Returns (out, (k, v)).

    In a tensor-parallel forward (``ctx``, x the whole sequence from
    ``common.tp_enter``) wq, wk and wv are column-parallel (this rank's
    heads) and wo row-parallel: out is this rank's partial sum
    (``common.row_parallel``: f32 for 16-bit operands), which
    ``common.tp_exit`` reduces.  (A head count the model axis does not
    divide is the JAX package's sequence-sharded attention, which
    ``train.zero.layout`` refuses.)  ``dtype``: the products' (default
    x's)."""
    q, k, v = _qkv(p, x, cfg, rope, ctx, dtype)
    out = _sdpa(q, k, v, causal)
    b, s, _ = x.shape
    out = out.reshape(b, s, -1)
    return common.row_parallel(out, p.wo.to(q.dtype), ctx), (k, v)


def attn_seqshard(p: Attention, h: torch.Tensor, cfg: ModelConfig, rope,
                  causal: bool, ctx) -> torch.Tensor:
    """The JAX package's sequence-sharded attention (``_sdpa_seqshard``),
    for a head count the model axis does not divide on a sequence the
    layer boundaries shard: h is this rank's S / tp rows [B, S / tp, D]
    and wq, wk, wv, wo are whole.  The rank projects q for its own rows
    and K/V for the whole sequence (h all-gathered by ``common.tp_enter``,
    whose backward sums the ranks' parts of its gradient), attends with
    the causal offset ``rank · S / tp`` in q chunks of
    :func:`_pick_q_chunk` and runs wo on its rows: the output is the
    boundary's rows, with no reduction.  Each rank's gradients of the
    four weights are its rows' parts, summed over ``model`` in the
    backward (``common.model_summed``)."""
    b, sl, _ = h.shape
    dh = cfg.head_dim
    lo = ctx.tp_rank * sl
    whole = common.tp_enter(h, ctx)
    s = whole.shape[1]
    q = common.model_summed(h, p.wq, ctx).reshape(b, sl, -1, dh)
    k = common.model_summed(whole, p.wk, ctx, h.dtype).reshape(b, s, -1, dh)
    v = common.model_summed(whole, p.wv, ctx, h.dtype).reshape(b, s, -1, dh)
    rope_q = None if rope is None else tuple(t[lo:lo + sl] for t in rope)
    q = common.apply_rope(q, rope_q, cfg.rope_style).to(h.dtype)
    k = common.apply_rope(k, rope, cfg.rope_style).to(h.dtype)
    out = _sdpa(q, k, v, causal, q_offset=lo)
    return common.model_summed(out.reshape(b, sl, -1), p.wo, ctx)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device, ctx=None) -> dict[str, torch.Tensor]:
    """``{"k", "v"}`` [B, max_len, Hkv, dh] zeros; with a ctx whose model
    axis has K > 1 ranks, only this rank's [B, max_len / K, Hkv, dh]
    slice of the sequence (``kernels.decode_attn.sharded``)."""
    n = ctx.tp if ctx is not None else 1
    if max_len % n:
        raise ValueError(f"max_len {max_len} not divisible by the {n} "
                         "ranks of the model axis")
    shape = (batch, max_len // n, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_local(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 lo: int) -> None:
    """Write row ``new[b]`` [B, Hkv, dh] at global position ``pos[b]``
    into a rank's slice ``c`` [B, S/K, Hkv, dh] holding positions
    [lo, lo + S/K), for the rows whose position falls there; the other
    rows write back what they read at a clamped position.  On the
    device, with no host sync."""
    sp = c.shape[1]
    rows = torch.arange(c.shape[0], device=c.device)
    local = pos.expand(c.shape[0]) - lo
    idx = local.clamp(0, sp - 1)
    mine = ((local >= 0) & (local < sp))[:, None, None]
    c[rows, idx] = torch.where(mine, new.to(c.dtype), c[rows, idx])


def attn_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig, cache,
                pos: torch.Tensor, rope, mode: Optional[str] = None,
                ctx=None, shards: int = 1):
    """One-token decode: write the cache at `pos`, then flash-decode.

    x: [B, 1, D]; pos: a scalar (current length) or a per-row [B] vector
    (ragged continuous batching — each row writes its own cache position
    and attends to its own ``kv_len = pos + 1``).  The cache is updated
    IN PLACE with one index per row, where the JAX package returns an
    updated copy (a vmapped ``dynamic_update_slice``).  ``shards > 1``
    runs the sequence-sharded flash-decode
    (``kernels.decode_attn.sharded.dispatch``): with a ctx whose model
    axis is ``shards`` wide the cache is this rank's slice, which takes
    the rows whose position it holds; else the static split of the
    whole cache.
    """
    q, k, v = _qkv(p, x, cfg, rope)
    kc, vc = cache["k"], cache["v"]
    if da_sharded.collective(ctx, shards):
        lo = ctx.tp_rank * kc.shape[1]
        _write_local(kc, k[:, 0], pos, lo)
        _write_local(vc, v[:, 0], pos, lo)
    elif pos.ndim:
        rows = torch.arange(x.shape[0], device=x.device)
        kc[rows, pos] = k[:, 0].to(kc.dtype)
        vc[rows, pos] = v[:, 0].to(vc.dtype)
    else:
        kc[:, pos] = k[:, 0].to(kc.dtype)
        vc[:, pos] = v[:, 0].to(vc.dtype)
    if shards > 1:
        out = da_sharded.dispatch(q[:, 0], kc, vc, kv_len=pos + 1,
                                  shards=shards, ctx=ctx, mode=mode)
    else:
        out = da_ops.decode_attn(q[:, 0], kc, vc, kv_len=pos + 1, mode=mode)
    b = x.shape[0]
    out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim).to(x.dtype)
    return out @ p.wo.to(x.dtype), cache


def cross_attn_forward(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                       kv) -> torch.Tensor:
    """Whisper's cross-attention: the query projection of x [B, S, D],
    non-causal ``_sdpa`` against the encoder's K/V ``{"k", "v"}``
    [B, T, Hkv, dh] (``encoder_kv``), then ``wo``.  Plain PyTorch in
    training, prefill and decode alike, as the JAX package's plain
    ``_sdpa`` (no decode kernel)."""
    b, s, _ = x.shape
    dh, hq = cfg.head_dim, cfg.n_heads
    q = (x @ p.wq.to(x.dtype)).reshape(b, s, hq, dh)
    out = _sdpa(q, kv["k"].to(x.dtype), kv["v"].to(x.dtype), causal=False)
    return out.reshape(b, s, hq * dh) @ p.wo.to(x.dtype)


def encoder_kv(p: Attention, enc_out: torch.Tensor,
               cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """A cross layer's K/V of the encoder output [B, T, D], in its dtype:
    ``{"k", "v"}`` [B, T, Hkv, dh]."""
    b, t, _ = enc_out.shape
    dh, hkv = cfg.head_dim, cfg.n_kv_heads
    k = (enc_out @ p.wk.to(enc_out.dtype)).reshape(b, t, hkv, dh)
    v = (enc_out @ p.wv.to(enc_out.dtype)).reshape(b, t, hkv, dh)
    return {"k": k, "v": v}
