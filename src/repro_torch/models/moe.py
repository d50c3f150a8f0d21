"""Mixture-of-Experts layer: a softmax top-k router with the Switch
load-balance auxiliary loss, and SwiGLU experts.

The JAX package has two paths, and its ``moe_forward`` picks one by the
mesh: ``moe_dense`` (exact, no capacity, no drops) with no mesh context
or where the model axis does not divide the experts, else ``moe_ep``.
``moe_ep`` splits each data rank's ``t`` tokens into ``tp`` slices of
``ceil(t / tp)`` (the last padded), keeps each expert's first
``cap = max(int(t_slice · top_k · capacity_factor / E), 1)`` picks of a
slice in (token, slot) order and drops the rest, and averages the
slices' router losses (each over its valid tokens).  It does so under
any mesh context, a model axis of one rank included.  This module
computes both functions:

* ``moe_dense`` — every expert applied to every token (``[E, t, d]``),
  combined with the routing weights: the JAX package's collective-free
  path, kept literally as the plain version the tests hold the other
  against.  At full width it is E / top_k times the active FLOPs.
* ``moe_ep_plain`` — ``_ep_body`` literally at a given ``tp``, its
  capacity buffers and all, the experts whole (the ``all_to_all`` over
  the model axis only moves each slice's buffer to the experts' rank).
* ``moe_forward`` — the path the model runs, by the JAX rule: each
  expert applied to the tokens that chose it (and, under a mesh
  context, that its capacity kept), gate × output added into the
  token's row.  Only the order of the sum over a token's experts
  differs (it is f32 here, rounded once).
* ``moe_ep`` — expert parallelism, the path of a tensor-parallel
  forward (``common.tensor_parallel``) whose model axis divides the
  experts: each rank holds its ``E / tp`` experts (the rules' ``model``
  block), routes its slice of the tokens into capacity buffers ``[E,
  cap, d]``, sends each expert's rows to the expert's rank and back
  (``all_to_all`` over ``model``, :class:`_Exchange`) and all-gathers
  the slices' outputs: ``_ep_body`` with its collectives.

Elsewhere the experts are whole on every rank (the ZeRO-3 step at
``model`` = 1 gathers them; sharded serving keeps every weight whole; a
model axis that does not divide the experts leaves them whole, as the
rules do), and the drops need no collective.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import common, ffn

__all__ = ["MoE", "init_moe", "moe_dense", "moe_ep_plain", "moe_ep",
           "moe_forward", "capacity"]


class MoE(nn.Module):
    """router [D, E]; w_in, w_gate [E, D, F]; w_out [E, F, D]; and, for
    Arctic's dense residual, ``dense`` (an ``ffn.FFN``) else None."""

    def __init__(self, router, w_in, w_gate, w_out,
                 dense: Optional[ffn.FFN] = None):
        super().__init__()
        for name, t in (("router", router), ("w_in", w_in),
                        ("w_gate", w_gate), ("w_out", w_out)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))
        self.dense = dense


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype,
             device) -> MoE:
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert

    def w(shape, in_axis=0):
        return common.dense_init(generator, shape, in_axis=in_axis,
                                 dtype=dtype, device=device)
    dense = (ffn.init_ffn(generator, d, e.d_ff_dense or cfg.d_ff, cfg.act,
                          dtype, device) if e.dense_residual else None)
    return MoE(w((d, e.n_experts)), w((e.n_experts, d, f), 1),
               w((e.n_experts, d, f), 1), w((e.n_experts, f, d), 1), dense)


def _route(xt: torch.Tensor, router_w: torch.Tensor, e: MoEConfig,
           ctx=None):
    """xt: [t, d] → (probs [t, E] f32, top-k gates [t, k] in xt's dtype,
    top-k expert ids [t, k]); ``ctx``: a tensor-parallel forward's, where
    xt is this rank's slice of the tokens (the router's gradient summed
    over ``model``, ``common.model_summed``).

    Ties go to the lower expert id first, as ``jax.lax.top_k`` breaks
    them (``torch.topk`` promises no order): a stable descending sort and
    its first k.  The logits are a product in the compute dtype, so equal
    probabilities among many experts do occur."""
    logits = common.model_summed(xt, router_w, ctx).float()
    probs = torch.softmax(logits, dim=-1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :e.top_k], ids[:, :e.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates.to(xt.dtype), idx


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, e: MoEConfig,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Switch load-balance loss: E · Σ_e f_e p̄_e, over the tokens that
    ``valid`` (f32 [t]) marks where given (a slice's padding is not
    counted)."""
    onehot = F.one_hot(idx, e.n_experts).float()          # [t, k, E]
    if valid is not None:
        onehot = onehot * valid[:, None, None]
        probs = probs * valid[:, None]
        denom = valid.sum().clamp_min(1.0)
        f = onehot.sum((0, 1)) / (denom * e.top_k).clamp_min(1.0)
    else:
        denom = probs.shape[0]
        f = onehot.sum((0, 1)) / max(denom * e.top_k, 1.0)
    p_bar = probs.sum(0) / denom
    return e.n_experts * torch.sum(f * p_bar)


def capacity(t: int, tp: int, e: MoEConfig) -> tuple[int, int]:
    """(tokens a slice, an expert's capacity in a slice) of ``moe_ep``
    over ``t`` tokens in ``tp`` slices."""
    t_slice = -(-t // tp)
    return t_slice, max(int(t_slice * e.top_k * e.capacity_factor
                            / e.n_experts), 1)


def _positions(idx: torch.Tensor, e: MoEConfig,
               n: int = 1) -> torch.Tensor:
    """[t, k]: each (token, slot) pick's position in its expert's buffer
    within each of ``n`` equal slices of the ``t`` tokens — its count
    among the slice's earlier picks of that expert in (token, slot)
    order."""
    t, k = idx.shape
    onehot = F.one_hot(idx, e.n_experts).to(torch.int32).reshape(
        n, t // n * k, e.n_experts)
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)
    return pos.reshape(t, k).long()


def _slice_picks(probs, idx, e: MoEConfig, tp: int):
    """``moe_ep``'s drops and router loss over ``tp`` slices of the
    ``t`` routed tokens: (keep [t, k] bool, aux).  The first ``cap``
    picks of each expert in a slice (:func:`_positions`) are kept.  The
    loss is the mean of the slices'."""
    t, k = idx.shape
    ts, cap = capacity(t, tp, e)
    pad = ts * tp - t
    idx_p = torch.cat([idx, idx.new_zeros(pad, k)])
    keep = (_positions(idx_p, e, tp) < cap)[:t]
    valid = (torch.arange(ts * tp, device=idx.device) < t).float()
    probs_p = torch.cat([probs, probs.new_zeros(pad, probs.shape[1])])
    aux = torch.stack([
        _aux_loss(probs_p[j * ts:(j + 1) * ts], idx_p[j * ts:(j + 1) * ts],
                  e, valid[j * ts:(j + 1) * ts]) for j in range(tp)]).mean()
    return keep, aux


def _expert_ffn(w_in, w_gate, w_out, xb: torch.Tensor,
                dtype) -> torch.Tensor:
    """SwiGLU of ``xb`` [E?, t, d] through experts [E?, d, f] / [E?, f, d]
    (one expert with 2-D weights)."""
    h = torch.matmul(xb, w_in.to(dtype))
    g = torch.matmul(xb, w_gate.to(dtype))
    return torch.matmul(F.silu(g) * h, w_out.to(dtype))


def moe_dense(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Every expert on every token: the JAX package's ``moe_dense``, the
    plain version.  x: [B, S, D] → (y, aux)."""
    e = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, gates, idx = _route(xt, p.router, e)
    aux = _aux_loss(probs, idx, e)
    xb = xt[None].expand(e.n_experts, b * s, d)
    yb = _expert_ffn(p.w_in, p.w_gate, p.w_out, xb, x.dtype)
    onehot = F.one_hot(idx, e.n_experts).to(x.dtype)      # [t, k, E]
    w = (onehot * gates[..., None]).sum(1)                # [t, E]
    y = torch.einsum("te,etd->td", w, yb)
    if e.dense_residual:
        y = y + ffn.ffn_forward(p.dense, xt, cfg.act)
    return y.reshape(b, s, d), aux


def moe_ep_plain(p: MoE, x: torch.Tensor, cfg: ModelConfig, tp: int):
    """The JAX package's ``_ep_body`` over a model axis of ``tp`` ranks,
    literally, with the experts whole: each slice of ``ceil(t / tp)``
    tokens routed into capacity buffers ``[E, cap, d]`` (scatter-add, the
    dropped picks zero), every expert on its buffer, each kept slot's
    output gathered back and weighted by its gate, summed over the slots
    in x's dtype; the slices' router losses averaged.  The plain version
    :func:`moe_forward` is held against.  x: [B, S, D] → (y, aux)."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    ts, cap = capacity(t, tp, e)
    xt = x.reshape(t, d)
    xt = torch.cat([xt, xt.new_zeros(ts * tp - t, d)])
    ys, auxes = [], []
    for j in range(tp):
        xs = xt[j * ts:(j + 1) * ts]
        valid = (j * ts + torch.arange(ts, device=x.device)) < t
        probs, gates, idx = _route(xs, p.router, e)
        auxes.append(_aux_loss(probs, idx, e, valid.float()))
        pos = _positions(idx, e)
        keep = (pos < cap) & valid[:, None]
        esafe = torch.where(keep, idx, 0).reshape(-1)
        psafe = torch.where(keep, pos, 0).reshape(-1)
        src = (xs[:, None, :] * keep[..., None].to(x.dtype)).reshape(-1, d)
        buf = x.new_zeros(e.n_experts, cap, d).index_put(
            (esafe, psafe), src, accumulate=True)
        yb = _expert_ffn(p.w_in, p.w_gate, p.w_out, buf, x.dtype)
        yslot = yb[esafe, psafe].reshape(ts, e.top_k, d)
        yslot = yslot * (gates * keep.to(gates.dtype))[..., None]
        ys.append(yslot.sum(1))
    y = torch.cat(ys)[:t]
    if e.dense_residual:
        y = y + ffn.ffn_forward(p.dense, x.reshape(t, d), cfg.act)
    return y.reshape(b, s, d), torch.stack(auxes).mean()


# ------------------------------------------------ expert parallelism
#
# Autograd Functions over the model group of a tensor-parallel forward.
# The tokens enter whole and equal on every rank (``common.rep_enter``)
# and leave so; in between each rank holds its slice of them.

def _model_all_gather(x: torch.Tensor, ctx) -> torch.Tensor:
    """[n, d] of every rank → [tp · n, d], in rank order."""
    return common._seq_gather(x[None], ctx)[0]


class _TokenSlice(torch.autograd.Function):
    """Whole tokens [t, d], equal on every rank → this rank's slice of
    ``ts`` rows (zero rows past ``t``); backward all-gathers the slices'
    gradients, the whole (equal) gradient."""

    @staticmethod
    def forward(fctx, x, ctx, ts: int):
        fctx.ctx, fctx.t = ctx, x.shape[0]
        lo = ctx.tp_rank * ts
        out = x.new_zeros((ts, x.shape[1]))
        n = max(min(ts, x.shape[0] - lo), 0)
        out[:n] = x[lo:lo + n]
        return out

    @staticmethod
    def backward(fctx, g):
        return _model_all_gather(g, fctx.ctx)[:fctx.t], None, None


class _GatherTokens(torch.autograd.Function):
    """Each rank's slice [ts, d] → the whole [tp · ts, d] on every rank
    (the JAX ``all_gather(..., tiled=True)``); backward keeps this rank's
    slice of the whole (equal) gradient."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx, fctx.ts = ctx, x.shape[0]
        return _model_all_gather(x, ctx)

    @staticmethod
    def backward(fctx, g):
        lo = fctx.ctx.tp_rank * fctx.ts
        return g[lo:lo + fctx.ts], None


class _Exchange(torch.autograd.Function):
    """``all_to_all`` over the model group of [tp, ...]: row r goes to
    rank r, and row r of the result comes from rank r (the JAX
    ``all_to_all(split_axis=0, concat_axis=0, tiled=False)``); backward
    is the reverse exchange of the gradient."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _all_to_all(x, ctx)

    @staticmethod
    def backward(fctx, g):
        return _all_to_all(g, fctx.ctx), None


def _all_to_all(x: torch.Tensor, ctx) -> torch.Tensor:
    from repro_torch.sharding import collectives
    x = x.contiguous()
    out = torch.empty_like(x)
    collectives.all_to_all(out.view(-1), x.view(-1), ctx.tp_group,
                           axis=ctx.tp_axis)
    return out


class _ModelMean(torch.autograd.Function):
    """A per-rank scalar's mean over the model group (the JAX
    ``pmean``); backward hands each rank its 1 / tp share."""

    @staticmethod
    def forward(fctx, x, ctx):
        from repro_torch.sharding import collectives
        fctx.tp = ctx.tp
        return collectives.all_reduce(x.detach().clone(), ctx.tp_group,
                                      axis=ctx.tp_axis) / ctx.tp

    @staticmethod
    def backward(fctx, g):
        return g / fctx.tp, None


def moe_ep(p: MoE, x: torch.Tensor, cfg: ModelConfig, ctx):
    """Expert parallelism, the JAX ``_ep_body`` over ``ctx``'s model
    group: x, the layer boundary's rows [B, S / tp or S, D] →
    (y of the same rows, aux).  ``p``'s experts are this rank's ``E /
    tp`` (rank r holds experts [r · E / tp, (r + 1) · E / tp)); its
    router is whole.

    The tokens enter whole (``common.rep_enter``); the rank takes its
    slice of ``ts = ceil(t / tp)`` of the ``t = B · S`` flattened
    (batch-major) tokens, routes it, scatters each kept pick into the
    capacity buffers ``[E, cap, D]``, sends expert block j to rank j
    (:class:`_Exchange`), runs its experts on their ``[E / tp, tp ·
    cap, D]`` rows, sends the results back, gathers each kept slot
    weighted by its gate (summed over a token's slots in f32 and
    rounded once, as :func:`_grouped` sums; the JAX body sums in x's
    dtype) and all-gathers the slices (:class:`_GatherTokens`), then
    leaves to the boundary's rows
    (``common.rep_exit``).  The buffers' shapes are fixed: no count is
    read on the host.  The router loss is the slices' mean over the
    model group (:class:`_ModelMean`); each rank's router gradient is
    its slice's part, summed over ``model`` in the backward
    (``common.model_summed``)."""
    e = cfg.moe
    tp = ctx.tp
    xw = common.rep_enter(x, ctx)
    b, s, d = xw.shape
    t = b * s
    ts, cap = capacity(t, tp, e)
    xs = _TokenSlice.apply(xw.reshape(t, d), ctx, ts)
    valid = (ctx.tp_rank * ts + torch.arange(ts, device=x.device)) < t
    probs, gates, idx = _route(xs, p.router, e, ctx)
    aux = _ModelMean.apply(_aux_loss(probs, idx, e, valid.float()), ctx)
    pos = _positions(idx, e)
    keep = (pos < cap) & valid[:, None]
    esafe = torch.where(keep, idx, 0).reshape(-1)
    psafe = torch.where(keep, pos, 0).reshape(-1)
    src = (xs[:, None, :] * keep[..., None].to(x.dtype)).reshape(-1, d)
    buf = x.new_zeros(e.n_experts, cap, d).index_put(
        (esafe, psafe), src, accumulate=True)
    e_loc = e.n_experts // tp
    recv = _Exchange.apply(buf.view(tp, e_loc, cap, d), ctx)
    xb = recv.transpose(0, 1).reshape(e_loc, tp * cap, d)
    yb = _expert_ffn(p.w_in, p.w_gate, p.w_out, xb, x.dtype)
    back = yb.view(e_loc, tp, cap, d).transpose(0, 1)
    outbuf = _Exchange.apply(back, ctx).view(e.n_experts, cap, d)
    yslot = outbuf[esafe, psafe].view(ts, e.top_k, d).float()
    w = (gates * keep.to(gates.dtype)).float()
    ys = (yslot * w[..., None]).sum(1).to(x.dtype)
    y = _GatherTokens.apply(ys, ctx)[:t].view(b, s, d)
    return common.rep_exit(y, ctx), aux


def _grouped(p: MoE, x: torch.Tensor, cfg: ModelConfig, ctx):
    """The experts whole: each expert applied to the tokens that chose it
    (and were kept), x [B, S, D] → (y without the dense residual, aux).

    The (token, slot) picks are sorted by expert (stably, so each
    expert's tokens stay in token order; a dropped pick sorts last, past
    every expert); one host read of the per-expert counts, then for each
    expert with picks: gather its tokens, SwiGLU, and add gate × output
    into an f32 [t, D] sum, rounded once to x's dtype."""
    e = cfg.moe
    tp = 1 if ctx is None else ctx.tp
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, gates, idx = _route(xt, p.router, e)
    flat = idx.reshape(-1)
    if ctx is None or e.n_experts % tp:
        aux = _aux_loss(probs, idx, e)
    else:
        keep, aux = _slice_picks(probs, idx, e, tp)
        flat = torch.where(keep.reshape(-1), flat, e.n_experts)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=e.n_experts)[
        :e.n_experts].tolist()
    tok = order // e.top_k
    gate = gates.reshape(-1)[order].float()
    y = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    start = 0
    for ex, n in enumerate(counts):
        if not n:
            continue
        rows, g = tok[start:start + n], gate[start:start + n, None]
        start += n
        out = _expert_ffn(p.w_in[ex], p.w_gate[ex], p.w_out[ex], xt[rows],
                          x.dtype)
        y.index_add_(0, rows, out.float() * g)
    return y.to(x.dtype).reshape(b, s, d), aux


def moe_forward(p: MoE, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    """The layer's MoE by the JAX package's rule: ``moe_dense``'s
    function with no ``ctx`` or where its model axis does not divide the
    experts, else ``moe_ep``'s at ``tp = ctx.tp`` (:func:`moe_ep_plain`:
    each slice's overflow dropped).  x: [B, S, D] → (y, aux).

    In a tensor-parallel forward x is the layer boundary's rows and so is
    y: expert parallelism (:func:`moe_ep`) where the model axis divides
    the experts, else the whole experts on every rank over the whole
    sequence (``common.rep_enter``, ``rep_exit``), as the rules keep
    them.  Elsewhere each expert runs on the tokens that chose it
    (:func:`_grouped`).  Arctic's dense residual FFN is added as a dense
    layer's (``ffn.ffn_layer``)."""
    e = cfg.moe
    dense = None
    if e.dense_residual:
        # first: the experts' last collective then ends the layer
        dense = ffn.ffn_layer(p.dense, x, cfg, ctx)
    if common.tensor_parallel(ctx) and e.n_experts % ctx.tp == 0:
        y, aux = moe_ep(p, x, cfg, ctx)
    else:
        y, aux = _grouped(p, common.rep_enter(x, ctx), cfg, ctx)
        y = common.rep_exit(y, ctx)
    return (y if dense is None else y + dense), aux
