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

The experts are whole on every rank wherever the port runs a MoE under
a mesh context (the ZeRO-3 step at ``model`` = 1 gathers them; sharded
serving keeps every weight whole), so the drops need no collective.
Experts cut over a model axis of more than one rank (``moe_ep``'s
``all_to_all``) are expert parallelism, which is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import common, ffn

__all__ = ["MoE", "init_moe", "moe_dense", "moe_ep_plain",
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


def _route(xt: torch.Tensor, router_w: torch.Tensor, e: MoEConfig):
    """xt: [t, d] → (probs [t, E] f32, top-k gates [t, k] in xt's dtype,
    top-k expert ids [t, k]).

    Ties go to the lower expert id first, as ``jax.lax.top_k`` breaks
    them (``torch.topk`` promises no order): a stable descending sort and
    its first k.  The logits are a product in the compute dtype, so equal
    probabilities among many experts do occur."""
    logits = (xt @ router_w.to(xt.dtype)).float()
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


def _slice_picks(probs, idx, e: MoEConfig, tp: int):
    """``moe_ep``'s drops and router loss over ``tp`` slices of the
    ``t`` routed tokens: (keep [t, k] bool, aux).  Each (token, slot)
    pick's position in its expert's buffer is its count among the
    slice's earlier picks of that expert in (token, slot) order; the
    first ``cap`` are kept.  The loss is the mean of the slices'."""
    t, k = idx.shape
    ts, cap = capacity(t, tp, e)
    pad = ts * tp - t
    onehot = F.one_hot(idx, e.n_experts).to(torch.int32)  # [t, k, E]
    if pad:
        onehot = torch.cat([onehot, onehot.new_zeros(pad, k, e.n_experts)])
    flat = onehot.reshape(tp, ts * k, e.n_experts)
    pos = ((torch.cumsum(flat, dim=1) - 1) * flat).sum(-1)
    keep = (pos.reshape(tp * ts, k) < cap)[:t]
    valid = (torch.arange(ts * tp, device=idx.device) < t).float()
    probs_p = torch.cat([probs, probs.new_zeros(pad, probs.shape[1])])
    idx_p = torch.cat([idx, idx.new_zeros(pad, k)])
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
        onehot = F.one_hot(idx, e.n_experts).to(torch.int64)
        flat = onehot.reshape(ts * e.top_k, e.n_experts)
        pos = ((torch.cumsum(flat, 0) - 1) * flat).sum(-1).reshape(
            ts, e.top_k)
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


def moe_forward(p: MoE, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    """The layer's MoE by the JAX package's rule: ``moe_dense``'s
    function with no ``ctx`` or where its model axis does not divide the
    experts, else ``moe_ep``'s at ``tp = ctx.tp`` (:func:`moe_ep_plain`:
    each slice's overflow dropped).  Each expert runs on the tokens that
    chose it and were kept.  x: [B, S, D] → (y, aux).

    The (token, slot) picks are sorted by expert (stably, so each
    expert's tokens stay in token order; a dropped pick sorts last, past
    every expert); one host read of the per-expert counts, then for each
    expert with picks: gather its tokens, SwiGLU, and add gate × output
    into an f32 [t, D] sum, rounded once to x's dtype."""
    e = cfg.moe
    tp = 1 if ctx is None else ctx.tp
    if common.tensor_parallel(ctx):
        raise NotImplementedError(
            "MoE experts cut over a model axis of more than one rank are "
            "expert parallelism (moe_ep's all_to_all), which is not "
            "ported: ROADMAP.md Queue 1 item 4, MoE expert parallelism")
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
    y = y.to(x.dtype)
    if e.dense_residual:
        y = y + ffn.ffn_forward(p.dense, xt, cfg.act)
    return y.reshape(b, s, d), aux
