"""Mixture-of-Experts layer: a softmax top-k router with the Switch
load-balance auxiliary loss, and SwiGLU experts.

Two paths compute the same function (exact: no capacity, no drops):

* ``moe_dense`` — every expert applied to every token (``[E, t, d]``),
  combined with the routing weights: the JAX package's collective-free
  path, kept literally as the plain version the tests hold the other
  against.  At full width it is E / top_k times the active FLOPs.
* ``moe_forward`` — each expert applied to the tokens that chose it, and
  gate × output added into the token's row: the path the model runs.
  Only the order of the sum over a token's experts differs (it is f32
  here, rounded once).

The JAX package's expert-parallel ``moe_ep`` needs several cards and is
not ported; with no mesh the JAX ``moe_forward`` computes ``moe_dense``'s
function, as this one does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import common, ffn

__all__ = ["MoE", "init_moe", "moe_dense", "moe_forward"]


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


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor,
              e: MoEConfig) -> torch.Tensor:
    """Switch load-balance loss: E · Σ_e f_e p̄_e.  (The JAX package's
    ``valid`` mask serves its expert-parallel path only.)"""
    onehot = F.one_hot(idx, e.n_experts).float()          # [t, k, E]
    t = probs.shape[0]
    f = onehot.sum((0, 1)) / max(t * e.top_k, 1.0)
    p_bar = probs.sum(0) / t
    return e.n_experts * torch.sum(f * p_bar)


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


def moe_forward(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """The layer's MoE, ``moe_dense``'s function: each expert on the
    tokens that chose it.  x: [B, S, D] → (y, aux).

    The (token, slot) picks are sorted by expert (stably, so each
    expert's tokens stay in token order); one host read of the per-expert
    counts, then for each expert with picks: gather its tokens, SwiGLU,
    and add gate × output into an f32 [t, D] sum, rounded once to x's
    dtype."""
    e = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, gates, idx = _route(xt, p.router, e)
    aux = _aux_loss(probs, idx, e)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=e.n_experts).tolist()
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
