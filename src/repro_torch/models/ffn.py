"""Dense feed-forward blocks (SwiGLU / GELU)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common


class FFN(nn.Module):
    """w_in [D, F], w_out [F, D], and w_gate [D, F] for SwiGLU."""

    def __init__(self, w_in: torch.Tensor, w_out: torch.Tensor,
                 w_gate: Optional[torch.Tensor] = None):
        super().__init__()
        self.w_in = nn.Parameter(w_in, requires_grad=False)
        self.w_out = nn.Parameter(w_out, requires_grad=False)
        self.w_gate = (None if w_gate is None
                       else nn.Parameter(w_gate, requires_grad=False))


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype, device) -> FFN:
    w_in = common.dense_init(generator, (d_model, d_ff), dtype=dtype,
                             device=device)
    w_out = common.dense_init(generator, (d_ff, d_model), dtype=dtype,
                              device=device)
    w_gate = (common.dense_init(generator, (d_model, d_ff), dtype=dtype,
                                device=device) if act == "swiglu" else None)
    return FFN(w_in, w_out, w_gate)


def ffn_forward(p: FFN, x: torch.Tensor, act: str, ctx=None,
                dtype=None) -> torch.Tensor:
    """The FFN of x in ``dtype`` (default x's: the f32 rows of
    ``common.tp_enter`` narrowed by ``common.entry_mm``); in a
    tensor-parallel forward (``ctx``) w_in and w_gate hold this rank's
    columns and w_out its rows, and the result is this rank's partial sum
    (``common.row_parallel``)."""
    dt = dtype or x.dtype
    h = common.entry_mm(x, p.w_in, dt)
    if act == "swiglu":
        h = F.silu(common.entry_mm(x, p.w_gate, dt)) * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    else:
        raise ValueError(act)
    return common.row_parallel(h, p.w_out.to(dt), ctx)


def ffn_layer(p: FFN, h: torch.Tensor, cfg, ctx) -> torch.Tensor:
    """The FFN (``cfg.d_ff`` wide) of a layer boundary's rows ``h``, back
    at the boundary: in a tensor-parallel forward column- then
    row-parallel where the model axis divides ``d_ff``, as the rules cut
    it (``common.tp_enter``, ``common.tp_exit``), else whole on every
    rank over the whole sequence (``common.rep_enter``,
    ``common.rep_exit``); the FFN itself outside one."""
    if common.tensor_parallel(ctx) and cfg.d_ff % ctx.tp == 0:
        return common.tp_exit(ffn_forward(p, common.tp_enter(h, ctx),
                                          cfg.act, ctx, h.dtype), ctx,
                              h.dtype)
    return common.rep_exit(ffn_forward(p, common.rep_enter(h, ctx),
                                       cfg.act), ctx)
