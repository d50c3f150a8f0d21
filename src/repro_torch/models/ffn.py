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


def ffn_forward(p: FFN, x: torch.Tensor, act: str,
                ctx=None) -> torch.Tensor:
    """The FFN of x; in a tensor-parallel forward (``ctx``) w_in and
    w_gate hold this rank's columns and w_out its rows, and the result is
    this rank's partial sum (``common.row_parallel``)."""
    h = x @ p.w_in.to(x.dtype)
    if act == "swiglu":
        h = F.silu(x @ p.w_gate.to(x.dtype)) * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    else:
        raise ValueError(act)
    return common.row_parallel(h, p.w_out.to(x.dtype), ctx)
