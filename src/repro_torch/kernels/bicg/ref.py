"""Oracle for the BiCG sub-kernel (paper Table 1, PolyBench bicg)."""
from __future__ import annotations

import torch

from repro_torch.kernels.mxv.specs import col_dot, row_dot

__all__ = ["bicg_ref"]


def bicg_ref(a: torch.Tensor, r: torch.Tensor, p: torch.Tensor):
    """q[i] = Σ_j A[i,j] p[j];  s[j] = Σ_i r[i] A[i,j]."""
    return row_dot(a, p).to(a.dtype), col_dot(r, a).to(a.dtype)
