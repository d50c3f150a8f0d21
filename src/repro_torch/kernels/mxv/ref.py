"""Oracles for matrix-vector kernels (paper mxv / gemvermxv2 and the
transposed gemvermxv1 / doitgen-core form, Listing 1)."""
from __future__ import annotations

import torch

from repro_torch.kernels.mxv.specs import col_dot, row_dot

__all__ = ["mxv_ref", "mxv_t_ref"]


def mxv_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_j A[i,j] x[j], f32 accumulation."""
    return row_dot(a, x).to(a.dtype)


def mxv_t_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[j] = sum_i A[i,j] x[i] (paper Listing 1: C[i] += A[j][i]*B[j])."""
    return col_dot(x, a).to(a.dtype)
