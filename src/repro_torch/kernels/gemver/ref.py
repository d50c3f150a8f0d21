"""Oracles for the four gemver steps (PolyBench gemver, paper Table 1)."""
from __future__ import annotations

import torch

from repro_torch.kernels.mxv.specs import col_dot, row_dot

__all__ = ["outer_ref", "sum_ref", "mxv1_ref", "mxv1_sum_ref",
           "mxv2_ref", "gemver_ref"]


def outer_ref(a, u1, v1, u2, v2):
    """Â = A + u1 v1ᵀ + u2 v2ᵀ (double rank-1 update)."""
    return a + u1[:, None] * v1[None, :] + u2[:, None] * v2[None, :]


def sum_ref(x, z):
    """x = x + z (vector sum update)."""
    return x + z


def mxv1_ref(a, y, x, beta):
    """x = x + β Aᵀ y (transpose matrix-vector)."""
    return x + beta * col_dot(y, a).to(a.dtype)


def mxv1_sum_ref(a, y, x, z, beta):
    """Fused mxv1 + sum steps with the sweep's own reduction:
    (x + β Aᵀ y + z, Σⱼ (β Aᵀ y)ⱼ)."""
    s = beta * col_dot(y, a)
    return x + s.to(a.dtype) + z, s.sum()


def mxv2_ref(a, x, alpha):
    """w = α A x (matrix-vector)."""
    return alpha * row_dot(a, x).to(a.dtype)


def gemver_ref(a, u1, v1, u2, v2, y, z, alpha, beta):
    """Full PolyBench gemver composition."""
    a_hat = outer_ref(a, u1, v1, u2, v2)
    x = mxv1_ref(a_hat, y, torch.zeros_like(z), beta)
    x = sum_ref(x, z)
    w = mxv2_ref(a_hat, x, alpha)
    return a_hat, x, w
