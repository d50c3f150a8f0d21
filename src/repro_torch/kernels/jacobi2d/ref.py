"""Plain PyTorch oracle for the 2D Jacobi stencil sweep (PolyBench
jacobi-2d)."""
from __future__ import annotations

import torch

__all__ = ["jacobi2d_ref"]


def jacobi2d_ref(a: torch.Tensor) -> torch.Tensor:
    """B[i,j] = 0.2*(A[i,j] + A[i,j-1] + A[i,j+1] + A[i-1,j] + A[i+1,j])
    over the interior; returns [H-2, W-2] in A's dtype."""
    c = a[1:-1, 1:-1]
    return (0.2 * (c + a[1:-1, :-2] + a[1:-1, 2:] + a[:-2, 1:-1]
                   + a[2:, 1:-1])).to(a.dtype)
