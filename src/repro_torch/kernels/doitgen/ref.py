"""Plain PyTorch oracle for doitgen (PolyBench: MADNESS multi-resolution
analysis)."""
from __future__ import annotations

import torch

__all__ = ["doitgen_ref"]


def doitgen_ref(a: torch.Tensor, c4: torch.Tensor) -> torch.Tensor:
    """A[r,q,p] = Σ_s A[r,q,s] C4[s,p] (incl. the write-back step),
    summed in f32 and cast to A's dtype."""
    return torch.einsum("rqs,sp->rqp", a.float(), c4.float()).to(a.dtype)
