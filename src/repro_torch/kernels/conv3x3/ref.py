"""Plain PyTorch oracle for the 3x3 2D convolution stencil (valid
padding)."""
from __future__ import annotations

import torch

__all__ = ["conv3x3_ref"]


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[i,j] = Σ_{r,c} w[r,c] x[i+r, j+c]; out is [H-2, W-2].

    A correlation (no kernel flip), the paper's stencil loop, summed in
    f32 and cast to x's dtype."""
    h, wd = x.shape
    xf, wf = x.float(), w.float()
    out = torch.zeros(h - 2, wd - 2, dtype=torch.float32, device=x.device)
    for r in range(3):
        for c in range(3):
            out = out + wf[r, c] * xf[r:r + h - 2, c:c + wd - 2]
    return out.to(x.dtype)
