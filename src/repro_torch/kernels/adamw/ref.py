"""Oracle for the fused AdamW update (decoupled weight decay)."""
from __future__ import annotations

import torch

__all__ = ["adamw_ref"]


def adamw_ref(p, g, m, v, lr, b1, b2, eps, wd, bc1, bc2):
    """Returns (p', m', v'). bc1/bc2 are the bias corrections 1-b^t."""
    gf = g.float()
    m_new = b1 * m + (1.0 - b1) * gf
    v_new = b2 * v + (1.0 - b2) * gf * gf
    m_hat = m_new / bc1
    v_hat = v_new / bc2
    update = m_hat / (torch.sqrt(v_hat) + eps) + wd * p.float()
    p_new = p.float() - lr * update
    return p_new.to(p.dtype), m_new, v_new
