"""Wrapper for fused RMSNorm (any leading batch dims).

Lowers the family's ``TraversalSpec`` (``specs.py``) through
``repro_torch.codegen.run_spec``: the hand-written K1-instance kernel on
a CUDA tensor, the plain version on a CPU tensor or with ``mode="ref"``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.codegen import run_spec
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.rmsnorm import specs

_DEFAULT = StridingConfig(stride_unroll=4, portion_unroll=1)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            config: Optional[StridingConfig] = None,
            mode: Optional[str] = None, with_inv_rms: bool = False):
    """RMS-normalize the last axis of ``x`` and scale by ``w``.

    ``with_inv_rms=True`` also returns the f32 inverse rms per row (the
    kernel's native second output), shaped ``x.shape[:-1]``."""
    shape = x.shape
    t = max(math.prod(shape[:-1]), 1)
    # no Traffic, as the JAX op: explicit > tuned > default
    cfg = common.resolve_for("rmsnorm", x, config, t, _DEFAULT, mode=mode)
    out, inv = run_spec(specs.rmsnorm_spec,
                        (x.reshape(-1, shape[-1]).contiguous(), w, eps),
                        cfg, mode)
    out = out.reshape(shape)
    return (out, inv.reshape(shape[:-1])) if with_inv_rms else out
