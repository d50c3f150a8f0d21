"""Wrapper for jacobi2d.

Lowers the family's ``TraversalSpec`` (``specs.py``) through
``repro_torch.codegen.run_spec``: the hand-written K1-instance kernel
(``csrc/stencil.cu``) on a CUDA tensor, the plain version on a CPU
tensor or with ``mode="ref"``.  The emitter pads the rows to whole
streams and crops the result.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.codegen import run_spec
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.jacobi2d import specs

_DEFAULT = StridingConfig(stride_unroll=4, portion_unroll=1)


def jacobi2d(x: torch.Tensor, config: Optional[StridingConfig] = None,
             mode: Optional[str] = None) -> torch.Tensor:
    """One Jacobi 5-point sweep over the interior (paper jacobi2d):
    ``[h, w]`` → ``[h-2, w-2]``, with D clamped to divide ``h - 2``."""
    h_out = max(x.shape[0] - 2, 1)
    # no Traffic, as the JAX op: explicit > tuned > default
    cfg = common.resolve_for("jacobi2d", x, config, h_out, _DEFAULT,
                             mode=mode)
    return run_spec(specs.jacobi_spec, (x,), cfg, mode)
