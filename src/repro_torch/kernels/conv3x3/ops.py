"""Wrapper for conv3x3.

Lowers the family's ``TraversalSpec`` (``specs.py``) through
``repro_torch.codegen.run_spec``: the hand-written K1-instance kernel
(``csrc/stencil.cu``) on a CUDA tensor, the plain version on a CPU
tensor or with ``mode="ref"``.  The 3×3 weight tensor is unpacked into
the spec's nine scalars, as the JAX package's ``ops.py`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.codegen import run_spec
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.conv3x3 import specs

_DEFAULT = StridingConfig(stride_unroll=4, portion_unroll=1)


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            config: Optional[StridingConfig] = None,
            mode: Optional[str] = None) -> torch.Tensor:
    """3x3 correlation stencil, valid region (paper conv): ``[h, w]`` →
    ``[h-2, w-2]``, with D clamped to divide ``h - 2``."""
    h_out = max(x.shape[0] - 2, 1)
    # no Traffic, as the JAX op: explicit > tuned > default
    cfg = common.resolve_for("conv3x3", x, config, h_out, _DEFAULT,
                             mode=mode)
    w9 = [w[r, c] for r in range(3) for c in range(3)]
    return run_spec(specs.conv3x3_spec, (x, *w9), cfg, mode)
