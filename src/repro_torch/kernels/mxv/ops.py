"""Wrappers for mxv / mxv_t.

Both lower the family's ``TraversalSpec`` (``specs.py``) through
``repro_torch.codegen.run_spec``: the hand-written kernels on a CUDA
tensor (``kernel.py``), the plain version on a CPU tensor or with
``mode="ref"``.  Padding and cropping happen in the emitter; ``mxv_t``'s
stride-axis reduction clamps D to divide the row count instead of
padding (the combine identity cannot be guaranteed through an arbitrary
body), and so, as in the JAX package, does ``mxv``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.codegen import run_spec
from repro_torch.core.planner import Traffic
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.mxv import specs

_DEFAULT = StridingConfig(stride_unroll=4, portion_unroll=2)


def _resolve(kernel: str, a: torch.Tensor, config, mode,
             extra_reads: int = 0) -> StridingConfig:
    m, n = a.shape
    traffic = Traffic(rows=m, cols=n, dtype=a.dtype,
                      read_arrays=1 + extra_reads)
    return common.resolve_for(kernel, a, config, m, _DEFAULT, traffic, mode)


def mxv(a: torch.Tensor, x: torch.Tensor,
        config: Optional[StridingConfig] = None,
        mode: Optional[str] = None) -> torch.Tensor:
    """y = A @ x (paper mxv / gemvermxv2)."""
    cfg = _resolve("mxv", a, config, mode)
    return run_spec(specs.mxv_spec, (a, x), cfg, mode)


def mxv_t(a: torch.Tensor, x: torch.Tensor,
          config: Optional[StridingConfig] = None,
          mode: Optional[str] = None) -> torch.Tensor:
    """y = Aᵀ @ x (paper Listing 1: gemvermxv1 / doitgen core)."""
    cfg = _resolve("mxv_t", a, config, mode, extra_reads=1)
    return run_spec(specs.mxv_t_spec, (a, x), cfg, mode)
