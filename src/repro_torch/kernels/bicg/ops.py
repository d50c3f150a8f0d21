"""Wrapper for bicg (PolyBench BiCGStab sub-kernel).

Lowers the family's two ``TraversalSpec`` factories (``specs.py``)
through ``repro_torch.codegen.run_spec``: on a CUDA tensor ``q`` runs the
K2 row-dot kernel and ``s`` the K3 column-dot pair of the mxv family
(``repro_torch.kernels.mxv.kernel``); on a CPU tensor or with
``mode="ref"`` both run their plain versions.  Like the JAX package,
both sweeps take one config (explicit > tuned > planned > default), with
D clamped to divide the row count.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.codegen import run_spec
from repro_torch.core.planner import Traffic
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.bicg import specs

_DEFAULT = StridingConfig(stride_unroll=4, portion_unroll=2)


def bicg(a: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
         config: Optional[StridingConfig] = None,
         mode: Optional[str] = None):
    """q = A p ; s = Aᵀ r (paper bicg: two sweeps of A)."""
    m, n = a.shape
    traffic = Traffic(rows=m, cols=n, dtype=a.dtype, read_arrays=2)
    cfg = common.resolve_for("bicg", a, config, m, _DEFAULT, traffic, mode)
    return (run_spec(specs.bicg_q_spec, (a, p), cfg, mode),
            run_spec(specs.bicg_s_spec, (a, r), cfg, mode))
