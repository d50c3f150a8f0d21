"""Wrapper for doitgen.

Lowers the family's ``TraversalSpec`` (``specs.py``) through
``repro_torch.codegen.run_spec``: the hand-written K1-instance kernel
(``csrc/doitgen.cu``) on a CUDA tensor, the plain version on a CPU
tensor or with ``mode="ref"``.  The batched 3-D nest keeps ``r`` as a
batch grid dimension; D is clamped on ``m = r·q`` as the JAX op
resolves it, and the emitter pads ``q`` to whole streams.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.codegen import run_spec
from repro_torch.core.planner import Traffic
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.doitgen import specs

_DEFAULT = StridingConfig(stride_unroll=4, portion_unroll=1)


def doitgen(a: torch.Tensor, c4: torch.Tensor,
            config: Optional[StridingConfig] = None,
            mode: Optional[str] = None) -> torch.Tensor:
    """A[r,q,:] ← A[r,q,:] @ C4 (paper doitgen, incl. write-back):
    ``[r, q, s] × [s, p]`` → ``[r, q, p]`` in A's dtype."""
    r, q, s = a.shape
    m = r * q
    traffic = Traffic(rows=m, cols=s, dtype=a.dtype, read_arrays=1,
                      write_arrays=1, resident_bytes=s * c4.shape[1] * 4)
    cfg = common.resolve_for("doitgen", a, config, m, _DEFAULT, traffic,
                             mode)
    return run_spec(specs.doitgen_spec, (a, c4), cfg, mode)
