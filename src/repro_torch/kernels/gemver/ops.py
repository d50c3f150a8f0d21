"""Wrappers for gemver: the four steps + the reassembled kernel (paper
§6.4: each step individually tuned, then unified).

``gemver_outer`` and ``gemver_sum`` lower the family's ``TraversalSpec``
factories (``specs.py``) through ``repro_torch.codegen.run_spec``: their
K1-instance CUDA kernels (``kernel.py``) on a CUDA tensor, the plain
versions on a CPU tensor or with ``mode="ref"``.  The two mxv steps
delegate to the mxv family's ``mxv_t`` and ``mxv``, as the JAX package
does; the affine parts around them are plain tensor arithmetic.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.codegen import run_spec
from repro_torch.core.planner import Traffic
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.gemver import specs
from repro_torch.kernels.mxv import ops as mxv_ops

_DEFAULT = StridingConfig(stride_unroll=4, portion_unroll=2)


def gemver_outer(a, u1, v1, u2, v2,
                 config: Optional[StridingConfig] = None,
                 mode: Optional[str] = None) -> torch.Tensor:
    """Â = A + u1 v1ᵀ + u2 v2ᵀ (paper gemverouter)."""
    m, n = a.shape
    traffic = Traffic(rows=m, cols=n, dtype=a.dtype, read_arrays=1,
                      write_arrays=1)
    cfg = common.resolve_for("gemver_outer", a, config, m, _DEFAULT,
                             traffic, mode)
    return run_spec(specs.gemver_outer_spec, (a, u1, v1, u2, v2), cfg, mode)


def gemver_sum(x, z, config: Optional[StridingConfig] = None,
               mode: Optional[str] = None) -> torch.Tensor:
    """x = x + z, 1-D loop-blocked into D strides (paper gemversum).  The
    blocked tiling pads, so any D is valid (no clamp).  As in the JAX
    package, no Traffic: explicit > tuned > default."""
    cfg = common.resolve_for("gemver_sum", x, config, None, _DEFAULT,
                             mode=mode)
    return run_spec(specs.gemver_sum_spec, (x, z), cfg, mode)


def _own_tuned(kernel: str, a, config, mode):
    """A tuned entry under this variant's own name; where it misses, the
    delegated op resolves its own chain (its tune entry, the planner)."""
    if config is not None:
        return config
    from repro_torch.registry import tunecache
    return tunecache.cached_config(kernel, a.shape, a.dtype,
                                   mode=common.kernel_mode(a, mode),
                                   device=a.device)


def gemver_mxv1(a, y, x, beta, config: Optional[StridingConfig] = None,
                mode: Optional[str] = None) -> torch.Tensor:
    """x = x + β Aᵀ y (reuses the multi-strided mxv_t kernel)."""
    config = _own_tuned("gemver_mxv1", a, config, mode)
    return x + beta * mxv_ops.mxv_t(a, y, config=config, mode=mode)


def gemver_mxv2(a, x, alpha, config: Optional[StridingConfig] = None,
                mode: Optional[str] = None) -> torch.Tensor:
    """w = α A x (reuses the multi-strided mxv kernel)."""
    config = _own_tuned("gemver_mxv2", a, config, mode)
    return alpha * mxv_ops.mxv(a, x, config=config, mode=mode)


def gemver(a, u1, v1, u2, v2, y, z, alpha, beta,
           config: Optional[StridingConfig] = None,
           mode: Optional[str] = None):
    """Full gemver: (Â, x, w), each step with its best striding config
    (paper §6.4).  A tuned entry for the composite (one shared config
    measured end to end) wins; otherwise each step resolves its own."""
    config = _own_tuned("gemver", a, config, mode)
    a_hat = gemver_outer(a, u1, v1, u2, v2, config=config, mode=mode)
    x = gemver_mxv1(a_hat, y, torch.zeros_like(z), beta, config=config,
                    mode=mode)
    x = gemver_sum(x, z, config=config, mode=mode)
    w = gemver_mxv2(a_hat, x, alpha, config=config, mode=mode)
    return a_hat, x, w
