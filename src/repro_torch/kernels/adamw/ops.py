"""Wrapper for the fused AdamW update (any parameter shape).

As the JAX package's ``ops.py``: the flattened tensor is §5.1.1
loop-blocked into ``[ceil(n / cols), cols]`` tiles, ``cols = min(512,
max(128, n))`` (:func:`_blocking`), and the family's ``TraversalSpec``
(``specs.py``) is lowered through ``repro_torch.codegen.run_spec``: the
hand-written K1-instance kernel (``csrc/adamw.cu``) on a CUDA tensor, or
the K4 ring's adamw body at a ``lookahead`` other than 2.  The flatten
is a view and pads nothing where ``n`` is a multiple of ``cols`` (every
Yi-9B parameter), and the D streams split the rows without padding
(``resolve_config`` clamps D to divide them).

On a CPU tensor, or with ``mode="ref"``, the body is evaluated at the
tensor's native shape, as the JAX ``ref`` branch does.

The seven scalars are 0-d f32 tensors on the parameter's device
(:func:`scalars`): a tensor is moved and cast there, a Python number is
made there with ``torch.full`` (a fill, not a host copy), so an
optimizer step that computes ``lr`` and the bias corrections on the card
launches without a host sync.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.codegen import loopir, run_spec
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.adamw import specs

__all__ = ["adamw_update", "scalars"]

_DEFAULT = StridingConfig(stride_unroll=2, portion_unroll=2)
_COLS = 512


def _blocking(n: int) -> tuple[int, int]:
    cols = min(_COLS, max(128, n))
    rows = -(-n // cols)
    return rows, cols


def _flat(a: torch.Tensor, rows: int, cols: int,
          dtype: torch.dtype) -> torch.Tensor:
    """``a`` flattened, cast and zero-padded to ``[rows, cols]``: a view
    of ``a`` when it is contiguous, already ``dtype`` and ``rows·cols``
    long."""
    a = a.reshape(-1).to(dtype)
    if a.numel() != rows * cols:
        a = F.pad(a, (0, rows * cols - a.numel()))
    return a.reshape(rows, cols)


def scalars(device: torch.device, *values) -> list[torch.Tensor]:
    """Each value as a 0-d f32 tensor on ``device``, without a host copy
    for a Python number."""
    out = []
    for x in values:
        if isinstance(x, torch.Tensor):
            out.append(x.to(device=device, dtype=torch.float32).reshape(()))
        else:
            out.append(torch.full((), float(x), dtype=torch.float32,
                                  device=device))
    return out


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.0,
                 bc1=1.0, bc2=1.0, config: Optional[StridingConfig] = None,
                 mode: Optional[str] = None):
    """Fused AdamW for one parameter tensor. Returns (p', m', v'): p' in
    p's dtype, m' and v' in f32."""
    shape = p.shape
    n = p.numel()
    s = scalars(p.device, lr, b1, b2, eps, wd, bc1, bc2)
    if common.kernel_mode(p, mode) == "ref":
        # the elementwise body at the tensor's NATIVE shape; the spec's
        # axes only describe the traversal, evaluate() never tiles
        spec = specs.adamw_spec(p.reshape(-1, shape[-1]) if p.ndim > 1
                                else p.reshape(1, -1), None, None, None)
        po, mo, vo = loopir.evaluate(spec, (p, g, m.float(), v.float(), *s))
        return po.to(p.dtype), mo, vo
    rows, cols = _blocking(max(n, 1))
    cfg = common.resolve_config("adamw_update", config, rows, _DEFAULT)
    po, mo, vo = run_spec(specs.adamw_spec,
                          (_flat(p, rows, cols, p.dtype),
                           _flat(g, rows, cols, g.dtype),
                           _flat(m, rows, cols, torch.float32),
                           _flat(v, rows, cols, torch.float32), *s),
                          cfg, mode)

    def unflat(a, dt):
        return a.reshape(-1)[:n].reshape(shape).to(dt)

    return (unflat(po, p.dtype), unflat(mo, torch.float32),
            unflat(vo, torch.float32))
