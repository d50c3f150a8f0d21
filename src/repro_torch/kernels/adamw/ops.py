"""Wrappers for the fused AdamW update: :func:`adamw_update` for one
parameter tensor of any shape, :func:`adamw_update_many` for a list of
them in one launch, in place.

As the JAX package's ``ops.py``: the flattened tensor is §5.1.1
loop-blocked into ``[ceil(n / cols), cols]`` tiles, ``cols = min(512,
max(128, n))`` (:func:`_blocking`), and the family's ``TraversalSpec``
(``specs.py``) is lowered through ``repro_torch.codegen.run_spec``: the
hand-written K1-instance kernel (``csrc/adamw.cu``) on a CUDA tensor, or
the K4 ring's adamw body at a ``lookahead`` other than 2.  The flatten
is a view and pads nothing where ``n`` is a multiple of ``cols`` (every
Yi-9B parameter), and the D streams split the rows without padding
(``resolve_config`` clamps D to divide them).  With no config given, the
op resolves explicit > tuned > planned > default on the blocked Traffic
(4 read and 3 write arrays), as the JAX op does.

On a CPU tensor, or with ``mode="ref"``, the body is evaluated at the
tensor's native shape, as the JAX ``ref`` branch does.

:func:`adamw_update_many` is what the optimizer runs: on the card every
leaf of one parameter dtype in a single launch of the same kernel
(``kernel.update_leaves``), in place, with the clip scale multiplying g
as the body's first operation, each leaf's weight decay from its own
entry of the kernel's leaf table, and the config resolved once a call
on the Traffic of the whole list.  Its plain version (CPU tensors, or
``mode="ref"``) runs the body leaf by leaf at each native shape, with
``g * gscale`` taken first, and copies the results into place.

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
from repro_torch.core.planner import Traffic
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common, cuda
from repro_torch.kernels.adamw import kernel, specs

__all__ = ["adamw_update", "adamw_update_many", "scalars"]

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


def _plain(p, g, m, v, s):
    """The elementwise body at the tensor's NATIVE shape (the spec's axes
    only describe the traversal, evaluate() never tiles): (p', m', v')."""
    spec = specs.adamw_spec(p.reshape(-1, p.shape[-1]) if p.ndim > 1
                            else p.reshape(1, -1), None, None, None)
    po, mo, vo = loopir.evaluate(spec, (p, g, m.float(), v.float(), *s))
    return po.to(p.dtype), mo, vo


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.0,
                 bc1=1.0, bc2=1.0, config: Optional[StridingConfig] = None,
                 mode: Optional[str] = None):
    """Fused AdamW for one parameter tensor. Returns (p', m', v'): p' in
    p's dtype, m' and v' in f32."""
    shape = p.shape
    n = p.numel()
    s = scalars(p.device, lr, b1, b2, eps, wd, bc1, bc2)
    rows, cols = _blocking(max(n, 1))
    # 4 read + 3 write arrays per stride: the write-stream cap applies
    traffic = Traffic(rows=rows, cols=cols, dtype=p.dtype,
                      read_arrays=4, write_arrays=3)
    cfg = common.resolve_for("adamw_update", p, config, rows, _DEFAULT,
                             traffic, mode)
    if common.kernel_mode(p, mode) == "ref":
        return _plain(p, g, m, v, s)
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


def adamw_update_many(ps, gs, ms, vs, wds, scalars, gscale=None,
                      config: Optional[StridingConfig] = None,
                      mode: Optional[str] = None) -> None:
    """Fused AdamW over the leaves ``ps`` (one parameter dtype, any
    shapes) with their gradients ``gs`` (p's dtype or f32) and f32
    moments ``ms``, ``vs``, **in place**: p, m and v are written where
    they were read.  ``scalars`` are the seven (lr, b1, b2, eps, wd,
    bc1, bc2), an f32 [7] tensor or a sequence of numbers or 0-d
    tensors; ``wds`` gives each leaf's weight decay (None: the scalars'
    wd for all); ``gscale``, a 0-d tensor on the leaves' device,
    multiplies g first (the clip scale; ``g.float() * gscale`` exactly).

    On the card one launch a :data:`kernel.TABLE_MAX` leaves, at the
    config resolved once on the Traffic of the whole list (explicit >
    tuned > planned > default); a ``lookahead`` other than 2 runs each
    leaf through :func:`adamw_update` (the K4 ring's adamw body) and
    copies it into place.  A leaf that is not contiguous or not 16-byte
    aligned makes it raise (``kernel.check_leaves``)."""
    if not ps:
        return
    lead = ps[0]
    if isinstance(scalars, torch.Tensor):
        s7 = scalars.to(device=lead.device, dtype=torch.float32).reshape(7)
    else:
        s7 = cuda.f32_scalars(scalars, lead.device)
    rows, cols = _blocking(max(sum(p.numel() for p in ps), 1))
    run = common.kernel_mode(lead, mode)
    cfg = common.resolve_config(
        "adamw_update", (rows, cols), lead.dtype, config, None, _DEFAULT,
        traffic=None if config is not None else Traffic(
            rows=rows, cols=cols, dtype=lead.dtype, read_arrays=4,
            write_arrays=3),
        mode=run, device=lead.device)
    live = [i for i, p in enumerate(ps) if p.numel()]
    if run == "cuda" and cfg.lookahead == 2:
        kernel.update_leaves([ps[i] for i in live], [gs[i] for i in live],
                             [ms[i] for i in live], [vs[i] for i in live],
                             None if wds is None else [wds[i] for i in live],
                             s7, gscale, cfg)
        return
    sc = list(s7.unbind())
    with torch.no_grad():
        for i in live:
            p, g, m, v = ps[i], gs[i], ms[i], vs[i]
            if gscale is not None:
                g = g.float() * gscale
            s = sc if wds is None else sc[:4] + [torch.full(
                (), float(wds[i]), dtype=torch.float32,
                device=lead.device)] + sc[5:]
            if run == "ref":
                po, mo, vo = _plain(p, g, m, v, s)
            else:
                po, mo, vo = adamw_update(p, g, m, v, *s, config=cfg)
            p.copy_(po)
            m.copy_(mo)
            v.copy_(vo)
