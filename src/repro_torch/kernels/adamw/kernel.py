"""The adamw_update instance of the K1 template as a CUDA kernel
(``csrc/adamw.cu``), replacing ``_emit_streaming``
(``src/repro/codegen/emit.py:410``) with the adamw body.

The kernel updates a list of leaves (p, g, m, v) in one launch, on
``csrc/common.cuh``'s flat walk over the virtual concatenation of the
leaves' 16-byte vectors of p (:func:`leaf_first`, :func:`leaf_geometry`):
every leaf starts on a whole unit of 128 vectors, the D segments cut the
whole range, and each unit finds its leaf in a table of at most
:data:`TABLE_MAX` leaves in the kernel's parameter space.  A leaf's
ragged end is masked in the kernel.  :func:`update_leaves` runs it in
place, with a clip scale multiplying g first where one is given;
:func:`emit`, the per-tensor op's K1 instance, runs it on a list of one
leaf (the op's ``[rows, cols]`` tiles) out of place, and on CPU tensors
runs the kernel's plain version, the spec through ``loopir.evaluate``.
The kernel stores p' in p's dtype (one rounding of the body's f32 p'),
m' and v' in f32.
"""
from __future__ import annotations

import bisect
import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import LANE, BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["ADAMW", "TABLE_MAX", "HELD", "leaf_first", "leaf_of",
           "leaf_geometry", "check_leaves", "update_leaves", "emit"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# adamw_launch(dtype, gdtype, n, ptrs, ns, wds, first, s, gscale, po, mo,
#              vo, segv, d, np, interleaved, stream)
ADAMW = cuda.CudaKernel("adamw_update", "adamw", "adamw_launch",
                        [_I, _I, _I, *[_P] * 9, _L, _I, _I, _I])

TABLE_MAX = 512         # leaves of one launch's table (csrc/adamw.cu)
HELD = 2                # units a thread holds at once (csrc/adamw.cu)


def leaf_first(numels: Sequence[int], vec: int) -> list[int]:
    """Each leaf's first unit of :data:`cuda.WALK_UNIT` vectors of ``vec``
    elements in the virtual range, and the range's end: a leaf of ``n``
    elements takes ``ceil(ceil(n / vec) / 128)`` whole units."""
    first = [0]
    for n in numels:
        first.append(first[-1] + -(-(-(-n // vec)) // cuda.WALK_UNIT))
    return first


def leaf_of(first: Sequence[int], unit: int) -> int:
    """The leaf a unit of the range lies in (the kernel's binary search:
    the last leaf whose first unit is at or before ``unit``)."""
    return bisect.bisect_right(first, unit, 0, len(first) - 1) - 1


def leaf_geometry(numels: Sequence[int], itemsize: int, d: int,
                  p: int) -> tuple[list[int], cuda.WalkGeometry]:
    """``(first, walk)`` of one launch over leaves of ``numels`` elements
    of p's ``itemsize``: the D segments are whole units each
    (``ceil(units / D)·128`` vectors), P units a block a step."""
    vec = 16 // itemsize
    first = leaf_first(numels, vec)
    segv = -(-first[-1] // d) * cuda.WALK_UNIT
    return first, cuda.walk_geometry(segv, d, p, itemsize, held=HELD)


def check_leaves(name: str, ps, gs, ms, vs) -> None:
    """Refuse what the kernel does not take: p of a type with no
    instance, or of types that differ along the list; g of another type
    than p's or f32, or of types that differ; m or v not f32
    (``TypeError``); an operand with another element count than its p,
    not contiguous, on another device or not 16-byte aligned
    (``ValueError``).  There is no copying fallback."""
    pt, gt = ps[0].dtype, gs[0].dtype
    if pt not in cuda.DTYPES or gt not in (pt, torch.float32):
        raise TypeError(f"{name} kernel: p of {pt} with g of {gt} has no "
                        "instance (p f32, bf16 or f16; g p's type or f32)")
    dev = ps[0].device
    for p, g, m, v in zip(ps, gs, ms, vs):
        if (p.dtype, g.dtype, m.dtype, v.dtype) != (pt, gt, torch.float32,
                                                    torch.float32):
            raise TypeError(f"{name} kernel: every leaf must be p {pt}, g "
                            f"{gt}, m and v f32; got {p.dtype}, {g.dtype}, "
                            f"{m.dtype}, {v.dtype}")
        for t in (p, g, m, v):
            if t.numel() != p.numel():
                raise ValueError(f"{name} kernel: a leaf's g, m, v must have "
                                 f"its p's {p.numel()} elements, got "
                                 f"{t.numel()}")
            if (t.device != dev or not t.is_contiguous()
                    or t.data_ptr() % 16):
                raise ValueError(f"{name} kernel: every operand must be "
                                 "contiguous, 16-byte aligned and on "
                                 f"{dev}")


def _launch(ps, gs, ms, vs, wds, s: torch.Tensor,
            gscale: Optional[torch.Tensor], d: int, p: int,
            interleaved: bool, out=None) -> None:
    """One launch over at most :data:`TABLE_MAX` checked leaves."""
    n = len(ps)
    first, g = leaf_geometry([t.numel() for t in ps], ps[0].element_size(),
                             d, p)
    ptrs = (_L * (4 * n))(*(t.data_ptr() for leaf in zip(ps, gs, ms, vs)
                            for t in leaf))
    ns = (_L * n)(*(t.numel() for t in ps))
    wd = None if wds is None else (ctypes.c_float * n)(*map(float, wds))
    po, mo, vo = (None, None, None) if out is None else (
        t.data_ptr() for t in out)
    ADAMW(ps[0].device, cuda.dtype_code(ps[0].dtype),
          cuda.dtype_code(gs[0].dtype), n, ptrs, ns, wd,
          (_I * (n + 1))(*first), s.data_ptr(),
          None if gscale is None else gscale.data_ptr(), po, mo, vo,
          g.segv, g.d, g.units, int(interleaved))


def update_leaves(ps, gs, ms, vs, wds, s: torch.Tensor,
                  gscale: Optional[torch.Tensor], config: StridingConfig,
                  name: str = "adamw_update") -> None:
    """Update the (non-empty) leaves in place on the card, one launch per
    :data:`TABLE_MAX` of them: ``s`` the f32 [7] scalars, ``wds`` each
    leaf's weight decay (None: ``s``'s), ``gscale`` a 0-d f32 tensor
    multiplying g first (or None)."""
    check_leaves(name, ps, gs, ms, vs)
    if gscale is not None and (gscale.dtype != torch.float32
                               or gscale.numel() != 1
                               or gscale.device != ps[0].device):
        raise ValueError(f"{name} kernel: gscale must be one f32 on "
                         f"{ps[0].device}")
    interleaved = config.arrangement == "interleaved"
    for i in range(0, len(ps), TABLE_MAX):
        cut = slice(i, i + TABLE_MAX)
        _launch(ps[cut], gs[cut], ms[cut], vs[cut],
                None if wds is None else wds[cut], s, gscale,
                config.stride_unroll, config.portion_unroll, interleaved)


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig | None = None):
    """Run the adamw spec on its ``[rows, cols]`` tiles: ``(p', m', v')``,
    one leaf out of place, D = the plan's D, P = its ``bn / 128``."""
    p, g, m, v = arrays
    if not p.is_cuda:
        return loopir.evaluate(spec, list(arrays) + list(scalars))
    shape = (bp.rows, bp.cols)
    cuda.check_operands(spec.name, [p, g], [shape, shape])
    cuda.check_operands(spec.name, [m, v], [shape, shape])
    if m.dtype != torch.float32 or m.device != p.device:
        raise TypeError(f"{spec.name} kernel: m and v must be f32 on "
                        f"{p.device}, got {m.dtype} on {m.device}")
    s = cuda.f32_scalars(scalars, p.device)    # [7] on the card
    out = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
    _launch([p], [g], [m], [v], None, s, None, bp.d, bp.bn // LANE,
            config is not None and config.arrangement == "interleaved", out)
    return out
