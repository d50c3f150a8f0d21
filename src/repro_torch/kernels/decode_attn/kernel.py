"""The decode_attn instance of the K3 template as two CUDA kernels
(``csrc/decode_attn.cu``), replacing ``_emit_stream_reduction``
(``src/repro/codegen/emit.py:564``) with the online-softmax body.

The TPU kernel folds the D streams' partial states into one accumulator
across a row grid that runs in order; Hopper blocks run in no order, so
the D streams become independent blocks:

  * :func:`split` — pass 1, grid (B, Hkv · g / GC, D): each block reduces
    its segment to an online-softmax state ``(m, num, den)`` for GC query
    heads of one KV head (GC the largest of 8, 4, 3, 2, 1 dividing g), in
    a ``[B, D, ...]`` f32 scratch;
  * :func:`merge` — pass 2, grid (B, Hq): folds the D states in order
    k = 0 … D-1 with ``OnlineSoftmax.merge`` and finalizes
    ``(out, lse)``.

Each wrapper launches its kernel on CUDA tensors (or raises) and runs
its plain version on CPU tensors: the spec body over each segment, and
the combinator's own merge and finalize.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.codegen import OnlineSoftmax, loopir
from repro_torch.codegen.transforms import BlockPlan
from repro_torch.kernels import cuda

__all__ = ["SPLIT", "MERGE", "emit", "split", "merge", "split_plain",
           "merge_plain", "admits"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# decode_split_launch(dtype, g, dh, K, V, q, M, pm, pnum, pden,
#                     B, S, hkv, d, bm, scale, stream)
SPLIT = cuda.CudaKernel(
    "decode_attn", "decode_attn", "decode_split_launch",
    [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F])
# decode_merge_launch(pm, pnum, pden, out, lse, B, hq, dh, d, eps, stream)
MERGE = cuda.CudaKernel(
    "decode_attn_merge", "decode_attn", "decode_merge_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F])

_HEAD_DIMS = (16, 32, 64, 128)   # dh = 16 lanes * 1 dim, 32 lanes * (1, 2, 4)


def admits(g: int, dh: int) -> bool:
    """Whether the split kernel takes ``g`` query heads per KV head at
    head dim ``dh``: any ``g >= 1`` (a block keeps 8, 4, 3, 2 or 1 of
    them, ``decode_attn.cu`` ``group_chunk``), and ``dh`` in
    ``_HEAD_DIMS``."""
    return g >= 1 and dh in _HEAD_DIMS


def _check_split(spec, bp, arrays):
    K, V, q = arrays[:3]
    comb = spec.combine
    b, s, e = K.shape
    hq, dh = comb.groups, comb.vwidth
    if K.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attn kernel: unsupported dtype {K.dtype}")
    if V.shape != K.shape or V.dtype != K.dtype or q.dtype != K.dtype:
        raise TypeError("decode_attn kernel: K, V and q must share one "
                        "dtype and K, V one shape")
    if q.shape != (b, hq * dh) or e % dh or hq % (e // dh):
        raise ValueError(f"decode_attn kernel: q {tuple(q.shape)} does "
                         f"not fit K {tuple(K.shape)} with dh={dh}")
    hkv = e // dh
    if not admits(hq // hkv, dh):
        raise NotImplementedError(
            f"decode_attn kernel: g={hq // hkv}, dh={dh} not compiled "
            f"(any g >= 1, dh in {_HEAD_DIMS})")
    if len(arrays) > 3:
        M = arrays[3]
        if M.shape != (b, s) or M.dtype != torch.float32:
            raise TypeError("decode_attn kernel: mask must be [B, S] f32")
    for t in arrays:
        if t.device != K.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decode_attn kernel: operands must be "
                             "contiguous, 16-byte aligned and on one device")
    if s != bp.rows or s % bp.d or (s // bp.d) % bp.bm:
        raise ValueError(f"decode_attn kernel: S={s} does not split into "
                         f"d={bp.d} segments of bm={bp.bm}-row tiles")
    return b, s, hkv, hq, dh


def split_plain(spec: loopir.TraversalSpec, bp: BlockPlan, arrays):
    """Plain version of pass 1: the spec body over each whole segment."""
    seg = arrays[0].shape[1] // bp.d
    states = []
    for k in range(bp.d):
        env = {a.array: (x[:, k * seg:(k + 1) * seg]
                         if "s" in a.index else x)
               for a, x in zip(spec.reads, arrays)}
        states.append(spec.body(env))
    return tuple(torch.stack([st[i] for st in states], dim=1)
                 for i in range(3))


def merge_plain(comb: OnlineSoftmax, pm: torch.Tensor, pnum: torch.Tensor,
                pden: torch.Tensor):
    """Plain version of pass 2: the combinator's own merge and finalize."""
    b, d, hq = pm.shape
    state = comb.init([(b, hq), (b, hq * comb.vwidth), (b, hq)],
                      device=pm.device)
    for k in range(d):
        state = comb.merge(state, (pm[:, k], pnum[:, k], pden[:, k]))
    return comb.finalize(state)


def split(spec: loopir.TraversalSpec, bp: BlockPlan, arrays):
    """Pass 1: per-segment online-softmax states ``(m [B, D, Hq],
    num [B, D, Hq·dh], den [B, D, Hq])`` in f32."""
    K = arrays[0]
    if not K.is_cuda:
        return split_plain(spec, bp, arrays)
    d = bp.d
    b, s, hkv, hq, dh = _check_split(spec, bp, arrays)
    pm = torch.empty(b, d, hq, dtype=torch.float32, device=K.device)
    pnum = torch.empty(b, d, hq * dh, dtype=torch.float32, device=K.device)
    pden = torch.empty_like(pm)
    mask = arrays[3].data_ptr() if len(arrays) > 3 else None
    SPLIT(K.device, cuda.dtype_code(K.dtype), hq // hkv, dh,
          K.data_ptr(), arrays[1].data_ptr(), arrays[2].data_ptr(), mask,
          pm.data_ptr(), pnum.data_ptr(), pden.data_ptr(),
          b, s, hkv, d, bp.bm, 1.0 / dh ** 0.5)
    return pm, pnum, pden


def merge(comb: OnlineSoftmax, pm: torch.Tensor, pnum: torch.Tensor,
          pden: torch.Tensor):
    """Pass 2: fold the D states in order k = 0 … D-1 from the identity
    and finalize ``(out [B, Hq·dh], lse [B, Hq])`` in f32."""
    if not pm.is_cuda:
        return merge_plain(comb, pm, pnum, pden)
    b, d, hq = pm.shape
    if not (comb.with_lse and hq == comb.groups
            and pnum.shape == (b, d, hq * comb.vwidth)
            and pden.shape == pm.shape):
        raise ValueError("decode_attn merge: state shapes do not match "
                         "the combinator")
    for t in (pm, pnum, pden):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("decode_attn merge: states must be "
                             "contiguous f32")
    out = torch.empty(b, hq * comb.vwidth, dtype=torch.float32,
                      device=pm.device)
    lse = torch.empty(b, hq, dtype=torch.float32, device=pm.device)
    MERGE(pm.device, pm.data_ptr(), pnum.data_ptr(), pden.data_ptr(),
          out.data_ptr(), lse.data_ptr(), b, hq, comb.vwidth, d,
          float(comb.eps))
    return out, lse


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config=None):
    """Run the decode spec: ``(out [B, Hq·dh], lse [B, Hq])`` in f32."""
    del scalars
    comb = spec.combine
    if not (isinstance(comb, OnlineSoftmax) and comb.with_lse):
        raise NotImplementedError(f"{spec.name}: the decode kernel takes "
                                  "the OnlineSoftmax(with_lse) reduction")
    return merge(comb, *split(spec, bp, arrays))
