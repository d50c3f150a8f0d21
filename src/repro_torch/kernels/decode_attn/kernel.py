"""The decode_attn instance of the K3 template as a CUDA kernel
(``csrc/decode_attn.cu``), replacing ``_emit_stream_reduction``
(``src/repro/codegen/emit.py:564``) with the online-softmax body,
redesigned for Hopper: TMA rings of 64-row K / V tiles, masked tiles
never loaded, bf16 scores on the tensor cores (``mma.sync``), P·V in f32.

The TPU kernel folds the D streams' partial states into one accumulator
across a row grid that runs in order; Hopper blocks run in no order, so
the sequence is cut into chunks that blocks take in parallel:

  * the spec's D segments are cut into 64-row units, unit
    ``u = t·D + k`` being tile t of segment k, so a block's contiguous
    run of units walks all D segments at once (the paper's D streams);
    :func:`plan_chunks` cuts the units into C chunks from the SM count,
    so even one batch row fills the card;
  * :func:`split` — one block per (chunk, GC query heads of a KV head,
    batch row) reduces its chunk to an online-softmax state ``(m, num,
    den)`` in a ``[B, C, ...]`` f32 scratch (GC the largest divisor of g
    up to 16);
  * :func:`merge` — a second launch folds the C states in order c = 0 …
    C-1 with ``OnlineSoftmax.merge`` and finalizes ``(out, lse)``.

K and V may be a slice ``[:, j·S/K:(j+1)·S/K]`` of a longer cache's
sequence (a shard of the sequence-sharded decode): the kernel reads it in
place, its batch rows :func:`batch_pitch` rows apart.

A chunk with no valid row has the identity state ``(-1e30, 0, 0)``,
unless its whole batch row has none: then it has the spec's all-masked
state ``(-1e30, Σ V, rows)``, so the fold returns the spec's mean of V.

Each wrapper launches its kernel on CUDA tensors (or raises) and runs
its plain version on CPU tensors: the spec body over each chunk's rows
with the same chunking and identity rule, and the combinator's own
merge and finalize in the same order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.codegen import NEG_INF, OnlineSoftmax, loopir
from repro_torch.codegen.transforms import BlockPlan
from repro_torch.kernels import cuda

__all__ = ["SPLIT", "MERGE", "TILE", "WAVES", "MAX_UNITS", "emit", "split",
           "merge", "split_plain", "merge_plain", "admits", "batch_pitch",
           "group_chunk", "plan_chunks", "split_smem", "smem_of"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# decode_split_launch(dtype, g, dh, K, V, q, M, pm, pnum, pden, B, S,
#                     pitch, hkv, d, upb, chunks, scale, eps, stream)
SPLIT = cuda.CudaKernel(
    "decode_attn", "decode_attn", "decode_split_launch",
    [_I, _I, _I, *[_P] * 7, _I, _I, _I, _I, _I, _I, _I, _F, _F])
# decode_merge_launch(pm, pnum, pden, out, lse, B, hq, dh, chunks, eps,
#                     stream)
MERGE = cuda.CudaKernel(
    "decode_attn_merge", "decode_attn", "decode_merge_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F])

TILE = 64                 # rows of a unit (csrc/decode_attn.cu TROWS)
WAVES = 2                 # blocks planned per SM (plan_chunks): one wave
MAX_UNITS = 16            # units a chunk takes at most (plan_chunks)
_PLAIN_SMS = 132          # the chunking of the plain version on a CPU
_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)


def admits(g: int, dh: int) -> bool:
    """Whether the kernel takes ``g`` query heads per KV head at head dim
    ``dh``: any ``g >= 1`` (a block keeps :func:`group_chunk` of them),
    and ``dh`` in ``_HEAD_DIMS``."""
    return g >= 1 and dh in _HEAD_DIMS


def group_chunk(g: int) -> int:
    """The query heads a block keeps: the largest divisor of ``g`` up to
    16 (one or two 8-head ``mma`` tiles, zero-padded)."""
    return next(c for c in range(min(g, 16), 0, -1) if g % c == 0)


def split_smem(itemsize: int, dh: int, g: int) -> int:
    """Dynamic shared memory of the split's instance for ``g`` query
    heads a KV head at head dim ``dh`` (``csrc/decode_attn.cu``
    ``Cfg<T, DH, NT>::SMEM``, NT = ⌈GC / 8⌉): 1024 bytes of alignment
    slack, the K and V TMA rings (as many stages of a 64-row tile as
    fit 96 KiB, 2 to 4), each of the 4 consumer warps' P [16][8·NT + 4]
    and alpha [8·NT] in f32, and the f32 query heads where the scores
    are not on the tensor cores (f32)."""
    gp = 8 * -(-group_chunk(g) // 8)
    tile_b = TILE * dh * itemsize
    stages = min(max(98304 // (2 * tile_b), 2), 4)
    return (1024 + stages * 2 * tile_b + 4 * (16 * (gp + 4) + gp) * 4
            + (0 if itemsize == 2 else gp * dh * 4))


def smem_of(spec: loopir.TraversalSpec, bp: BlockPlan, config,
            dtype: torch.dtype, sms: int) -> int:
    """Dynamic shared memory :func:`split` requests for ``spec`` (the
    static verifier's RES001; the merge takes none): 0 for a type or a
    head shape no instance takes (the launcher refuses those by type)."""
    comb = spec.combine
    dh = comb.vwidth
    hkv = spec.axis("e").extent // dh
    g = comb.groups // max(hkv, 1)
    if dtype not in (torch.float32, torch.bfloat16) or not admits(g, dh):
        return 0
    return split_smem(dtype.itemsize, dh, g)


def plan_chunks(b: int, s: int, d: int, hkv: int, g: int,
                sms: int) -> tuple[int, int]:
    """``(units per chunk, chunks)``: the ``d·⌈(s/d)/64⌉`` units of a
    batch row cut into contiguous chunks, none empty: as many as make
    ``b·hkv·g/GC`` blocks a chunk about :data:`WAVES` blocks per SM, and
    at least as many as keep a chunk within :data:`MAX_UNITS` units, so
    that the heaviest batch rows of a long cache do not leave a tail of
    busy blocks."""
    units = d * -(-(s // d) // TILE)
    pairs = b * hkv * (g // group_chunk(g))
    c = min(units, max(1, WAVES * sms // pairs, -(-units // MAX_UNITS)))
    upb = -(-units // c)
    return upb, -(-units // upb)


def _chunk_rows(s: int, d: int, upb: int, c: int) -> torch.Tensor:
    """The rows of chunk ``c``, unit by unit, in the kernel's order."""
    seg = s // d
    units = d * -(-seg // TILE)
    rows = []
    for u in range(c * upb, min(units, (c + 1) * upb)):
        t, k = divmod(u, d)
        rows.extend(range(k * seg + t * TILE,
                          k * seg + min(seg, (t + 1) * TILE)))
    return torch.tensor(rows, dtype=torch.long)


def batch_pitch(K: torch.Tensor, V: torch.Tensor) -> int:
    """The rows between two batch rows of K and V ``[B, S, E]``: S for a
    contiguous cache, more for a slice ``[:, j·S/K:(j+1)·S/K]`` of a
    longer one, which the kernel reads in place.  Raises unless each row
    of E elements is dense, the rows of a batch row follow one another,
    the batch stride is a whole number of rows of at least S, and K and
    V share their strides."""
    b, s, e = K.shape
    if V.stride() != K.stride() or K.stride(2) != 1 or K.stride(1) != e:
        raise ValueError("decode_attn kernel: K and V must share strides, "
                         "with rows of Hkv·dh elements dense and one "
                         "after another")
    if b == 1:
        return s
    pitch, rem = divmod(K.stride(0), e)
    if rem or pitch < s:
        raise ValueError(f"decode_attn kernel: batch stride {K.stride(0)} "
                         f"is not a whole number of rows of {e} at least "
                         f"S={s} rows")
    return pitch


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
    pitch = batch_pitch(K, V)
    for t in arrays:
        dense = t.is_contiguous() or t is K or t is V
        if t.device != K.device or not dense or t.data_ptr() % 16:
            raise ValueError("decode_attn kernel: operands must be "
                             "contiguous (K and V: rows dense, batch rows "
                             "at a pitch), 16-byte aligned and on one "
                             "device")
    if s != bp.rows or s % bp.d:
        raise ValueError(f"decode_attn kernel: S={s} does not split into "
                         f"d={bp.d} segments")
    return b, s, pitch, hkv, hq, dh


def split_plain(spec: loopir.TraversalSpec, bp: BlockPlan, arrays,
                sms: int = _PLAIN_SMS):
    """Plain version of the split: the spec body over each chunk's rows
    (the kernel's chunking for ``sms`` SMs), and the identity state for
    an all-masked chunk of a batch row that has a valid position."""
    K, V, q = arrays[:3]
    b, s, e = K.shape
    comb = spec.combine
    hq, dh = comb.groups, comb.vwidth
    upb, chunks = plan_chunks(b, s, bp.d, e // dh, hq // (e // dh), sms)
    masked = len(arrays) > 3
    row_any = (arrays[3] > 0.5).any(1) if masked else None
    states = []
    for c in range(chunks):
        idx = _chunk_rows(s, bp.d, upb, c).to(K.device)
        env = {a.array: (x.index_select(1, idx) if "s" in a.index else x)
               for a, x in zip(spec.reads, arrays)}
        m, num, den = spec.body(env)
        if masked:
            ident = (~(env["M"] > 0.5).any(1) & row_any)[:, None]
            m = torch.where(ident, NEG_INF, m)
            num, den = num.masked_fill(ident, 0.0), den.masked_fill(ident, 0.0)
        states.append((m, num, den))
    return tuple(torch.stack([st[i] for st in states], dim=1)
                 for i in range(3))


def merge_plain(comb: OnlineSoftmax, pm: torch.Tensor, pnum: torch.Tensor,
                pden: torch.Tensor):
    """Plain version of the fold: the combinator's own merge, c = 0 …
    C-1 from the identity, and finalize."""
    b, c, hq = pm.shape
    state = comb.init([(b, hq), (b, hq * comb.vwidth), (b, hq)],
                      device=pm.device)
    for k in range(c):
        state = comb.merge(state, (pm[:, k], pnum[:, k], pden[:, k]))
    return comb.finalize(state)


def split(spec: loopir.TraversalSpec, bp: BlockPlan, arrays):
    """The split alone: per-chunk online-softmax states ``(m [B, C, Hq],
    num [B, C, Hq·dh], den [B, C, Hq])`` in f32."""
    if not arrays[0].is_cuda:
        return split_plain(spec, bp, arrays)
    K = arrays[0]
    b, s, pitch, hkv, hq, dh = _check_split(spec, bp, arrays)
    g = hq // hkv
    sms = torch.cuda.get_device_properties(K.device).multi_processor_count
    upb, chunks = plan_chunks(b, s, bp.d, hkv, g, sms)
    f32 = dict(dtype=torch.float32, device=K.device)
    pm = torch.empty(b, chunks, hq, **f32)
    pnum = torch.empty(b, chunks, hq * dh, **f32)
    pden = torch.empty_like(pm)
    mask = arrays[3].data_ptr() if len(arrays) > 3 else None
    SPLIT(K.device, cuda.dtype_code(K.dtype), g, dh, K.data_ptr(),
          arrays[1].data_ptr(), arrays[2].data_ptr(), mask, pm.data_ptr(),
          pnum.data_ptr(), pden.data_ptr(), b, s, pitch, hkv, bp.d, upb,
          chunks, 1.0 / dh ** 0.5, float(spec.combine.eps))
    return pm, pnum, pden


def merge(comb: OnlineSoftmax, pm: torch.Tensor, pnum: torch.Tensor,
          pden: torch.Tensor):
    """The fold as its own launch: the C states in order c = 0 … C-1
    from the identity, finalized to ``(out [B, Hq·dh], lse [B, Hq])``
    in f32."""
    if not pm.is_cuda:
        return merge_plain(comb, pm, pnum, pden)
    b, c, hq = pm.shape
    if not (comb.with_lse and hq == comb.groups
            and pnum.shape == (b, c, hq * comb.vwidth)
            and pden.shape == pm.shape):
        raise ValueError("decode_attn merge: state shapes do not match "
                         "the combinator")
    for t in (pm, pnum, pden):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("decode_attn merge: states must be "
                             "contiguous, 16-byte aligned f32")
    out = torch.empty(b, hq * comb.vwidth, dtype=torch.float32,
                      device=pm.device)
    lse = torch.empty(b, hq, dtype=torch.float32, device=pm.device)
    MERGE(pm.device, pm.data_ptr(), pnum.data_ptr(), pden.data_ptr(),
          out.data_ptr(), lse.data_ptr(), b, hq, comb.vwidth, c,
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
