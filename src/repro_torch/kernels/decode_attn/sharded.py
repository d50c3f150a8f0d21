"""Sequence-sharded flash-decode: a K-way split of the KV cache's
sequence, merged with the online-softmax identity (the port of
``src/repro/kernels/decode_attn/sharded.py``).

Each shard runs the ordinary multi-strided decode kernel over its slice
of the sequence and returns ``(out, lse)``, the
``OnlineSoftmax(with_lse=True)`` side output.  Partials merge exactly:

    m   = max_k lse_k
    w_k = exp(lse_k - m)
    out = sum_k w_k * out_k / sum_k w_k
    lse = m + log sum_k w_k

A shard whose slice lies wholly beyond ``kv_len`` sees an all-masked
score row: its lse is about -1e30, so its weight underflows to exactly 0
and its output never contributes.

Two strategies share the math:

  * :func:`decode_attn_sharded`, the static split on one device: K
    kernel calls, each on a slice of the whole cache read in place (the
    kernel takes the slice's batch pitch; no slice is copied), merged by
    :func:`merge_partials`.  It is the conformance oracle for the
    collective one.
  * :func:`decode_attn_collective`, the port of ``decode_attn_shard_map``:
    each rank of the ``MeshCtx``'s model axis holds only its
    ``[B, S/K, Hkv, dh]`` slice of the cache, runs the kernel on it, and
    the merge runs as ``all_reduce`` (MAX of the lse, then one SUM of
    ``w`` and ``w·out`` packed in f32) over that axis's process group.
    A one-rank axis (or no ctx) is the unsharded op.

:func:`merge_partials` is plain PyTorch, as the JAX one is ``jnp``
outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attn import ops

__all__ = ["merge_partials", "decode_attn_sharded", "decode_attn_collective",
           "collective", "dispatch"]


def merge_partials(outs: torch.Tensor, lses: torch.Tensor):
    """Merge per-shard flash-decode partials.

    outs: [K, B, Hq, dh]; lses: [K, B, Hq].  Returns (out [B, Hq, dh] in
    the outs' dtype, lse [B, Hq] f32).
    """
    lses = lses.float()
    m = lses.amax(dim=0)
    w = torch.exp(lses - m[None])                    # [K, B, Hq]
    den = w.sum(dim=0)
    num = (w[..., None] * outs.float()).sum(dim=0)
    out = num / den[..., None]
    return out.to(outs.dtype), m + torch.log(den)


def _vec_kv_len(kv_len, b: int, s: int, device) -> torch.Tensor:
    """``kv_len`` (None: all ``s`` rows; a scalar; or [B]) as a [B] long
    tensor on ``device``."""
    kv_len = torch.as_tensor(s if kv_len is None else kv_len, device=device)
    return kv_len.long().expand(b) if kv_len.ndim == 0 else kv_len.long()


def decode_attn_sharded(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                        kv_len=None, shards: int = 1, config=None,
                        mode: Optional[str] = None, with_lse: bool = False):
    """K-way static sequence split of ``decode_attn`` on one device.

    q: [B, Hq, dh]; kc/vc: [B, S, Hkv, dh]; S must divide by ``shards``.
    Shard j attends to ``kc[:, j·S/K:(j+1)·S/K]`` in place with
    ``kv_len`` clipped to its slice.  ``shards <= 1`` is the unsharded
    op unchanged.
    """
    s = kc.shape[1]
    if shards <= 1:
        return ops.decode_attn(q, kc, vc, kv_len=kv_len, config=config,
                               mode=mode, with_lse=with_lse)
    if s % shards:
        raise ValueError(f"sequence {s} not divisible by {shards} shards")
    sp = s // shards
    kv_len = _vec_kv_len(kv_len, q.shape[0], s, kc.device)
    outs, lses = [], []
    for j in range(shards):
        local = (kv_len - j * sp).clamp(0, sp)
        o, lse = ops.decode_attn(q, kc[:, j * sp:(j + 1) * sp],
                                 vc[:, j * sp:(j + 1) * sp], kv_len=local,
                                 config=config, mode=mode, with_lse=True)
        outs.append(o)
        lses.append(lse)
    out, lse = merge_partials(torch.stack(outs), torch.stack(lses))
    out = out.to(q.dtype)
    return (out, lse) if with_lse else out


def decode_attn_collective(q: torch.Tensor, kc_local: torch.Tensor,
                           vc_local: torch.Tensor, kv_len=None, ctx=None,
                           config=None, mode: Optional[str] = None):
    """Flash-decode over a sequence-sharded KV cache across the ranks of
    ``ctx``'s model axis.

    Every rank passes the same q [B, Hq, dh] and global ``kv_len``, and
    its own ``[B, S/K, Hkv, dh]`` slice (rank r holds rows [r·S/K,
    (r+1)·S/K) of the sequence).  Each runs the kernel on its slice with
    the rank-local ``kv_len``; the merge is ``all_reduce`` over the
    axis's group, so every rank returns the same out [B, Hq, dh].  With
    no ctx or a one-rank axis this IS the unsharded op.
    """
    n = ctx.tp if ctx is not None else 1
    if n <= 1:
        return ops.decode_attn(q, kc_local, vc_local, kv_len=kv_len,
                               config=config, mode=mode)
    import torch.distributed as dist
    group = ctx.tp_group
    sp = kc_local.shape[1]
    kv_len = _vec_kv_len(kv_len, q.shape[0], sp * n, kc_local.device)
    local = (kv_len - ctx.tp_rank * sp).clamp(0, sp)
    o, lse = ops.decode_attn(q, kc_local, vc_local, kv_len=local,
                             config=config, mode=mode, with_lse=True)
    m = lse.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse - m)[..., None]                # [B, Hq, 1]
    packed = torch.cat([w * o.float(), w], dim=-1)   # num | den
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=group)
    num, den = packed[..., :-1], packed[..., -1:]
    return (num / den).to(q.dtype)


def collective(ctx, shards: int) -> bool:
    """Whether ``ctx``'s model axis is exactly ``shards`` ranks wide, so
    that a ``shards``-way decode runs :func:`decode_attn_collective` on
    rank-local caches (else the static split on whole caches)."""
    mesh = getattr(ctx, "mesh", None)
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return (shards > 1 and mesh is not None and ctx.tp_axis in names
            and ctx.tp == shards)


def dispatch(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
             kv_len=None, shards: int = 1, ctx=None, config=None,
             mode: Optional[str] = None) -> torch.Tensor:
    """Pick the strategy for a K-sharded decode: the collective merge
    when ``ctx``'s model axis is exactly ``shards`` wide (kc, vc are then
    the rank's slices), else the static split of whole caches, which
    serves the same numbers on one device."""
    if collective(ctx, shards):
        return decode_attn_collective(q, kc, vc, kv_len=kv_len, ctx=ctx,
                                      config=config, mode=mode)
    return decode_attn_sharded(q, kc, vc, kv_len=kv_len, shards=shards,
                               config=config, mode=mode)
