"""Wrapper for multi-strided flash-decode attention.

Lowers the family's ``TraversalSpec`` (``specs.py``) through
``repro_torch.codegen.run_spec`` — on a CUDA tensor the hand-written
split-KV kernel pair (``kernel.py``), on a CPU tensor or with
``mode="ref"`` the plain version.  ``kv_len`` masking rides a validity
row stream (the ``masked=True`` spec variant).

With no config given, D resolves explicit > tuned > planned > default
on the cache's Traffic (S rows of Hkv·dh, K and V read), as the JAX op
does, clamped to divide S.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.codegen import run_spec
from repro_torch.core.planner import Traffic
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.decode_attn import specs

_DEFAULT = StridingConfig(stride_unroll=4, portion_unroll=1)


def _flatten(q, kc, vc):
    b, hq = q.shape[0], q.shape[1]
    s, hkv, dh = kc.shape[1], kc.shape[2], kc.shape[3]
    return (kc.reshape(b, s, hkv * dh), vc.reshape(b, s, hkv * dh),
            q.reshape(b, hq * dh))


def validity_mask(kv_len, b: int, s: int, device) -> torch.Tensor:
    """[B, S] f32 row stream: 1.0 where position < kv_len[b]."""
    kv_len = torch.as_tensor(kv_len, device=device)
    if kv_len.ndim == 0:
        kv_len = kv_len.expand(b)
    return (torch.arange(s, device=device)[None, :]
            < kv_len[:, None]).float()


def resolve(kc: torch.Tensor, config: Optional[StridingConfig] = None,
            mode: Optional[str] = None) -> StridingConfig:
    """The config decode attention runs at over the cache ``kc`` [B, S,
    Hkv, dh]: explicit > tuned > planned (S rows of Hkv·dh, K and V read)
    > default, D clamped to divide S."""
    s, hkv, dh = kc.shape[1:]
    traffic = Traffic(rows=s, cols=hkv * dh, dtype=kc.dtype, read_arrays=2)
    return common.resolve_for("decode_attn", kc, config, s, _DEFAULT,
                              traffic, mode)


def decode_attn(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                kv_len=None, config: Optional[StridingConfig] = None,
                mode: Optional[str] = None, with_lse: bool = False):
    """One-token GQA attention against a [B, S, Hkv, dh] KV cache.

    q: [B, Hq, dh] with heads grouped (hkv, g).  ``kv_len`` (scalar or
    [B]) masks positions >= kv_len.  Returns ``out`` [B, Hq, dh] in q's
    dtype, or ``(out, lse)`` with lse [B, Hq] f32 when ``with_lse``.
    """
    b, s, hkv, dh = kc.shape
    cfg = resolve(kc, config, mode)
    inputs = _flatten(q, kc, vc)
    if kv_len is not None:
        inputs += (validity_mask(kv_len, b, s, kc.device),)
    out, lse = run_spec(specs.decode_spec(hkv, dh, masked=kv_len is not None),
                        inputs, cfg, mode)
    out = out.reshape(q.shape).to(q.dtype)
    return (out, lse.reshape(b, q.shape[1])) if with_lse else out
