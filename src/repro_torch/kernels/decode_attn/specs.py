"""``TraversalSpec`` factory for the decode-attention family.

ONE *stride-axis reduction* sweep over the KV cache (``b`` a batch grid
dim, the sequence axis split into D streams), reduced with the
paired-state :class:`~repro_torch.codegen.OnlineSoftmax` combinator, so
each block's (max, rescaled Σ softmax·V, rescaled Σ w) partial state
merges numerically-stably across the D streams and K/V are each read
exactly once.  The combinator's finalize ALSO emits the per-row
log-sum-exp as a second native output (its own ``Hq``-wide access map).

``masked=True`` adds a fourth read: a per-position validity row stream
``M`` (1.0 = attend, 0.0 = masked) riding the same D-stream split as
K/V — masked positions drop to ``NEG_INF = -1e30`` before the block max,
so fully-masked blocks are rescaled away by the online merge.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.codegen import (NEG_INF, Access, Axis, OnlineSoftmax,
                                 TraversalSpec)

__all__ = ["decode_spec"]


@functools.lru_cache(maxsize=None)
def decode_spec(hkv: int, dh: int, masked: bool = False):
    """Per-(Hkv, dh) single-pass spec factory (the head split is a
    static reshape inside the body).  The body emits the online-softmax
    partial state for its KV block."""

    def heads(block, rows):
        return block.reshape(block.shape[0], rows, hkv, dh)

    def scores(env, scale):
        kb = env["K"]
        b, rows = kb.shape[0], kb.shape[1]
        hq = env["q"].shape[-1] // dh
        g = hq // hkv
        q4 = env["q"].reshape(b, hkv, g, dh).float()
        k4 = heads(kb, rows).float()
        s4 = torch.einsum("bhgd,bshd->bhgs", q4, k4) * scale
        return s4.reshape(b, hq, rows)

    def spec(kc2, vc2, q2, *mask):
        b, s, e = kc2.shape
        hq = q2.shape[-1] // dh
        g = hq // hkv
        scale = 1.0 / (dh ** 0.5)

        def body(env):
            sc = scores(env, scale)                       # (B, Hq, rows)
            if masked:
                sc = torch.where(env["M"][:, None, :] > 0.5, sc, NEG_INF)
            m = sc.amax(dim=-1)                           # (B, Hq)
            w = torch.exp(sc - m[..., None])
            b_, rows = w.shape[0], w.shape[-1]
            v4 = heads(env["V"], rows).float()
            pv = torch.einsum("bhgs,bshd->bhgd",
                              w.reshape(b_, hkv, g, rows), v4)
            return (m, pv.reshape(b_, hq * dh), w.sum(dim=-1))

        reads = (Access("K", ("b", "s", "e")),
                 Access("V", ("b", "s", "e")),
                 Access("q", ("b", "f")))
        if masked:
            reads += (Access("M", ("b", "s")),)

        return TraversalSpec(
            name="decode_attn_masked" if masked else "decode_attn_spec",
            axes=(Axis("b", b, kind="batch"),
                  Axis("s", s, kind="reduction"), Axis("e", e),
                  Axis("f", hq * dh), Axis("z", hq * dh),
                  Axis("h", hq)),
            reads=reads,
            # two writes, two access maps: the attention row (Hq·dh
            # lanes) and the Hq-wide log-sum-exp row statistic — both
            # finalized from ONE accumulated online-softmax state
            writes=(Access("o", ("b", "z")), Access("lse", ("b", "h"))),
            body=body, out_dtype=(torch.float32, torch.float32),
            reduce=OnlineSoftmax(groups=hq, vwidth=dh, with_lse=True),
            full_width=True,
        )

    return spec
