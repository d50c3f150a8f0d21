"""``TraversalSpec`` factory for the rmsnorm family.

A ``full_width`` streaming nest (the K1 template): the body takes a
per-row mean over the whole vector extent and emits the f32 inverse-rms
row statistic as a native rank-1 SECOND output next to the rank-2
normalized matrix (per-output access maps).  The CUDA kernel
(``csrc/rmsnorm.cu``) computes the same body per stream row.
"""
from __future__ import annotations

import torch

from repro_torch.codegen import Access, Axis, TraversalSpec

__all__ = ["rmsnorm_spec"]


def _rms_body(env):
    xf = env["x"].float()
    inv = 1.0 / torch.sqrt((xf * xf).mean(dim=-1) + env["eps"])
    return (xf * inv[..., None]) * env["w"].float(), inv


def rmsnorm_spec(x, w, eps=0.0) -> TraversalSpec:
    t, dm = x.shape
    return TraversalSpec(
        name="rmsnorm",
        axes=(Axis("i", t), Axis("j", dm)),
        reads=(Access("x", ("i", "j")), Access("w", ("j",))),
        # the inverse-rms row statistic is a native rank-1 second output
        writes=(Access("o", ("i", "j")), Access("r", ("i",))),
        scalars=("eps",),
        body=_rms_body,
        out_dtype=(x.dtype, torch.float32),
        full_width=True,   # the per-row mean needs the whole row
    )
