"""``TraversalSpec`` factories for the stream micro-kernel family (paper
§4), as in the JAX package's ``kernels/stream/specs.py``.

  * ``copy_spec``  — streaming elementwise copy (D read streams + D
    strided store positions): the K1 template, ``csrc/stream.cu``; at a
    ``lookahead`` other than 2 the K4 ring, ``csrc/manual_ring.cu``
    (lookahead=1 = prefetch off).
  * ``triad_spec`` — STREAM triad a = b + αc (paper Table 1 class): K1,
    or K4 at ``lookahead != 2``.
  * ``read_spec``  — per-stream checksums: the wrapper reshapes the
    array to ``[D, seg·cols]`` so each of the D concurrent streams is
    one contiguous segment, and the spec reduces its vector axis: the
    K2 template, ``csrc/stream.cu`` (two passes over column chunks).
  * ``init_spec``  — fill via D strided store positions: a writes-only
    spec (no read streams); the scalar fill value broadcasts into the
    store stream.  K1, or K4 at ``lookahead != 2``.
"""
from __future__ import annotations

import torch

from repro_torch.codegen import Access, Axis, TraversalSpec

__all__ = ["copy_spec", "triad_spec", "read_spec", "init_spec"]


def copy_spec(x) -> TraversalSpec:
    rows, cols = x.shape
    return TraversalSpec(
        name="stream_copy",
        axes=(Axis("i", rows), Axis("j", cols)),
        reads=(Access("x", ("i", "j")),),
        writes=(Access("y", ("i", "j")),),
        body=lambda env: env["x"],
    )


def triad_spec(b, c, alpha=0.0) -> TraversalSpec:
    rows, cols = b.shape
    return TraversalSpec(
        name="stream_triad",
        axes=(Axis("i", rows), Axis("j", cols)),
        reads=(Access("b", ("i", "j")), Access("c", ("i", "j"))),
        writes=(Access("a", ("i", "j")),),
        scalars=("alpha",),
        body=lambda env: env["b"] + env["alpha"] * env["c"],
    )


def read_spec(x2) -> TraversalSpec:
    """Per-stream checksums over ``x2 = x.reshape(D, seg*cols)``: the
    stride axis is the stream index itself (one row per stream), so the
    D-way stride split gives the D concurrent segment streams."""
    d, w = x2.shape
    return TraversalSpec(
        name="stream_read",
        axes=(Axis("k", d), Axis("j", w, kind="reduction")),
        reads=(Access("x", ("k", "j")),),
        writes=(Access("y", ("k",)),),
        body=lambda env: env["x"].float().sum(dim=-1),
        out_dtype=torch.float32,
    )


def init_spec(shape, dtype, value=0.0) -> TraversalSpec:
    """Fill: zero read streams, one store stream; the body's scalar
    result is broadcast into the output blocks."""
    rows, cols = shape
    return TraversalSpec(
        name="stream_init",
        axes=(Axis("i", rows), Axis("j", cols)),
        reads=(),
        writes=(Access("y", ("i", "j")),),
        scalars=("value",),
        body=lambda env: env["value"],
        out_dtype=dtype,
    )
