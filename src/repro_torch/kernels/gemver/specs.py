"""``TraversalSpec`` factories for the gemver family (paper §6.4).

  * ``gemver_outer_spec``    — Â = A + u1 v1ᵀ + u2 v2ᵀ: rank-1 row
    streams (the u vectors ride the same D-stream split as the matrix);
    the K1 template, ``csrc/gemver.cu``.
  * ``gemver_sum_spec``      — 1-D x+z, classified ``blocked``: the
    emitter tiles it into a ``[rows, 128·P]`` grid (§5.1.1) before the
    D-stream split; the K1 template, ``csrc/gemver.cu``.
  * ``gemver_mxv1_spec``     — β·(Aᵀy): pure stride-axis reduction (the
    affine +x lives in the composite wrapper — partials must stay
    linear to merge).
  * ``gemver_mxv1_sum_spec`` — β·(Aᵀy) AND its reduction Σⱼ in ONE
    sweep of A (``SumWithTotal`` finalizes both outputs from the single
    accumulated state).
  * ``gemver_mxv2_spec``     — w = α·(Ax): vector-axis reduction.

The last three have plain versions only: ``gemver_mxv1`` and
``gemver_mxv2`` run through the mxv family's kernels (``ops.py``), and
their own instances of K2 and K3 are still to port (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.codegen import Access, Axis, TraversalSpec
from repro_torch.codegen.combine import SumCombine
from repro_torch.kernels.mxv.specs import col_dot, row_dot

__all__ = ["gemver_outer_spec", "gemver_sum_spec", "gemver_mxv1_spec",
           "gemver_mxv1_sum_spec", "gemver_mxv2_spec", "SumWithTotal"]


def gemver_outer_spec(a, u1, v1, u2, v2) -> TraversalSpec:
    m, n = a.shape
    return TraversalSpec(
        name="gemver_outer",
        axes=(Axis("i", m), Axis("j", n)),
        reads=(Access("A", ("i", "j")),
               Access("u1", ("i",)), Access("v1", ("j",)),
               Access("u2", ("i",)), Access("v2", ("j",))),
        writes=(Access("o", ("i", "j")),),
        body=lambda env: (env["A"]
                          + env["u1"][..., None] * env["v1"][None, :]
                          + env["u2"][..., None] * env["v2"][None, :]),
    )


def gemver_sum_spec(x, z) -> TraversalSpec:
    """1-D x+z: classified ``blocked`` — the emitter tiles it into a
    ``[rows, 128·P]`` grid (§5.1.1) before the D-stream split."""
    n = x.shape[0]
    return TraversalSpec(
        name="gemver_sum",
        axes=(Axis("i", n),),
        reads=(Access("x", ("i",)), Access("z", ("i",))),
        writes=(Access("o", ("i",)),),
        body=lambda env: env["x"] + env["z"],
    )


def gemver_mxv1_spec(a, y, beta=0.0) -> TraversalSpec:
    """β·(Aᵀy): pure stride-axis reduction (the affine +x lives in the
    composite wrapper — partials must stay linear to merge)."""
    m, n = a.shape
    return TraversalSpec(
        name="gemver_mxv1",
        axes=(Axis("i", m, kind="reduction"), Axis("j", n)),
        reads=(Access("A", ("i", "j")), Access("y", ("i",))),
        writes=(Access("s", ("j",)),),
        scalars=("beta",),
        body=lambda env: env["beta"] * col_dot(env["y"], env["A"]),
    )


class SumWithTotal(SumCombine):
    """Sum reduction whose finalize ALSO emits the accumulated row's
    total — a *finalizing* single-state combinator: the fused gemver
    mxv1+sum sweep writes (s = βAᵀy, Σⱼ sⱼ) as two native outputs with
    distinct access maps (the vector row and an extent-1 free axis)."""

    name = "sum_with_total"
    finalizing = True

    def finalize(self, state):
        row = state[0]
        return row, row.sum(dim=-1, keepdim=True)


def gemver_mxv1_sum_spec(a, y, beta=0.0) -> TraversalSpec:
    """β·(Aᵀy) AND its reduction Σⱼ in ONE sweep of A: the stride-axis
    reduction accumulates the full-width row, ``SumWithTotal`` finalizes
    both outputs from that single state."""
    m, n = a.shape
    return TraversalSpec(
        name="gemver_mxv1_sum",
        axes=(Axis("i", m, kind="reduction"), Axis("j", n),
              Axis("t", 1)),
        reads=(Access("A", ("i", "j")), Access("y", ("i",))),
        writes=(Access("s", ("j",)), Access("ssum", ("t",))),
        scalars=("beta",),
        body=lambda env: env["beta"] * col_dot(env["y"], env["A"]),
        out_dtype=(torch.float32, torch.float32),
        reduce=SumWithTotal(),
        full_width=True,   # the total needs the whole accumulated row
    )


def gemver_mxv2_spec(a, x, alpha=0.0) -> TraversalSpec:
    m, n = a.shape
    return TraversalSpec(
        name="gemver_mxv2",
        axes=(Axis("i", m), Axis("j", n, kind="reduction")),
        reads=(Access("A", ("i", "j")), Access("x", ("j",))),
        writes=(Access("w", ("i",)),),
        scalars=("alpha",),
        body=lambda env: env["alpha"] * row_dot(env["A"], env["x"]),
    )
