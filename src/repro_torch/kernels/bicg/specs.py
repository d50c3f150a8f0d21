"""``TraversalSpec`` factories for the bicg family.

  * ``bicg_q_spec`` — q = A p, vector-axis reduction (the mxv pattern):
    vectorize j, stride-unroll i into D row streams of A (the K2
    template; the same row-dot kernel as ``mxv``).
  * ``bicg_s_spec`` — s = rᵀA, *stride-axis* reduction: the streamed
    rows are themselves reduced, every stream's partial row of s merges
    across D streams and row steps (the mxv_t pattern: the K3 template
    with the "sum" combinator).
"""
from __future__ import annotations

from repro_torch.codegen import Access, Axis, TraversalSpec
from repro_torch.kernels.mxv.specs import col_dot, row_dot

__all__ = ["bicg_q_spec", "bicg_s_spec"]


def bicg_q_spec(a, p) -> TraversalSpec:
    m, n = a.shape
    return TraversalSpec(
        name="bicg_q",
        axes=(Axis("i", m), Axis("j", n, kind="reduction")),
        reads=(Access("A", ("i", "j")), Access("p", ("j",))),
        writes=(Access("q", ("i",)),),
        body=lambda env: row_dot(env["A"], env["p"]),
    )


def bicg_s_spec(a, r) -> TraversalSpec:
    """s = rᵀA: the reduction runs over the *streamed* rows — every
    stream's partial row of s merges across D streams and row steps."""
    m, n = a.shape
    return TraversalSpec(
        name="bicg_s",
        axes=(Axis("i", m, kind="reduction"), Axis("j", n)),
        reads=(Access("A", ("i", "j")), Access("r", ("i",))),
        writes=(Access("s", ("j",)),),
        body=lambda env: col_dot(env["r"], env["A"]),
    )
