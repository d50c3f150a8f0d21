"""``TraversalSpec`` factories for the matrix-vector family.

  * ``mxv_spec``   — y = A @ x, the paper's mxv / gemvermxv2: vectorize
    j, stride-unroll i into D row streams of A, f32 accumulation across
    the columns (the K2 template; ``csrc/reduction.cu``).
  * ``mxv_t_spec`` — y = Aᵀ @ x, paper Listing 1 (gemvermxv1 / doitgen
    core): the *streamed* axis is reduced — D row streams of A (and of
    x, as rank-1 row streams) merge into one full-width accumulator
    (the K3 template with the "sum" combinator;
    ``csrc/stream_reduction.cu``).

The bodies are the plain versions of the kernels: f32 products summed
in f32, as the JAX package's ``jnp.dot(..., preferred_element_type=
float32)``.
"""
from __future__ import annotations

from repro_torch.codegen import Access, Axis, TraversalSpec

__all__ = ["mxv_spec", "mxv_t_spec", "row_dot", "col_dot"]


def row_dot(a, x):
    """Σ_j a[..., j] x[j] in f32 (any leading rows)."""
    return (a.float() * x.float()).sum(dim=-1)


def col_dot(x, a):
    """Σ_i x[i] a[i, ...] in f32 (any trailing columns)."""
    return (x.float()[:, None] * a.float()).sum(dim=0)


def mxv_spec(a, x) -> TraversalSpec:
    m, n = a.shape
    return TraversalSpec(
        name="mxv",
        axes=(Axis("i", m), Axis("j", n, kind="reduction")),
        reads=(Access("A", ("i", "j")), Access("x", ("j",))),
        writes=(Access("y", ("i",)),),
        body=lambda env: row_dot(env["A"], env["x"]),
    )


def mxv_t_spec(a, x) -> TraversalSpec:
    m, n = a.shape
    return TraversalSpec(
        name="mxv_t",
        axes=(Axis("i", m, kind="reduction"), Axis("j", n)),
        reads=(Access("A", ("i", "j")), Access("x", ("i",))),
        writes=(Access("y", ("j",)),),
        body=lambda env: col_dot(env["x"], env["A"]),
    )
