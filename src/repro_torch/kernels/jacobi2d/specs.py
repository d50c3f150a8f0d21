"""``TraversalSpec`` factory for the jacobi2d family, as in the JAX
package's ``kernels/jacobi2d/specs.py``.

One 5-point Jacobi sweep over the interior: the read carries a
((1,1),(1,1)) halo and the body averages the centre plus the four
``tap``-shifted neighbours in f32, summed in the order
``0.2 * (c + l + r + u + b)``.  The K1 template lowers it with one-row
blocks (a row halo needs ``bm == 1``), each of the D row streams
loading its three tap rows: ``csrc/stencil.cu``.
"""
from __future__ import annotations

from repro_torch.codegen import Access, Axis, TraversalSpec, tap

__all__ = ["jacobi_spec", "JAC_HALO"]

JAC_HALO = ((1, 1), (1, 1))


def _jacobi_body(env):
    x = env["x"].float()
    c = tap(x, JAC_HALO, 0, 0)
    l = tap(x, JAC_HALO, 0, -1)
    r = tap(x, JAC_HALO, 0, +1)
    u = tap(x, JAC_HALO, -1, 0)
    b = tap(x, JAC_HALO, +1, 0)
    return 0.2 * (c + l + r + u + b)


def jacobi_spec(x) -> TraversalSpec:
    h, w = x.shape
    return TraversalSpec(
        name="jacobi2d",
        axes=(Axis("i", h - 2), Axis("j", w - 2)),
        reads=(Access("x", ("i", "j"), halo=JAC_HALO),),
        writes=(Access("y", ("i", "j")),),
        body=_jacobi_body,
        out_dtype=None,
    )
