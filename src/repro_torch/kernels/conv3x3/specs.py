"""``TraversalSpec`` factory for the conv3x3 family, as in the JAX
package's ``kernels/conv3x3/specs.py``.

The nest is a row+column stencil: the read carries a ((1,1),(1,1)) halo
and the nine weights are scalars (the wrapper unpacks the 3×3 weight
matrix), so each of the D row streams reads its own haloed rows and the
body is nine shifted multiply-adds over ``tap`` views, w00 first, each
product and each sum rounded in f32.  The K1 template lowers it as
jacobi2d: ``csrc/stencil.cu``.
"""
from __future__ import annotations

from repro_torch.codegen import Access, Axis, TraversalSpec, tap

__all__ = ["conv3x3_spec", "C3_HALO", "C3_NAMES"]

C3_HALO = ((1, 1), (1, 1))
C3_NAMES = tuple(f"w{r}{c}" for r in range(3) for c in range(3))


def _conv_body(env):
    x = env["x"].float()
    acc = None
    for idx, name in enumerate(C3_NAMES):
        r, c = divmod(idx, 3)
        term = env[name] * tap(x, C3_HALO, r - 1, c - 1)
        acc = term if acc is None else acc + term
    return acc


def conv3x3_spec(x, *w9) -> TraversalSpec:
    h, w = x.shape
    return TraversalSpec(
        name="conv3x3",
        axes=(Axis("i", h - 2), Axis("j", w - 2)),
        reads=(Access("x", ("i", "j"), halo=C3_HALO),),
        writes=(Access("o", ("i", "j")),),
        scalars=C3_NAMES,
        body=_conv_body,
    )
