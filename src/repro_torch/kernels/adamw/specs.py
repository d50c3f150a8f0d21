"""``TraversalSpec`` factory for the adamw family, as in the JAX
package's ``kernels/adamw/specs.py``.

One fused spec with three native outputs (p', m', v') sharing the write
access map: 4 load and 3 store streams per stride.  Its K1 instance is
the CUDA kernel ``csrc/adamw.cu``; at a ``lookahead`` other than 2 the
K4 ring's adamw body (``csrc/manual_ring.cu``).  Both compute this body
in its order, one rounding per operation.

The scalars enter as f32 (the JAX emitter reshapes them to f32 ``(1,
1)`` arrays, and its ref mode traces them as f32 under ``jit``), so
``1 - b1`` is an f32 subtraction here too: the op passes 0-d f32
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.codegen import Access, Axis, TraversalSpec

__all__ = ["adamw_spec"]


def _adamw_body(env):
    pf = env["p"].float()
    gf = env["g"].float()
    m_new = env["b1"] * env["m"] + (1.0 - env["b1"]) * gf
    v_new = env["b2"] * env["v"] + (1.0 - env["b2"]) * gf * gf
    update = ((m_new / env["bc1"])
              / (torch.sqrt(v_new / env["bc2"]) + env["eps"])
              + env["wd"] * pf)
    return (pf - env["lr"] * update, m_new, v_new)


def adamw_spec(p2, g2, m2, v2, lr=0.0, b1=0.0, b2=0.0,
               eps=0.0, wd=0.0, bc1=1.0, bc2=1.0) -> TraversalSpec:
    rows, cols = p2.shape
    return TraversalSpec(
        name="adamw_update",
        axes=(Axis("i", rows), Axis("j", cols)),
        reads=(Access("p", ("i", "j")), Access("g", ("i", "j")),
               Access("m", ("i", "j")), Access("v", ("i", "j"))),
        writes=(Access("po", ("i", "j")), Access("mo", ("i", "j")),
                Access("vo", ("i", "j"))),
        scalars=("lr", "b1", "b2", "eps", "wd", "bc1", "bc2"),
        body=_adamw_body,
        out_dtype=(torch.float32, torch.float32, torch.float32),
    )
