"""int8 error-feedback gradient compression over the cross-pod axis, the
JAX package's ``repro/train/compression.py`` over ``torch.distributed``.

The pod interconnect is the scarcest link at multi-pod scale; gradients
crossing it go as int8 with one shared per-tensor scale:

    wire = all_to_all(int8 chunks)  →  local int32 exact sum
         → requantize → all_gather(int8 chunks)

≈ 2·N int8 bytes on the wire against 8·N for an f32 ring all-reduce.
The quantization error is fed back into the next step's gradient (error
feedback, as in 1-bit Adam).

Under ZeRO-3 each rank holds a piece of a gradient (its ``data`` shard,
zero-padded) and compresses that piece over its ``pod`` group.  Both
scales are maxima over the whole tensor: an all-reduce of the maximum
over ``data`` as well as ``pod``.  Given the scales each element's
result depends on that element alone, so the pieces together are, value
for value, the JAX package's result on the whole tensor
(``torch.round`` and ``jnp.round`` both round half to even).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.sharding import collectives

__all__ = ["quantize", "compressed_pmean", "ef_init", "ef_compressed_pmean",
           "wire_bytes"]


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _max_over_tensor(x: torch.Tensor, ctx) -> torch.Tensor:
    """max |x| over every rank's piece of the tensor: this piece's, then
    the maximum over ``data`` and over ``pod``."""
    m = x.abs().max()
    for axis in ("data", "pod"):
        if ctx.axis_size(axis) > 1:
            collectives.all_reduce(m, ctx.axis_group(axis), op="max",
                                   axis=axis)
    return m


def compressed_pmean(x: torch.Tensor, ctx) -> torch.Tensor:
    """Mean over ``ctx``'s ``pod`` axis with an int8 wire format (shape
    and dtype preserved), of this rank's piece ``x``."""
    n = ctx.pod
    group = ctx.pod_group
    shape = x.shape
    xf = x.float().reshape(-1)
    size = xf.numel()
    pad = (-size) % n
    if pad:
        xf = F.pad(xf, (0, pad))
    chunks = xf.reshape(n, -1)

    # shared scale so int32 partial sums are exact across peers
    scale = torch.clamp(_max_over_tensor(xf, ctx) / 127.0, min=1e-30)
    q = quantize(chunks, scale)                              # [n, m] int8
    recv = torch.empty_like(q)
    collectives.all_to_all(recv.view(-1), q.view(-1), group, axis="pod")
    local = recv.to(torch.int32).sum(dim=0)                  # exact
    mean = local.float() * (scale / n)                       # [m]
    # second hop: requantized int8 all-gather of the reduced chunk
    scale2 = torch.clamp(_max_over_tensor(mean, ctx) / 127.0, min=1e-30)
    q2 = quantize(mean, scale2)
    full = torch.empty(n * q2.numel(), dtype=torch.int8, device=q2.device)
    collectives.all_gather(full, q2, group, axis="pod")
    out = full.float() * scale2
    return out[:size].reshape(shape).to(x.dtype)


def ef_init(grads: Mapping[str, torch.Tensor]) -> dict:
    """Error-feedback buffers (the grads' names and shapes, f32)."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def ef_compressed_pmean(grads: Mapping[str, torch.Tensor],
                        ef: Mapping[str, torch.Tensor], ctx,
                        groups: Optional[Sequence[Sequence[str]]] = None):
    """Error-feedback compressed mean: returns (synced grads, ef').

    ``groups``: lists of names that are one tensor to the JAX package (a
    stacked ``[n_layers, ...]`` leaf is every layer's parameter of that
    name: ``trainstep.jax_leaf_groups``), each compressed as the
    concatenation of its members' pieces, so under one pair of scales;
    by default each name alone."""
    synced, new_ef = {}, {}
    for names in (groups or [[k] for k in grads]):
        corrected = [grads[k].float() + ef[k] for k in names]
        flat = torch.cat([c.reshape(-1) for c in corrected])
        out = compressed_pmean(flat, ctx).split(
            [c.numel() for c in corrected])
        for k, c, o in zip(names, corrected, out):
            s = o.reshape(c.shape)
            # local quantization residual feeds the next step
            new_ef[k] = c - s
            synced[k] = s.to(grads[k].dtype)
    if set(synced) != set(grads):
        raise ValueError("groups do not cover the gradients: "
                         f"{sorted(set(synced) ^ set(grads))}")
    return synced, new_ef


def wire_bytes(n_params: int, n_pods: int) -> dict:
    """Analytic wire cost per device (for the roofline collective term)."""
    frac = (n_pods - 1) / max(n_pods, 1)
    return {
        "fp32_ring_allreduce": 2 * 4 * n_params * frac,
        "bf16_ring_allreduce": 2 * 2 * n_params * frac,
        "int8_ef_a2a_ag": 2 * 1 * n_params * frac,
    }
