"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule.  The update runs through the fused multi-strided kernel
(``repro_torch.kernels.adamw.adamw_update_many``): on the card one K1
CUDA launch a step for all parameters of one dtype, in place, the clip
scale fused; its plain version on the CPU or with ``mode="ref"``.

A parameter tree is a mapping of names to tensors (for a model,
``dict(module.named_parameters())``), and the optimizer state is
``{"m": {name: f32}, "v": {name: f32}, "step": int32 0-d}``, as the JAX
package's pytrees.  The step's scalars (lr, the bias corrections, the
clip scale) are computed once a step on the parameters' device and reach
the kernel as one f32 [7] tensor and a 0-d clip scale, each leaf's weight
decay in the kernel's leaf table: no host sync, as JAX keeps them on the
device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch

from repro_torch.kernels.adamw import ops as adamw_ops

__all__ = ["AdamWConfig", "cosine_lr", "adamw_init", "global_norm",
           "decays", "adamw_step"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio``; f32 on the
    step's device."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Mapping[str, torch.Tensor]) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": step}


def global_norm(tree: Mapping[str, torch.Tensor],
                cuts: Optional[Mapping[str, tuple[str, ...]]] = None,
                ctx=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32: the norm of the
    leaves' norms, one read of each leaf and no squared copy of it.

    Across ranks (``ctx``), ``cuts`` names the mesh axes each leaf of
    this rank's pieces is cut over (``data`` for a ZeRO-3 shard,
    ``model`` for a tensor-parallel block, or both): a leaf's squares are
    summed over the axes it is cut over (one f32 all-reduce an axis), and
    a leaf whole on every rank counts once.  The result is the norm of
    the whole gradient, as a device tensor."""
    norms = {k: torch.linalg.vector_norm(g, dtype=torch.float32)
             for k, g in tree.items()}
    if ctx is None or not cuts or not any(cuts.values()):
        return torch.linalg.vector_norm(torch.stack(list(norms.values())))
    from repro_torch.sharding import collectives
    zero = torch.zeros((), device=next(iter(norms.values())).device)
    parts: dict = {}
    for k, n in norms.items():
        axes = tuple(sorted(set(cuts.get(k, ()))))
        parts[axes] = parts.get(axes, zero) + n.square()
    total = parts.pop((), zero)
    for axis in ("data", "model"):
        # sum each part over the axes it is cut over, this one first
        mine = [a for a in parts if axis in a]
        if mine:
            t = torch.stack([parts[a] for a in mine])
            collectives.all_reduce(t, ctx.axis_group(axis), axis=axis)
            parts.update(zip(mine, t.unbind()))
    return torch.sqrt(sum(parts.values(), total))


STACKS = ("blocks.", "enc_blocks.")


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether weight decay applies to the parameter ``name``, by the JAX
    package's rule on its trees: it decays leaves of ndim >= 2, and its
    per-layer leaves are stacked ``[n_layers, ...]``, so every per-layer
    tensor of a stack (``blocks.*`` and Whisper's encoder ``enc_blocks.*``,
    the layer norms' gains and Mamba-2's ``[H]`` scalars included) decays
    whatever its own ndim; ``final_norm`` and ``enc_norm`` ``[d]`` do
    not."""
    return name.startswith(STACKS) or p.ndim >= 2


def adamw_step(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], opt_state: dict,
               mode: Optional[str] = None,
               cuts: Optional[Mapping[str, tuple[str, ...]]] = None,
               ctx=None):
    """One fused AdamW step.  Returns (params, opt_state, metrics).

    Across ranks, p, g, m and v are this rank's pieces (each cut over
    the axes ``cuts`` names on ``ctx``'s mesh) and the kernel runs on
    them as they are; the clip uses the whole gradient's norm
    (:func:`global_norm`).

    Updates in place, where the JAX package returns new trees: each
    parameter's storage and ``opt_state``'s m and v tensors are written
    where they lie (one ``adamw_update_many`` a group of leaves of one
    parameter and gradient dtype), and ``opt_state``'s step is replaced.
    A caller that needs the old values clones them first."""
    step = opt_state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads, cuts, ctx)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf
    # the kernel's seven scalars, once a step (wd per leaf in its table)
    packed = torch.stack(adamw_ops.scalars(
        lr.device, lr, cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay, bc1, bc2))
    groups: dict = {}
    for name, p in params.items():
        g = grads[name]
        groups.setdefault((p.dtype, g.dtype, p.device), []).append(name)
    for names in groups.values():
        adamw_ops.adamw_update_many(
            [params[k].detach() for k in names], [grads[k] for k in names],
            [opt_state["m"][k] for k in names],
            [opt_state["v"][k] for k in names],
            [cfg.weight_decay if decays(k, params[k]) else 0.0
             for k in names],
            packed, gscale=scale, mode=mode)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
