"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule.  The per-parameter update runs through the fused multi-strided
kernel (``repro_torch.kernels.adamw``): the K1 CUDA kernel on the card,
its plain version on the CPU or with ``mode="ref"``.

A parameter tree is a mapping of names to tensors (for a model,
``dict(module.named_parameters())``), and the optimizer state is
``{"m": {name: f32}, "v": {name: f32}, "step": int32 0-d}``, as the JAX
package's pytrees.  The step's scalars (lr, the bias corrections, the
clip scale) are computed once a step on the parameters' device and reach
the kernel as one f32 [7] tensor per weight-decay value: no host sync a
parameter, as JAX keeps them on the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import torch

from repro_torch.kernels.adamw import ops as adamw_ops

__all__ = ["AdamWConfig", "cosine_lr", "adamw_init", "global_norm",
           "adamw_step"]


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


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32: the norm of the
    leaves' norms, one read of each leaf and no squared copy of it."""
    return torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(g, dtype=torch.float32)
        for g in tree.values()]))


def adamw_step(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, torch.Tensor], opt_state: dict,
               mode: Optional[str] = None):
    """One fused AdamW step.  Returns (params, opt_state, metrics).

    Updates in place, tensor by tensor, where the JAX package returns new
    trees: each parameter's storage is swapped for its update
    (``p.data``), and ``opt_state``'s m and v entries and step are
    replaced, so at most one tensor's old and new state exist together
    (the new ones are the kernel's outputs: nothing is copied)."""
    step = opt_state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    bc1 = 1.0 - cfg.b1 ** stepf
    bc2 = 1.0 - cfg.b2 ** stepf
    # the kernel's seven scalars, once a step for each weight decay used
    packed = {wd: torch.stack(adamw_ops.scalars(
        lr.device, lr, cfg.b1, cfg.b2, cfg.eps, wd, bc1, bc2)).unbind()
        for wd in (cfg.weight_decay, 0.0)}
    for name, p in params.items():
        g = grads[name].float() * scale
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        p2, m2, v2 = adamw_ops.adamw_update(
            p.detach(), g, opt_state["m"][name], opt_state["v"][name],
            *packed[wd], mode=mode)
        p.data = p2
        opt_state["m"][name] = m2
        opt_state["v"][name] = v2
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
