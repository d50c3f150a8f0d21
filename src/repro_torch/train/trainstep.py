"""Train step: loss → grads (activation checkpointing, optional
microbatching) → fused AdamW.

The state is ``{"params": LMParams (trainable), "opt_state": {"m", "v",
"step"}}``; m and v are keyed by the parameters' names.  The JAX
package's pod-axis compressed gradient sync (``make_compressed_train_step``,
``train/compression.py``) needs several chips and is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.train import optimizer as opt

__all__ = ["init_state", "state_tree", "load_state_tree", "make_train_step"]


def init_state(model, seed: int = 0, device=None) -> dict:
    """Trainable params drawn from ``seed`` on ``device`` (the card unless
    ``device="cpu"``) and a zero AdamW state."""
    params = model.init(seed, device=device, trainable=True)
    return {"params": params,
            "opt_state": opt.adamw_init(dict(params.named_parameters()))}


def state_tree(state: dict) -> dict:
    """The state as a nested dict of tensors (a checkpoint's tree)."""
    return {"params": {k: p.detach()
                       for k, p in state["params"].named_parameters()},
            "opt_state": state["opt_state"]}


def load_state_tree(state: dict, tree: dict) -> dict:
    """Copy a checkpoint tree (arrays or tensors, as ``state_tree`` gives
    it) into ``state`` on its device, in place."""
    params = dict(state["params"].named_parameters())
    if set(params) != set(tree["params"]):
        raise ValueError("checkpoint parameters do not match the model's: "
                         f"{sorted(set(params) ^ set(tree['params']))}")
    dev = next(iter(params.values())).device
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(torch.as_tensor(tree["params"][k]))
    ost = tree["opt_state"]
    state["opt_state"] = {
        "m": {k: torch.as_tensor(ost["m"][k]).to(dev) for k in params},
        "v": {k: torch.as_tensor(ost["v"][k]).to(dev) for k in params},
        "step": torch.as_tensor(ost["step"]).to(dev)}
    return state


def make_train_step(model, ocfg: opt.AdamWConfig, grad_accum: int = 1,
                    remat: bool = True, mode: Optional[str] = None):
    """Returns ``train_step(state, batch) → (state, metrics)``; the state
    is updated in place (see ``optimizer.adamw_step``).

    ``grad_accum > 1`` splits the batch into microbatches run one after
    another (activation memory ÷ accum, same math): their grads are
    summed in f32 and divided.  ``mode="ref"`` runs every kernel's plain
    version (for comparison on the card)."""

    def grads_of(params, batch):
        loss, metrics = model.loss(params, batch, remat=remat, mode=mode)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        return loss.detach(), metrics, grads

    def train_step(state, batch):
        params = state["params"]
        named = dict(params.named_parameters())
        if grad_accum == 1:
            loss, metrics, grads = grads_of(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            tokens = torch.as_tensor(batch["tokens"])
            mb = tokens.shape[0] // grad_accum
            gsum, lsum = None, 0.0
            for i in range(grad_accum):
                l, _, g = grads_of(params, {
                    "tokens": tokens[i * mb:(i + 1) * mb]})
                g = [x.float() for x in g]
                gsum = g if gsum is None else [a + b for a, b in
                                               zip(gsum, g)]
                lsum = lsum + l
            grads = [x / grad_accum for x in gsum]
            loss = lsum / grad_accum
            metrics = {}
        _, _, om = opt.adamw_step(ocfg, named, dict(zip(named, grads)),
                                  state["opt_state"], mode=mode)
        return state, dict(metrics, loss=loss, **om)

    return train_step
