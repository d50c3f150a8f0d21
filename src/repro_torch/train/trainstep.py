"""Train step: loss → grads (activation checkpointing, optional
microbatching) → fused AdamW, on one card or across ranks.

The state is ``{"params": LMParams (trainable), "opt_state": {"m", "v",
"step"}}``; m and v are keyed by the parameters' names.  Across ranks
(``ctx``, a ``MeshCtx`` over a ``DeviceMesh`` with a ``data`` and
optionally a ``pod`` and a ``model`` axis), the step is the JAX
package's on the same global batch: parameters, m and v sharded ZeRO-3
over ``data`` (``train.zero``) and, on a ``model`` axis of more than one
rank, cut over it as the rules say and run tensor-parallel
(``models.common.tp_layout``); the batch split over ``(pod, data)``,
every ``model`` rank of a line on the same rows; gradients and metrics
averaged over the batch's ranks.  ``make_compressed_train_step``
averages gradients across pods as int8 with error feedback
(``train.compression``), its residual carried in ``state["ef"]``.
"""
from __future__ import annotations

import types
from typing import Optional

import torch

from repro_torch.models import common
from repro_torch.models.lm import param_paths, seq_len
from repro_torch.sharding import collectives, rules
from repro_torch.sharding.layout import shard_tree
from repro_torch.train import compression, zero
from repro_torch.train import optimizer as opt

__all__ = ["init_state", "shard_state", "state_tree", "load_state_tree",
           "make_train_step", "make_compressed_train_step",
           "init_compressed_state", "jax_leaf_groups"]


def init_state(model, seed: int = 0, device=None, ctx=None) -> dict:
    """Trainable params drawn from ``seed`` on ``device`` (the card unless
    ``device="cpu"``) and a zero AdamW state; with ``ctx``, this rank's
    pieces of them (drawn whole, then cut one tensor at a time)."""
    params = model.init(seed, device=device, trainable=True)
    if ctx is not None:
        return shard_state(model, params, ctx)
    return {"params": params,
            "opt_state": opt.adamw_init(dict(params.named_parameters()))}


def shard_state(model, params, ctx) -> dict:
    """The state of whole trainable ``params`` on ``ctx``'s mesh: each
    parameter the rules cut (over ``data``, ``model`` or both) swapped
    for this rank's piece (``zero.shard_params_``), and zero m and v of
    the pieces' shapes."""
    zero.shard_params_(params, zero.layout(model, ctx))
    return {"params": params,
            "opt_state": opt.adamw_init(dict(params.named_parameters()))}


def state_tree(state: dict) -> dict:
    """The state as a nested dict of tensors (a checkpoint's tree); a
    compressed state's ``ef`` leaves carry the JAX package's lead
    ``[pods]`` axis, of which this rank holds one."""
    tree = {"params": {k: p.detach()
                       for k, p in state["params"].named_parameters()},
            "opt_state": state["opt_state"]}
    if "ef" in state:
        tree["ef"] = {k: e[None] for k, e in state["ef"].items()}
    return tree


def load_state_tree(state: dict, tree: dict) -> dict:
    """Copy a checkpoint tree (arrays or tensors, as ``state_tree`` gives
    it; under ZeRO-3 this rank's shards) into ``state`` on its device, in
    place."""
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
    if "ef" in tree:
        state["ef"] = {k: torch.as_tensor(tree["ef"][k])[0].to(dev)
                       for k in params}
    return state


def _grads_fn(model, grad_accum: int, remat: bool, mode: Optional[str]):
    """``grads(params, batch, run=None, ctx=None) → (loss, metrics, [grad
    of each parameter])`` (``run``: how a layer runs,
    ``blocks.stack_forward``; ``ctx``: the sharded step's mesh context)
    with ``grad_accum`` microbatches: every leaf of the batch (tokens,
    and a VLM's ``prefix_embeds`` or Whisper's ``frames``) split along
    its batch axis and run one after another (activation memory ÷
    accum, same math), their grads summed in f32 and divided."""

    def grads_of(params, batch, run, ctx):
        loss, metrics = model.loss(params, batch, remat=remat, mode=mode,
                                   run=run, ctx=ctx)
        grads = torch.autograd.grad(loss, list(params.parameters()))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def grads(params, batch, run=None, ctx=None):
        if grad_accum == 1:
            return grads_of(params, batch, run, ctx)
        leaves = {k: torch.as_tensor(v) for k, v in batch.items()}
        mb = leaves["tokens"].shape[0] // grad_accum
        gsum, lsum = None, 0.0
        for i in range(grad_accum):
            l, _, g = grads_of(params, {
                k: v[i * mb:(i + 1) * mb] for k, v in leaves.items()}, run,
                ctx)
            g = [x.float() for x in g]
            gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
            lsum = lsum + l
        return lsum / grad_accum, {}, [x / grad_accum for x in gsum]

    return grads


def make_train_step(model, ocfg: opt.AdamWConfig, grad_accum: int = 1,
                    remat: bool = True, mode: Optional[str] = None,
                    ctx=None):
    """Returns ``train_step(state, batch) → (state, metrics)``; the state
    is updated in place (see ``optimizer.adamw_step``).

    ``grad_accum > 1`` splits the batch into microbatches
    (``_grads_fn``).  ``mode="ref"`` runs every kernel's plain version
    (for comparison on the card).  With ``ctx`` the step runs on every
    rank of its mesh (``_sharded_step``), on a state from
    ``init_state(..., ctx=ctx)`` or ``shard_state``."""
    grads = _grads_fn(model, grad_accum, remat, mode)
    if ctx is not None:
        return _sharded_step(model, ocfg, grads, ctx, mode)

    def train_step(state, batch):
        params = state["params"]
        named = dict(params.named_parameters())
        loss, metrics, g = grads(params, batch)
        _, _, om = opt.adamw_step(ocfg, named, dict(zip(named, g)),
                                  state["opt_state"], mode=mode)
        return state, dict(metrics, loss=loss, **om)

    return train_step


def _mean(t: torch.Tensor, ctx, axes) -> torch.Tensor:
    """``t`` summed over each axis of ``axes`` and divided by their
    ranks (in place)."""
    n = 1
    for a in axes:
        if ctx.axis_size(a) > 1:
            collectives.all_reduce(t, ctx.axis_group(a), axis=a)
            n *= ctx.axis_size(a)
    return t.div_(n) if n > 1 else t


def _local_batch(model, batch, ctx) -> dict:
    """This rank's rows of the global ``batch`` by the sharding rules
    (split over ``(pod, data)``, or fewer axes where they do not divide
    the batch, as ``rules.batch_specs`` decides)."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    shape = types.SimpleNamespace(global_batch=batch["tokens"].shape[0])
    specs = rules.batch_specs(batch, model.cfg, ctx.mesh, shape)
    return shard_tree(batch, specs, ctx.mesh)


def _sharded_grads(model, grads, ctx, pods: bool):
    """``(grads_and_metrics(state, batch) → (named params, grads,
    metrics), {name: the axes it is cut over})`` across ``ctx``'s ranks.
    Each rank runs the loss and its gradient on its rows of the batch
    (tensor-parallel on a ``model`` axis of more than one rank); a ZeRO-3
    shard's gradient comes out of the layer's gather already
    reduce-scattered and divided by the ``data`` size; a gradient that
    each ``model`` rank holds a part of (``zero.model_partial``) is
    summed over ``model``; every parameter whole over ``data`` is
    averaged over ``data``; ``pods``: all are then averaged over ``pod``
    too (the compressed step averages across pods itself).  The metrics
    are means over the batch's ranks."""
    shards = zero.layout(model, ctx)
    sharded = zero.sharded_names(shards)
    cuts = {k: zero.cut_axes(sh) for k, sh in shards.items()}

    def grads_and_metrics(state, batch):
        params = state["params"]
        named = dict(params.named_parameters())
        run = zero.Runner(params, shards, ctx, model.cfg.cdtype())
        local = _local_batch(model, batch, ctx)
        loss, metrics, g = grads(params, local, run, ctx)
        g = dict(zip(named, g))
        seq = common.tp_layout(ctx, seq_len(model.cfg, local)).seq_sharded
        partial = zero.model_partial(model.cfg, ctx, bool(seq))
        for k in g:
            t = g[k].float()
            if partial(k):
                collectives.all_reduce(t, ctx.tp_group, axis=ctx.tp_axis)
            axes = ("data",) if k not in sharded else ()
            if pods:
                axes += ("pod",)
            g[k] = _mean(t, ctx, axes)
        keys = ["loss"] + sorted(metrics)
        vals = _mean(torch.stack([loss.float()] + [
            metrics[k].float() for k in keys[1:]]), ctx, ctx.dp_axes)
        return named, g, dict(zip(keys, vals.unbind()))

    return grads_and_metrics, cuts


def _sharded_step(model, ocfg, grads, ctx, mode):
    """The step across ``ctx``'s ranks: ``_sharded_grads``, then AdamW on
    each rank's pieces, its clip on the whole gradient's norm."""
    grads_and_metrics, cuts = _sharded_grads(model, grads, ctx, pods=True)

    def train_step(state, batch):
        named, g, metrics = grads_and_metrics(state, batch)
        _, _, om = opt.adamw_step(ocfg, named, g, state["opt_state"],
                                  mode=mode, cuts=cuts, ctx=ctx)
        return state, dict(metrics, **om)

    return train_step


def jax_leaf_groups(cfg) -> list[list[str]]:
    """The port's parameter names grouped by the JAX package's leaf they
    are a layer of (``models.lm.param_paths``), layers in order: the
    tensors the JAX compressed sync quantizes as one."""
    groups: dict = {}
    for name, (path, _) in param_paths(cfg).items():
        groups.setdefault(path, []).append(name)
    return list(groups.values())


def make_compressed_train_step(model, ocfg: opt.AdamWConfig, ctx,
                               remat: bool = True,
                               mode: Optional[str] = None):
    """Train step with int8 error-feedback gradient sync across the
    ``pod`` axis (``train.compression``): gradients are pod-local (ZeRO-3
    over ``data`` inside each pod), their cross-pod mean goes over the
    wire as int8, and the quantization residual is carried in
    ``state["ef"]`` (this rank's piece of its pod's residual).  Each JAX
    leaf is compressed whole, a stacked one as all its layers under one
    pair of scales (:func:`jax_leaf_groups`), as the JAX step does.
    Metrics: loss, lr and grad_norm, as the JAX step's.  State from
    :func:`init_compressed_state`; needs a mesh with a ``pod`` axis."""
    if "pod" not in ctx.mesh.mesh_dim_names:
        raise ValueError("compressed pod sync needs a 'pod' mesh axis")
    if ctx.tp > 1:
        raise NotImplementedError(
            "the compressed pod sync on a model axis of more than one rank "
            "(its scales over the model blocks) is not ported (ROADMAP.md "
            "Queue 1 item 4, the compressed pod sync at model > 1)")
    grads_and_metrics, cuts = _sharded_grads(
        model, _grads_fn(model, 1, remat, mode), ctx, pods=False)
    groups = jax_leaf_groups(model.cfg)

    def train_step(state, batch):
        named, g, metrics = grads_and_metrics(state, batch)
        g, state["ef"] = compression.ef_compressed_pmean(g, state["ef"],
                                                         ctx, groups)
        _, _, om = opt.adamw_step(ocfg, named, g, state["opt_state"],
                                  mode=mode, cuts=cuts, ctx=ctx)
        return state, dict(loss=metrics["loss"], **om)

    return train_step


def init_compressed_state(model, seed: int = 0, device=None,
                          ctx=None) -> dict:
    """``init_state`` on ``ctx``'s mesh plus zero error-feedback buffers
    of the shards' shapes (the JAX state's ``ef`` leaves are ``[pods,
    ...]``; each rank keeps its pod's piece)."""
    state = init_state(model, seed, device, ctx)
    state["ef"] = compression.ef_init(dict(
        state["params"].named_parameters()))
    return state
