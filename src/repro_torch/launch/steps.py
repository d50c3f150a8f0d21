"""Build ``(step_fn, args)`` pairs for any (arch × shape) cell on one card,
the one-card form of the JAX package's ``repro/launch/steps.py``.

The ``abstract_*`` builders give shapes and dtypes with no storage, on
``torch.device("meta")``, as ``jax.eval_shape`` gives them there.  Their
dtypes follow the port's rule: serving weights in the compute dtype
(``abstract_params``), training state in ``param_dtype`` with f32 AdamW
moments (``abstract_state``), the KV cache and tokens as the JAX
package's (compute dtype, int32).

The ``build_*`` functions return a step and real arguments on the device
(the card unless ``device="cpu"``; without a card they raise): weights
drawn from seed 0 (or the caller's, for prefill), tokens from seeded
numpy, a zero KV cache.  ``arch`` is a name or a ``ModelConfig`` and
``shape`` a name or a ``ShapeConfig``, so a caller can cut a cell to
what one card holds; every field that differs from the named config or
shape is printed, with the bytes the uncut cell would need.

Across ranks: ``mesh_ctx`` gives a mesh's ``MeshCtx``, ``shard_tree``
(the JAX package's ``_shard``) each rank's piece of every leaf by the
sharding rules, on meta tensors too (per-rank bytes without
allocating), ``state_specs`` / ``state_shardings`` the training state's
specs and pieces, ``_decode_cache_specs`` a cache's; ``build_train_step(
..., mesh=)`` the ZeRO-3 step on this rank's shards of the state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.common import MeshCtx
from repro_torch.models.lm import build_model
from repro_torch.sharding import rules
from repro_torch.sharding.layout import shard_of, shard_tree
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep

__all__ = ["abstract_batch", "abstract_params", "abstract_state",
           "abstract_cache", "tree_bytes", "mesh_ctx", "shard_tree",
           "state_specs", "state_shardings", "build_train_step",
           "build_prefill_step", "build_decode_step", "build_cell"]

_META = torch.device("meta")

Arch = Union[str, ModelConfig]
Shape = Union[str, ShapeConfig]


# --------------------------------------------------------------- abstract

def abstract_batch(cfg: ModelConfig, shape: ShapeConfig,
                   for_decode: bool = False) -> dict:
    b = shape.global_batch
    s = 1 if for_decode else shape.seq_len
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                   device=_META)}
    if cfg.n_prefix_embeds and not for_decode:
        batch["prefix_embeds"] = torch.empty(
            (b, cfg.n_prefix_embeds, cfg.d_model), dtype=torch.float32,
            device=_META)
    if cfg.encdec and not for_decode:
        batch["frames"] = torch.empty((b, cfg.enc_seq, cfg.d_model),
                                      dtype=torch.float32, device=_META)
    return batch


def abstract_params(model):
    """Serving weights on meta, in the compute dtype."""
    return model.init(device=_META)


def abstract_state(model) -> dict:
    """Training state on meta: params in ``param_dtype``, f32 m and v."""
    return trainstep.init_state(model, device=_META)


def abstract_cache(model, cfg: ModelConfig, shape: ShapeConfig):
    """The cache on meta: ``{"k", "v"}`` of ``shape.seq_len`` positions
    for an attention layer, ``{"conv", "ssm"}`` (SSM state in f32) for a
    Mamba-2 layer; for Whisper ``{"self": that, "cross": each decoder
    layer's ``{"k", "v"}`` [B, enc_seq, Hkv, dh]}``, as the JAX package
    gives it (the cross K/V of a zero encoder output)."""
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device=_META)
    if not cfg.encdec:
        return cache
    return {"self": cache, "cross": _zero_cross_kv(
        model, abstract_params(model), cfg, shape.global_batch)}


def _zero_cross_kv(model, params, cfg: ModelConfig, b: int):
    """Each decoder layer's cross K/V of a zero encoder output
    ``[b, enc_seq, D]`` in the compute dtype, on the params' device."""
    enc = torch.zeros((b, cfg.enc_seq, cfg.d_model), dtype=cfg.cdtype(),
                      device=params.embed.device)
    with torch.no_grad():
        return model.cross_kv(params, enc)


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) tree: a module's parameters,
    dicts, lists."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


# --------------------------------------------------------------- sharding

def mesh_ctx(mesh) -> MeshCtx:
    """The ``MeshCtx`` of a ``DeviceMesh``: the batch over ``(pod,
    data)``, the model axis ``model``."""
    ax = rules.MeshAxes.for_mesh(mesh)
    return MeshCtx(mesh=mesh, dp_axes=ax.batch, tp_axis=ax.tp)


def state_specs(state, cfg: ModelConfig, mesh) -> dict:
    """Specs of a training state (``abstract_state``'s or a real one, its
    params whole): the params' for params, m and v, ``step``
    replicated; a compressed state's ``ef`` leaves ``[pods, ...]`` over
    ``pod`` and then as their parameter."""
    pspecs = rules.param_specs(state["params"], cfg, mesh)
    out = {"params": pspecs,
           "opt_state": {"m": pspecs, "v": pspecs, "step": ()}}
    if "ef" in state:
        out["ef"] = {k: ("pod",) + sp for k, sp in pspecs.items()}
    return out


def state_shardings(state, cfg: ModelConfig, mesh) -> dict:
    """This rank's ``Shard`` of each leaf of ``trainstep.state_tree``'s
    tree on ``mesh``, from a whole state's shapes (``abstract_state``'s,
    with ``"ef"`` for a compressed one): what ``CheckpointManager.save``
    and ``restore`` take."""
    shapes = {k: tuple(p.shape)
              for k, p in state["params"].named_parameters()}
    specs = state_specs(state, cfg, mesh)
    pshards = {k: shard_of(shapes[k], specs["params"][k], mesh)
               for k in shapes}
    out = {"params": pshards,
           "opt_state": {"m": pshards, "v": pshards,
                         "step": shard_of((), (), mesh)}}
    if "ef" in state:
        pods = rules.mesh_shape(mesh).get("pod", 1)
        out["ef"] = {k: shard_of((pods,) + shapes[k], specs["ef"][k], mesh)
                     for k in shapes}
    return out


def _decode_cache_specs(cache, cfg: ModelConfig, mesh, shape: ShapeConfig):
    if isinstance(cache, dict) and "self" in cache:
        return {
            "self": rules.cache_specs(cache["self"], cfg, mesh, shape),
            "cross": rules.cache_specs(cache["cross"], cfg, mesh, shape),
        }
    return rules.cache_specs(cache, cfg, mesh, shape)


# ------------------------------------------------------------------ cells

def _resolve(arch: Arch, shape: Shape) -> tuple[ModelConfig, ShapeConfig]:
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shp = get_shape(shape) if isinstance(shape, str) else shape
    return cfg, shp


def _cuts(cfg: ModelConfig, shape: ShapeConfig) -> None:
    """Print every field of ``cfg`` and ``shape`` that differs from the
    registry's config and shape of the same name, with the bytes the
    uncut cell needs."""
    full_cfg, full_shape = get_config(cfg.name), get_shape(shape.name)
    lines = []
    for given, named in ((cfg, full_cfg), (shape, full_shape)):
        diff = [f"{f.name} {getattr(named, f.name)} -> "
                f"{getattr(given, f.name)}"
                for f in dataclasses.fields(given)
                if getattr(given, f.name) != getattr(named, f.name)]
        if diff:
            lines.append(f"{given.name} cut: {', '.join(diff)}")
    if not lines:
        return
    full = build_model(full_cfg)
    if full_shape.kind == "train":
        need = {"state": tree_bytes(abstract_state(full))}
    else:
        need = {"weights": tree_bytes(abstract_params(full)),
                "KV cache": tree_bytes(abstract_cache(full, full_cfg,
                                                      full_shape))}
    print("; ".join(lines) + f" (uncut {full_cfg.name} {full_shape.name}: "
          + ", ".join(f"{k} {v / 1e9:.1f} GB" for k, v in need.items())
          + ")")


def _tokens(cfg: ModelConfig, b: int, s: int, dev):
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s),
                                         dtype=np.int32)).to(dev)


def _prefix_embeds(cfg: ModelConfig, b: int, dev):
    """A VLM's ``[B, Np, D]`` f32 patch embeddings (the frontend stub's
    output), standard normal from seeded numpy."""
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.standard_normal(
        (b, cfg.n_prefix_embeds, cfg.d_model), dtype=np.float32)).to(dev)


def _frames(cfg: ModelConfig, b: int, dev):
    """Whisper's ``[B, enc_seq, D]`` f32 frame embeddings (the audio
    frontend stub's output), standard normal from seeded numpy."""
    rng = np.random.default_rng(2)
    return torch.from_numpy(rng.standard_normal(
        (b, cfg.enc_seq, cfg.d_model), dtype=np.float32)).to(dev)


def _batch(cfg: ModelConfig, shp: ShapeConfig, dev) -> dict:
    """``tokens`` ``[global_batch, seq_len]``, and the keys
    ``abstract_batch`` declares beside them: a VLM's ``prefix_embeds``,
    Whisper's ``frames``."""
    b = shp.global_batch
    batch = {"tokens": _tokens(cfg, b, shp.seq_len, dev)}
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = _prefix_embeds(cfg, b, dev)
    if cfg.encdec:
        batch["frames"] = _frames(cfg, b, dev)
    return batch


def build_train_step(arch: Arch, shape: Shape, device=None,
                     remat: bool = True, grad_accum: int = 1, mesh=None):
    """``(train_step, (state, batch))``: AdamW at its defaults, the state
    drawn from seed 0, the batch of ``_batch`` (seeded numpy, the whole
    global batch).  With ``mesh`` (a ``DeviceMesh`` over every rank) the
    step is the ZeRO-3 one and the state this rank's shards
    (``trainstep.init_state(..., ctx=)``)."""
    dev = resolve_device(device)
    cfg, shp = _resolve(arch, shape)
    model = build_model(cfg)
    _cuts(cfg, shp)
    ctx = None if mesh is None else mesh_ctx(mesh)
    step = trainstep.make_train_step(model, opt.AdamWConfig(), remat=remat,
                                     grad_accum=grad_accum, ctx=ctx)
    state = trainstep.init_state(model, device=dev, ctx=ctx)
    return step, (state, _batch(cfg, shp, dev))


def build_prefill_step(arch: Arch, shape: Shape, device=None, params=None):
    """``(prefill, (params, batch))``; ``prefill(params, batch,
    max_len=None, mode=None)`` fills a cache of ``max_len`` positions,
    by default ``seq_len + n_prefix_embeds`` as the JAX package's (vlm
    prefix embeds extend the internal sequence).  The batch holds
    ``tokens`` and, for a VLM, ``prefix_embeds`` ``[B, Np, D]`` f32, for
    Whisper ``frames`` ``[B, enc_seq, D]`` f32 (as ``abstract_batch``
    declares them).  ``params``: weights to use
    (drawn from seed 0 when None), so a caller that serves can prefill
    on its own."""
    dev = resolve_device(device)
    cfg, shp = _resolve(arch, shape)
    model = build_model(cfg)
    _cuts(cfg, shp)

    def prefill(params, batch, max_len: Optional[int] = None,
                mode: Optional[str] = None):
        max_len = max_len or shp.seq_len + cfg.n_prefix_embeds
        return model.prefill(params, batch, max_len=max_len, mode=mode)

    if params is None:
        params = model.init(device=dev)
    return prefill, (params, _batch(cfg, shp, dev))


def build_decode_step(arch: Arch, shape: Shape, device=None):
    """serve_step: ``(decode, (params, tokens, cache, pos))``, one new
    token ``[global_batch, 1]`` at ``pos = seq_len - 1`` against a zero
    cache of ``seq_len`` positions (attention's updated in place; a
    Mamba-2 layer's entry is its zero decode state ``{"conv", "ssm"}``,
    replaced by the step's).  Whisper's cache is ``{"self": that,
    "cross": the cross K/V of a zero encoder output}``, as
    ``abstract_cache``'s."""
    dev = resolve_device(device)
    cfg, shp = _resolve(arch, shape)
    model = build_model(cfg)
    _cuts(cfg, shp)
    params = model.init(device=dev)
    cache = model.init_cache(shp.global_batch, shp.seq_len, device=dev)
    if cfg.encdec:
        cache = {"self": cache, "cross": _zero_cross_kv(
            model, params, cfg, shp.global_batch)}
    tokens = _tokens(cfg, shp.global_batch, 1, dev)
    pos = torch.tensor(shp.seq_len - 1, dtype=torch.int32, device=dev)
    return model.decode_step, (params, tokens, cache, pos)


def build_cell(arch: Arch, shape: Shape, device=None, **kw):
    """The step of the cell's kind: train, prefill or decode."""
    _, shp = _resolve(arch, shape)
    if shp.kind == "train":
        return build_train_step(arch, shape, device, **kw)
    if shp.kind == "prefill":
        return build_prefill_step(arch, shape, device, **kw)
    return build_decode_step(arch, shape, device, **kw)
