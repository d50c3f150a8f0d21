"""Logical → physical sharding rules, the JAX package's
``repro/sharding/rules.py`` on the port's parameter names.

Parallelism plan:
  * batch            → (pod, data)        pure DP across pods
  * fsdp (ZeRO-3)    → data               param/opt-state sharding in-pod
  * tensor parallel  → model              Megatron attn-heads + FFN
  * expert parallel  → model              MoE experts
  * KV-cache seq     → model (+data at batch=1)   decode split-K

Divisibility-aware, with the JAX package's decisions kept exactly: heads
(and experts) shard over ``model`` only when evenly divisible, and the
fsdp axis applies whether or not a dim divides by the ``data`` size
(GSPMD pads the last shard; ``sharding.layout`` does the same).

A spec is a tuple with one entry per tensor dim (or fewer, where the
JAX package's ``PartitionSpec`` is shorter): a mesh-axis name, a tuple
of names, or None, normalised as ``jax.sharding.PartitionSpec`` keeps
its entries (an empty tuple is None, a tuple of one name is the name).
The port keeps one module per layer, so its names carry no stacked
``[n_periods]`` lead and its specs are the JAX ones without the lead
None.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims, or any
object with ``axis_names`` and ``shape`` (a mapping of name to size, as
a JAX mesh has them), so the rules evaluate at the production meshes
without their ranks.  An axis the mesh lacks counts as size 1 (the JAX
rules need ``data`` and ``model`` on every mesh), so ``data=4`` alone is
a mesh here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["MeshAxes", "mesh_shape", "param_specs", "batch_specs",
           "cache_specs", "P_ax"]

Spec = tuple


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of an object with
    ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {n: int(shape[n]) for n in mesh.axis_names}
    return dict(zip(mesh.axis_names, tuple(shape)))


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: tuple[str, ...] = ("data",)     # fsdp axes (in-pod)
    pod: tuple[str, ...] = ()           # cross-pod pure-DP axes
    tp: str = "model"

    @property
    def batch(self) -> tuple[str, ...]:
        return self.pod + self.dp

    @classmethod
    def for_mesh(cls, mesh) -> "MeshAxes":
        names = mesh_shape(mesh)
        return cls(dp=("data",), pod=("pod",) if "pod" in names else (),
                   tp="model")


def P_ax(axes: tuple[str, ...]):
    """One spec entry of ``axes``: None, a name, or a tuple of names."""
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _entry(e):
    """A spec entry as ``PartitionSpec`` keeps it."""
    return P_ax(tuple(e)) if isinstance(e, tuple) else e


def _spec(*entries) -> Spec:
    return tuple(_entry(e) for e in entries)


def _div(n: int, sizes: dict, axis: str) -> bool:
    return n % sizes.get(axis, 1) == 0


def _named_leaves(tree) -> dict[str, Any]:
    """``{name: tensor}`` of a module's parameters (``named_parameters``,
    the names ``params_from_numpy`` gives) or of a flat mapping."""
    if hasattr(tree, "named_parameters"):
        return dict(tree.named_parameters())
    return dict(tree)


def param_specs(params: Any, cfg: ModelConfig, mesh,
                serving: bool = False) -> dict[str, Spec]:
    """``{parameter name: spec}`` of ``params`` (an ``LMParams`` module,
    on any device including meta, or a mapping of names to tensors).

    serving=True drops the ZeRO-3/fsdp axis (params replicate over
    ``data``, shard over ``model`` only): decode re-reads every weight
    once a token, and gathering them over ``data`` each step would
    dominate its collective term."""
    sizes = mesh_shape(mesh)
    ax = MeshAxes.for_mesh(mesh)
    tp, fsdp = ax.tp, ax.dp
    if serving:
        fsdp = ()
    heads_ok = _div(cfg.n_heads, sizes, tp)
    kv_ok = _div(cfg.n_kv_heads, sizes, tp)
    ff_ok = _div(cfg.d_ff, sizes, tp) if cfg.d_ff else False
    ep_ok = cfg.moe is not None and _div(cfg.moe.n_experts, sizes, tp)

    def spec_for(path: tuple[str, ...], leaf) -> Spec:
        name = path[-1]
        mk = _spec
        if name == "embed":
            # tables are padded to cfg.padded_vocab (multiple of 128):
            # always vocab-shardable → logits stay vocab-sharded
            if _div(cfg.padded_vocab, sizes, tp):
                return mk(tp, None)
            return mk(None, tp if _div(cfg.d_model, sizes, tp) else None)
        if name == "head":
            if _div(cfg.padded_vocab, sizes, tp):
                return mk(None, tp)
            return mk(tp if _div(cfg.d_model, sizes, tp) else None, None)
        if name in ("final_norm", "enc_norm"):
            return mk(None)
        # ---- attention ----
        if len(path) >= 2 and path[-2] in ("attn", "cross"):
            if name == "wq":
                return mk(fsdp, tp if heads_ok else None)
            if name in ("wk", "wv"):
                return mk(fsdp, tp if kv_ok else None)
            if name == "wo":
                return mk(tp if heads_ok else None, fsdp)
        # ---- dense FFN (incl. MoE dense residual) ----
        if len(path) >= 2 and path[-2] in ("ffn", "dense"):
            if name in ("w_in", "w_gate"):
                return mk(fsdp, tp if ff_ok else None)
            if name == "w_out":
                return mk(tp if ff_ok else None, fsdp)
        # ---- MoE experts ----
        if "moe" in path:
            if name == "router":
                return mk(None, None)
            if name in ("w_in", "w_gate"):
                return mk(tp if ep_ok else None, fsdp, None)
            if name == "w_out":
                return mk(tp if ep_ok else None, None, fsdp)
        # ---- mamba (FSDP only: fused in_proj layout) ----
        if "mamba" in path:
            if name == "in_proj":
                return mk(fsdp, None)
            if name == "out_proj":
                return mk(None, fsdp)
        # norms and everything else: replicated
        return mk(*(None,) * leaf.ndim)

    return {name: spec_for(tuple(name.split(".")), leaf)
            for name, leaf in _named_leaves(params).items()}


def _walk(node, path, spec):
    if isinstance(node, dict):
        return {k: _walk(v, path + (k,), spec) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_walk(v, path + (str(i),), spec) for i, v in enumerate(node)]
    return spec(path, node)


def batch_specs(batch: Any, cfg: ModelConfig, mesh,
                shape: ShapeConfig) -> Any:
    """Shardings for a train/prefill/decode input batch dict."""
    sizes = mesh_shape(mesh)
    ax = MeshAxes.for_mesh(mesh)
    bsz = shape.global_batch
    nb = math.prod(sizes.get(a, 1) for a in ax.batch)
    baxes = ax.batch if bsz % nb == 0 else (
        ax.dp if bsz % sizes.get(ax.dp[0], 1) == 0 else ())
    b = _spec(baxes) if baxes else ()

    def spec(path, leaf):
        name = path[-1]
        if name in ("tokens", "prefix_embeds", "frames"):
            return b + (None,) * (leaf.ndim - 1)
        if name == "pos":
            return ()
        return (None,) * leaf.ndim

    return _walk(batch, (), spec)


def cache_specs(cache: Any, cfg: ModelConfig, mesh,
                shape: ShapeConfig) -> Any:
    """Decode-cache shardings, on the port's cache (a list of per-layer
    dicts; the JAX one stacks layers in a lead ``[n_periods]`` axis).

    Attention K/V [B, S, Hkv, dh]: batch over (pod, data) when
    divisible; the *sequence* axis over ``model`` (mesh-level split-K
    flash-decode).  At batch=1 the sequence also takes the data axes.
    SSM states: heads over ``model`` when divisible."""
    sizes = mesh_shape(mesh)
    ax = MeshAxes.for_mesh(mesh)
    bsz = shape.global_batch
    nb = math.prod(sizes.get(a, 1) for a in ax.batch)
    batch_ax = ax.batch if bsz % nb == 0 else ()
    seq_ax = (ax.tp,) if batch_ax else tuple(ax.batch) + (ax.tp,)
    s = cfg.ssm
    nh_ok = s is not None and _div(s.n_heads(cfg.d_model), sizes, ax.tp)
    conv_ok = (s is not None and
               _div(s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state,
                    sizes, ax.tp))

    def _fit(size: int, axes: tuple[str, ...]) -> tuple[str, ...]:
        """Longest prefix-combination of ``axes`` that divides ``size``
        (cross-attn KV at enc_seq=1500 is not tp-divisible)."""
        for cand in (axes, axes[-1:], ()):
            n = math.prod(sizes.get(a, 1) for a in cand)
            if n and size % n == 0:
                return cand
        return ()

    def spec(path, leaf):
        name = path[-1]
        if name in ("k", "v"):
            # [B, S, Hkv, dh] (self) / [B, T, Hkv, dh] (cross)
            lead = (None,) * (leaf.ndim - 4)
            sax = _fit(leaf.shape[-3], seq_ax)
            return lead + (P_ax(batch_ax), P_ax(sax), None, None)
        if name == "ssm":
            # [B, H, Pdim, N]
            lead = (None,) * (leaf.ndim - 4)
            return lead + (P_ax(batch_ax), ax.tp if nh_ok else None,
                           None, None)
        if name == "conv":
            # [B, K-1, conv_dim]
            lead = (None,) * (leaf.ndim - 3)
            return lead + (P_ax(batch_ax), None,
                           ax.tp if conv_ok else None)
        return (None,) * leaf.ndim

    return _walk(cache, (), spec)
