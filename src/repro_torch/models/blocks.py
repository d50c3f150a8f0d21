"""Layer composition: pre-norm layers of a mixer (attention or Mamba-2)
and an FFN (dense, MoE or none), homogeneous stacks and Jamba-style
periods, and the train, prefill and decode paths over the stack.

A *period* is the smallest repeating group of layers (1 for homogeneous
archs; ``attn_period`` for hybrids), described by ``layer_descriptors``.
The JAX package scans stacked per-period params; here the stack is a
flat ``nn.ModuleList`` walked by a Python loop (PyTorch runs eagerly):
layer ``l`` is period ``l // P``, position ``l % P``.  The JAX package's
``nothing_saveable`` checkpoint of each period is one
``torch.utils.checkpoint`` per layer here.  A Whisper decoder layer
(``LayerDesc.cross``) adds cross-attention against the encoder's K/V
after the mixer; the stack functions take those K/V as a per-layer
list ``cross_kv`` (``whisper.EncDecLM.cross_kv``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, ffn, mamba2, moe


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    mixer: str          # "attn" | "mamba"
    ffn: str            # "dense" | "moe" | "none"
    cross: bool = False  # whisper decoder cross-attention


def layer_descriptors(cfg: ModelConfig) -> tuple[LayerDesc, ...]:
    """Descriptors for one period (static composition)."""
    period = cfg.attn_period or 1
    descs = []
    for pos in range(period):
        mixer = "mamba" if cfg.family == "ssm" else "attn"
        if cfg.attn_period:
            mixer = "attn" if pos == cfg.attn_offset else "mamba"
        if cfg.moe is not None:
            is_moe = pos % cfg.moe.every_n_layers == cfg.moe.every_n_layers - 1
            f = "moe" if is_moe else "dense"
        elif cfg.family == "ssm":
            f = "none"
        else:
            f = "dense"
        descs.append(LayerDesc(mixer=mixer, ffn=f, cross=cfg.encdec))
    return tuple(descs)


def n_periods(cfg: ModelConfig) -> int:
    period = cfg.attn_period or 1
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} not a "
                         f"multiple of period {period}")
    return cfg.n_layers // period


def stack_descriptors(cfg: ModelConfig) -> list[LayerDesc]:
    """Every layer's descriptor: layer ``l`` takes position ``l % P``."""
    descs = layer_descriptors(cfg)
    return [descs[i % len(descs)]
            for i in range(n_periods(cfg) * len(descs))]


Mixer = Union[attention.Attention, mamba2.Mamba]
FFNLike = Union[ffn.FFN, moe.MoE, None]


class Layer(nn.Module):
    """norm1 → mixer (``attn`` or ``mamba``) → residual; for a Whisper
    decoder layer, norm_x → cross-attention (``cross``) → residual; then,
    unless the layer has no FFN, norm2 → FFN (``ffn`` or ``moe``) →
    residual.  ``norm_x`` and ``cross`` are None where unused."""

    def __init__(self, norm1, mixer: Mixer, norm2=None,
                 ffn_: FFNLike = None, norm_x=None,
                 cross: Optional[attention.Attention] = None):
        super().__init__()
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        kind = "attn" if isinstance(mixer, attention.Attention) else "mamba"
        setattr(self, kind, mixer)
        self.norm_x = (None if cross is None
                       else nn.Parameter(norm_x, requires_grad=False))
        self.cross = cross
        f = "none"
        if ffn_ is not None:
            self.norm2 = nn.Parameter(norm2, requires_grad=False)
            f = "moe" if isinstance(ffn_, moe.MoE) else "dense"
            setattr(self, "moe" if f == "moe" else "ffn", ffn_)
        self.desc = LayerDesc(mixer=kind, ffn=f, cross=cross is not None)


def init_layer(generator: torch.Generator, cfg: ModelConfig,
               desc: LayerDesc, dtype, device) -> Layer:
    ones = torch.ones(cfg.d_model, dtype=dtype, device=device)
    if desc.mixer == "attn":
        mixer = attention.init_attn(generator, cfg, dtype, device)
    else:
        mixer = mamba2.init_mamba(generator, cfg, dtype, device)
    cross = (attention.init_attn(generator, cfg, dtype, device)
             if desc.cross else None)
    f = None
    if desc.ffn == "moe":
        f = moe.init_moe(generator, cfg, dtype, device)
    elif desc.ffn == "dense":
        f = ffn.init_ffn(generator, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                         device)
    return Layer(ones, mixer, ones.clone() if f is not None else None, f,
                 ones.clone() if cross is not None else None, cross)


def init_stack(generator: torch.Generator, cfg: ModelConfig, dtype,
               device) -> nn.ModuleList:
    """One ``Layer`` per layer of ``stack_descriptors(cfg)``.  Whisper's
    encoder is the stack of ``cfg`` with ``encdec=False`` (no cross)."""
    return nn.ModuleList(init_layer(generator, cfg, desc, dtype, device)
                         for desc in stack_descriptors(cfg))


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device, ctx=None) -> list[dict[str, torch.Tensor]]:
    """A layer's cache: ``{"k", "v"}`` [B, max_len, Hkv, dh] for
    attention (with a collective ``ctx``, this rank's slice of the
    sequence: ``attention.init_cache``), the decode state ``{"conv",
    "ssm"}`` for Mamba-2."""
    return [attention.init_cache(cfg, batch, max_len, dtype, device, ctx)
            if desc.mixer == "attn"
            else mamba2.init_state(cfg, batch, dtype, device)
            for desc in stack_descriptors(cfg)]


def _ffn(p: Layer, x, cfg: ModelConfig, mode: Optional[str], ctx=None):
    """The layer's FFN half: (x', aux), aux the MoE router's loss (None
    for a dense FFN or none).  ``ctx``: the MoE's dispatch
    (``moe.moe_forward``: expert parallelism in a tensor-parallel
    forward whose model axis divides the experts); in a tensor-parallel
    forward a dense FFN is column- then row-parallel where the model axis
    divides ``d_ff`` (as the rules cut it), else whole on every rank over
    the whole sequence (``ffn.ffn_layer``)."""
    if p.desc.ffn == "none":
        return x, None
    h = common.rms_norm(x, p.norm2, cfg.norm_eps, mode)
    if p.desc.ffn == "moe":
        f, aux = moe.moe_forward(p.moe, h, cfg, ctx)
        return x + f, aux
    return x + ffn.ffn_layer(p.ffn, h, cfg, ctx), None


def _cross(p: Layer, x, cfg: ModelConfig, kv, mode: Optional[str]):
    """A Whisper decoder layer's cross-attention half: x +
    cross_attn(rms_norm(x, norm_x), kv); x itself for any other layer.  A
    cross layer without the encoder's K/V raises: the decoder does not run
    without its encoder."""
    if not p.desc.cross:
        return x
    if kv is None:
        raise ValueError("a cross-attention layer needs the encoder's K/V "
                         "(cross_kv)")
    h = common.rms_norm(x, p.norm_x, cfg.norm_eps, mode)
    return x + attention.cross_attn_forward(p.cross, h, cfg, kv)


def _layer_forward(p: Layer, x, cfg: ModelConfig, rope, causal: bool = True,
                   mode: Optional[str] = None, cross_kv=None, ctx=None):
    """One layer over the whole sequence: (x', aux), aux None where the
    layer has no MoE.  ``ctx``: the MoE's dispatch; in a tensor-parallel
    forward (``common.tp_layout``) the layer holds its weights' ``model``
    blocks and x its boundary's rows (S / tp of them where the sequence
    is sharded), where the norms and residuals run: a Mamba-2 mixer
    (whole over ``model`` by the rules) on the whole sequence between
    ``rep_enter`` and ``rep_exit``, attention by :func:`_attn`, the FFN
    by :func:`_ffn`."""
    h = common.rms_norm(x, p.norm1, cfg.norm_eps, mode)
    if p.desc.mixer == "attn":
        a = _attn(p.attn, h, cfg, rope, causal, ctx)
    else:
        a = common.rep_exit(mamba2.mamba_forward(
            p.mamba, common.rep_enter(h, ctx), cfg, mode=mode), ctx)
    return _ffn(p, _cross(p, x + a, cfg, cross_kv, mode), cfg, mode, ctx)


def _attn(p: attention.Attention, h, cfg: ModelConfig, rope, causal: bool,
          ctx=None):
    """Attention of a layer boundary's rows ``h``, back at the boundary.
    In a tensor-parallel forward whose model axis divides the heads:
    Megatron heads between ``common.tp_enter`` and ``tp_exit``; where it
    does not, the JAX package's sequence-sharded attention on a sharded
    sequence (``attention.attn_seqshard``: this rank's query rows, no
    reduction), else attention whole on every rank, as GSPMD replicates
    it (the rules keep the weights whole then)."""
    if not common.tensor_parallel(ctx) or cfg.n_heads % ctx.tp == 0:
        a, _ = attention.attn_forward(p, common.tp_enter(h, ctx), cfg, rope,
                                      causal, ctx, h.dtype)
        return common.tp_exit(a, ctx, h.dtype)
    if ctx.seq_sharded:
        return attention.attn_seqshard(p, h, cfg, rope, causal, ctx)
    return attention.attn_forward(p, h, cfg, rope, causal)[0]


def norm_calls(stack) -> int:
    """rmsnorm calls of one pass through ``stack`` (the forward, a prefill
    or a decode step): each layer's norm1, its norm_x where it
    cross-attends, its norm2 where it has an FFN and Mamba-2's gated
    norm."""
    return sum(1 + layer.desc.cross + (layer.desc.ffn != "none")
               + (layer.desc.mixer == "mamba") for layer in stack)


def _layer_kv(cross_kv, i: int):
    return None if cross_kv is None else cross_kv[i]


def stack_forward(stack: nn.ModuleList, x, cfg: ModelConfig, rope,
                  causal: bool = True, remat: bool = True,
                  mode: Optional[str] = None, cross_kv=None, run=None,
                  ctx=None):
    """Every layer in turn: (x, the MoE layers' aux summed).  ``remat``
    saves only each layer's input and recomputes the layer in the
    backward pass.  ``cross_kv``: a Whisper decoder's per-layer encoder
    K/V ``{"k", "v"}``, or None.  ``run(layer, x, cfg, rope, causal,
    mode, kv, ctx)`` runs one layer (default ``_layer_forward``; under
    remat it reruns in the backward pass with the layer)."""
    run = run or _layer_forward
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(stack):
        kv = _layer_kv(cross_kv, i)
        if remat:
            x, a = checkpoint(run, layer, x, cfg, rope, causal, mode, kv,
                              ctx, use_reentrant=False)
        else:
            x, a = run(layer, x, cfg, rope, causal, mode, kv, ctx)
        if a is not None:
            aux = aux + a
    return x, aux


def _layer_prefill(p: Layer, c, x, cfg: ModelConfig, rope,
                   mode: Optional[str] = None, cross_kv=None, ctx=None):
    """``_layer_forward`` plus cache capture in one pass.  Attention:
    the layer's K, V written into ``c["k"][:, :S]`` and ``c["v"][:, :S]``
    IN PLACE, where the JAX package returns an updated copy
    (``dynamic_update_slice_in_dim(..., 0, 1)``).  Mamba-2: the entry is
    replaced by the state after the sequence."""
    h = common.rms_norm(x, p.norm1, cfg.norm_eps, mode)
    if p.desc.mixer == "attn":
        a, (k, v) = attention.attn_forward(p.attn, h, cfg, rope,
                                           causal=True)
        s = x.shape[1]
        c["k"][:, :s] = k.to(c["k"].dtype)
        c["v"][:, :s] = v.to(c["v"].dtype)
    else:
        a, c = mamba2.mamba_forward(p.mamba, h, cfg, return_state=True,
                                    mode=mode)
    x, _ = _ffn(p, _cross(p, x + a, cfg, cross_kv, mode), cfg, mode, ctx)
    return x, c


def stack_prefill(stack: nn.ModuleList, cache, x, cfg: ModelConfig, rope,
                  mode: Optional[str] = None, cross_kv=None, ctx=None):
    """One pass over the layers: hidden states and the filled caches;
    ``ctx``: the MoE's dispatch."""
    for i, layer in enumerate(stack):
        x, cache[i] = _layer_prefill(layer, cache[i], x, cfg, rope, mode,
                                     _layer_kv(cross_kv, i), ctx)
    return x, cache


def _layer_decode(p: Layer, c, x, cfg: ModelConfig, rope, pos,
                  mode: Optional[str] = None, cross_kv=None, ctx=None,
                  shards: int = 1):
    h = common.rms_norm(x, p.norm1, cfg.norm_eps, mode)
    if p.desc.mixer == "attn":
        a, c = attention.attn_decode(p.attn, h, cfg, c, pos, rope,
                                     mode=mode, ctx=ctx, shards=shards)
    else:                       # Mamba-2 ignores shards, as in the JAX package
        a, c = mamba2.mamba_decode(p.mamba, h, cfg, c, mode=mode)
    x, _ = _ffn(p, _cross(p, x + a, cfg, cross_kv, mode), cfg, mode, ctx)
    return x, c


def stack_decode(stack: nn.ModuleList, cache, x, cfg: ModelConfig, rope,
                 pos, mode: Optional[str] = None, cross_kv=None, ctx=None,
                 shards: int = 1):
    """One decode step through every layer; ``ctx`` and ``shards`` go to
    attention (``attention.attn_decode``), ``ctx`` to the MoE's
    dispatch."""
    for i, layer in enumerate(stack):
        x, cache[i] = _layer_decode(layer, cache[i], x, cfg, rope, pos,
                                    mode, _layer_kv(cross_kv, i), ctx,
                                    shards)
    return x, cache
