"""Layer composition for the dense decoder: pre-norm attention + FFN
layers, one module per layer, and the train and decode paths over the
stack.

The JAX package scans stacked per-period params; here the stack is an
``nn.ModuleList`` walked by a Python loop (PyTorch runs eagerly).  A
dense period is one layer, so the JAX package's ``nothing_saveable``
checkpoint of each period is one ``torch.utils.checkpoint`` per layer
here."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, ffn


class Layer(nn.Module):
    """norm1 → attention → residual, norm2 → FFN → residual."""

    def __init__(self, norm1, attn: attention.Attention, norm2,
                 ffn_: ffn.FFN):
        super().__init__()
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.attn = attn
        self.norm2 = nn.Parameter(norm2, requires_grad=False)
        self.ffn = ffn_


def init_layer(generator: torch.Generator, cfg: ModelConfig, dtype,
               device) -> Layer:
    ones = torch.ones(cfg.d_model, dtype=dtype, device=device)
    return Layer(ones, attention.init_attn(generator, cfg, dtype, device),
                 ones.clone(),
                 ffn.init_ffn(generator, cfg.d_model, cfg.d_ff, cfg.act,
                              dtype, device))


def init_stack(generator: torch.Generator, cfg: ModelConfig, dtype,
               device) -> nn.ModuleList:
    return nn.ModuleList(init_layer(generator, cfg, dtype, device)
                         for _ in range(cfg.n_layers))


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device) -> list[dict[str, torch.Tensor]]:
    return [attention.init_cache(cfg, batch, max_len, dtype, device)
            for _ in range(cfg.n_layers)]


def _layer_forward(p: Layer, x, cfg: ModelConfig, rope, causal: bool = True,
                   mode: Optional[str] = None):
    """One dense layer over the whole sequence: (x', aux), aux = 0 (no
    MoE router in a dense layer)."""
    h = common.rms_norm(x, p.norm1, cfg.norm_eps, mode)
    a, _ = attention.attn_forward(p.attn, h, cfg, rope, causal)
    x = x + a
    h = common.rms_norm(x, p.norm2, cfg.norm_eps, mode)
    x = x + ffn.ffn_forward(p.ffn, h, cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def stack_forward(stack: nn.ModuleList, x, cfg: ModelConfig, rope,
                  causal: bool = True, remat: bool = True,
                  mode: Optional[str] = None):
    """Every layer in turn: (x, summed aux).  ``remat`` saves only each
    layer's input and recomputes the layer in the backward pass."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in stack:
        if remat:
            x, a = checkpoint(_layer_forward, layer, x, cfg, rope, causal,
                              mode, use_reentrant=False)
        else:
            x, a = _layer_forward(layer, x, cfg, rope, causal, mode)
        aux = aux + a
    return x, aux


def _layer_prefill(p: Layer, c, x, cfg: ModelConfig, rope,
                   mode: Optional[str] = None):
    """``_layer_forward`` plus cache capture in one pass: the layer's K, V
    written into ``c["k"][:, :S]`` and ``c["v"][:, :S]`` IN PLACE, where
    the JAX package returns an updated copy
    (``dynamic_update_slice_in_dim(..., 0, 1)``)."""
    h = common.rms_norm(x, p.norm1, cfg.norm_eps, mode)
    a, (k, v) = attention.attn_forward(p.attn, h, cfg, rope, causal=True)
    s = x.shape[1]
    c["k"][:, :s] = k.to(c["k"].dtype)
    c["v"][:, :s] = v.to(c["v"].dtype)
    x = x + a
    h = common.rms_norm(x, p.norm2, cfg.norm_eps, mode)
    return x + ffn.ffn_forward(p.ffn, h, cfg.act), c


def stack_prefill(stack: nn.ModuleList, cache, x, cfg: ModelConfig, rope,
                  mode: Optional[str] = None):
    """One pass over the layers: hidden states and the filled caches."""
    for i, layer in enumerate(stack):
        x, cache[i] = _layer_prefill(layer, cache[i], x, cfg, rope, mode)
    return x, cache


def _layer_decode(p: Layer, c, x, cfg: ModelConfig, rope, pos,
                  mode: Optional[str] = None):
    h = common.rms_norm(x, p.norm1, cfg.norm_eps, mode)
    a, c = attention.attn_decode(p.attn, h, cfg, c, pos, rope, mode=mode)
    x = x + a
    h = common.rms_norm(x, p.norm2, cfg.norm_eps, mode)
    return x + ffn.ffn_forward(p.ffn, h, cfg.act), c


def stack_decode(stack: nn.ModuleList, cache, x, cfg: ModelConfig, rope,
                 pos, mode: Optional[str] = None):
    for i, layer in enumerate(stack):
        x, cache[i] = _layer_decode(layer, cache[i], x, cfg, rope, pos,
                                    mode)
    return x, cache
