"""Causal LM, serving path: ``init`` → params, ``init_cache``, and
``decode_step(params, tokens, cache, pos)`` → (logits, cache).

Weights are stored in the compute dtype.  The JAX package keeps them in
``param_dtype`` (f32) and casts each weight to the compute dtype at use;
storing the cast once is the same rounding, and on the card it halves
the bytes every decode step reads.

Training entry points (``prefill``, ``hidden``, ``logits``, ``loss``,
``chunked_nll``) and the other model families are later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import attention, blocks, common, ffn

__all__ = ["LMParams", "CausalLM", "build_model", "params_from_numpy"]


class LMParams(nn.Module):
    """embed [Vp, D], blocks (one ``blocks.Layer`` per layer),
    final_norm [D], head [D, Vp] (None with tied embeddings)."""

    def __init__(self, embed: torch.Tensor, layers: nn.ModuleList,
                 final_norm: torch.Tensor,
                 head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = layers
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.head = (None if head is None
                     else nn.Parameter(head, requires_grad=False))


def _head_logits(params: LMParams, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params.embed.to(x.dtype).T
    return x @ params.head.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class CausalLM:
    cfg: ModelConfig

    def init(self, seed: int = 0, device=None) -> LMParams:
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        drawn on ``device`` (the card unless ``device="cpu"``).  Same
        distributions as the JAX package's init; not the same numbers."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dt = cfg.cdtype()
        embed = common.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt,
                                  dev)
        layers = blocks.init_stack(gen, cfg, dt, dev)
        head = (None if cfg.tie_embeddings else common.dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), dtype=dt, device=dev))
        return LMParams(embed, layers,
                        torch.ones(cfg.d_model, dtype=dt, device=dev), head)

    def init_cache(self, batch: int, max_len: int,
                   device=None) -> list[dict[str, torch.Tensor]]:
        return blocks.init_stack_cache(self.cfg, batch, max_len,
                                       self.cfg.cdtype(),
                                       resolve_device(device))

    def decode_step(self, params: LMParams, tokens: torch.Tensor, cache,
                    pos, mode: Optional[str] = None):
        """tokens: [B, 1]; pos: scalar current length, or a [B] vector of
        per-row lengths (ragged continuous batching).  The cache is
        updated in place and returned.  ``mode="ref"`` runs every kernel's
        plain version (for comparison on the card)."""
        cfg = self.cfg
        dev = params.embed.device
        x = params.embed[torch.as_tensor(tokens, device=dev)]
        x = x.to(cfg.cdtype())
        pos = torch.as_tensor(pos, device=dev).long()
        rope = common.make_rope(pos[:, None] if pos.ndim else pos[None],
                                cfg.head_dim, cfg.rope_theta,
                                cfg.rope_style)
        x, cache = blocks.stack_decode(params.blocks, cache, x, cfg, rope,
                                       pos, mode)
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps, mode)
        return _head_logits(params, x, cfg)[:, 0, :cfg.vocab_size], cache


def _check_supported(cfg: ModelConfig) -> None:
    missing = [what for what, present in (
        (f"family {cfg.family!r}", cfg.family != "dense"),
        ("moe", cfg.moe is not None), ("ssm", cfg.ssm is not None),
        ("hybrid attn_period", bool(cfg.attn_period)),
        ("encdec", cfg.encdec), ("prefix embeds", bool(cfg.n_prefix_embeds)),
        (f"frontend {cfg.frontend!r}", bool(cfg.frontend))) if present]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port "
            "serves dense decoder LMs)")


def build_model(cfg: ModelConfig) -> CausalLM:
    _check_supported(cfg)
    return CausalLM(cfg)


def params_from_numpy(cfg: ModelConfig, tree: Mapping,
                      device=None) -> LMParams:
    """Carry a JAX ``CausalLM.init`` tree (as numpy arrays, with the JAX
    key paths) into port params on ``device``, cast to the compute dtype.

    ``embed [Vp, D]``, ``head [D, Vp]``, ``final_norm [D]``; every
    ``blocks/pos0/...`` leaf has a leading ``[n_layers]`` axis, sliced
    here into one module per layer."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = cfg.cdtype()

    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a)).to(dev, dt)

    lp = tree["blocks"]["pos0"]
    layers = nn.ModuleList()
    for i in range(cfg.n_layers):
        a, f = lp["attn"], lp["ffn"]
        layers.append(blocks.Layer(
            t(lp["norm1"][i]),
            attention.Attention(t(a["wq"][i]), t(a["wk"][i]),
                                t(a["wv"][i]), t(a["wo"][i])),
            t(lp["norm2"][i]),
            ffn.FFN(t(f["w_in"][i]), t(f["w_out"][i]),
                    t(f["w_gate"][i]) if "w_gate" in f else None)))
    return LMParams(t(tree["embed"]), layers, t(tree["final_norm"]),
                    None if cfg.tie_embeddings else t(tree["head"]))
