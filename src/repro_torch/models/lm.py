"""Causal LM for dense decoders: ``init`` → params, the train path
(``hidden``, ``loss``, ``logits``, ``chunked_nll``) and the serving path
(``init_cache``, ``decode_step(params, tokens, cache, pos)`` → (logits,
cache)).

For serving, weights are stored in the compute dtype without gradients.
The JAX package keeps them in ``param_dtype`` (f32) and casts each
weight to the compute dtype at use; storing the cast once is the same
rounding, and on the card it halves the bytes every decode step reads.
For training (``trainable=True``) they are stored in ``param_dtype``
with gradients and cast at use, as the JAX package does.

``prefill`` and the other model families are later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def _embed_tokens(params: LMParams, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    # cast, then gather, as the JAX package: the gradient of the gather
    # accumulates in the compute dtype there too
    return params.embed.to(cfg.cdtype())[tokens]


def _head_logits(params: LMParams, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params.embed.to(x.dtype).T
    return x @ params.head.to(x.dtype)


def _chunk_nll(params: LMParams, xs, ls, ms, cfg: ModelConfig):
    logits = _head_logits(params, xs, cfg).float()
    if cfg.padded_vocab != cfg.vocab_size:      # mask pad columns
        pad = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = logits.masked_fill(pad >= cfg.vocab_size, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, ls[..., None].long())[..., 0]
    nll = (lse - ll + 1e-4 * lse ** 2) * ms
    return nll.sum(), ms.sum()


def chunked_nll(params: LMParams, x, labels, mask, cfg: ModelConfig,
                n_chunks: int = 8):
    """Cross-entropy without materializing [B,S,V] at once: the sequence
    in chunks, each under activation checkpointing (memory: B*S/n*V per
    chunk), with the z-loss 1e-4·lse² and pad columns masked at -1e30."""
    b, s, d = x.shape
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * cs, (i + 1) * cs)
        s_nll, s_cnt = checkpoint(_chunk_nll, params, x[:, sl],
                                  labels[:, sl], mask[:, sl], cfg,
                                  use_reentrant=False)
        tot, cnt = tot + s_nll, cnt + s_cnt
    return tot / cnt.clamp(min=1.0)


@dataclasses.dataclass(frozen=True)
class CausalLM:
    cfg: ModelConfig

    def init(self, seed: int = 0, device=None,
             trainable: bool = False) -> LMParams:
        """Random weights from a ``torch.Generator`` seeded with ``seed``,
        drawn on ``device`` (the card unless ``device="cpu"``).  Same
        distributions as the JAX package's init; not the same numbers.
        Stored in the compute dtype for serving, or in ``param_dtype``
        with gradients where ``trainable``."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dt = cfg.pdtype() if trainable else cfg.cdtype()
        embed = common.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt,
                                  dev)
        layers = blocks.init_stack(gen, cfg, dt, dev)
        head = (None if cfg.tie_embeddings else common.dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), dtype=dt, device=dev))
        params = LMParams(embed, layers,
                          torch.ones(cfg.d_model, dtype=dt, device=dev), head)
        return params.requires_grad_(trainable)

    # ---------------------------------------------------------- train
    def hidden(self, params: LMParams, batch, remat: bool = True,
               mode: Optional[str] = None):
        """(final-normed hidden states [B, S, D], aux, n_prefix)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"],
                                 device=params.embed.device).long()
        x = _embed_tokens(params, tokens, cfg)
        s = x.shape[1]
        rope = common.make_rope(torch.arange(s, device=x.device),
                                cfg.head_dim, cfg.rope_theta, cfg.rope_style)
        x, aux = blocks.stack_forward(params.blocks, x, cfg, rope,
                                      causal=True, remat=remat, mode=mode)
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps, mode)
        return x, aux, 0

    def loss(self, params: LMParams, batch, remat: bool = True,
             mode: Optional[str] = None):
        """(total loss, {"nll", "aux"}): next-token NLL of
        ``batch["tokens"]`` [B, S] with the z-loss."""
        cfg = self.cfg
        x, aux, n_prefix = self.hidden(params, batch, remat, mode)
        x = x[:, n_prefix:]
        tokens = torch.as_tensor(batch["tokens"], device=x.device).long()
        labels = tokens[:, 1:]
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=x.device)
        nll = chunked_nll(params, x[:, :-1], labels, mask, cfg)
        aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
        return nll + aux_w * aux, {"nll": nll, "aux": aux}

    def logits(self, params: LMParams, batch, mode: Optional[str] = None):
        x, _, n_prefix = self.hidden(params, batch, remat=False, mode=mode)
        out = _head_logits(params, x[:, n_prefix:], self.cfg)
        return out[..., :self.cfg.vocab_size]

    # ---------------------------------------------------------- serve
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
        x = _embed_tokens(params, torch.as_tensor(tokens, device=dev), cfg)
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
            "serves and trains dense decoder LMs)")


def build_model(cfg: ModelConfig) -> CausalLM:
    _check_supported(cfg)
    return CausalLM(cfg)


def params_from_numpy(cfg: ModelConfig, tree: Mapping, device=None,
                      trainable: bool = False) -> LMParams:
    """Carry a JAX ``CausalLM.init`` tree (as numpy arrays, with the JAX
    key paths) into port params on ``device``: cast to the compute dtype
    for serving, or kept in ``param_dtype`` with gradients where
    ``trainable``.

    ``embed [Vp, D]``, ``head [D, Vp]``, ``final_norm [D]``; every
    ``blocks/pos0/...`` leaf has a leading ``[n_layers]`` axis, sliced
    here into one module per layer."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = cfg.pdtype() if trainable else cfg.cdtype()

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
    params = LMParams(t(tree["embed"]), layers, t(tree["final_norm"]),
                      None if cfg.tie_embeddings else t(tree["head"]))
    return params.requires_grad_(trainable)
