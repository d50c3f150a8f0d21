"""Encoder-decoder LM (the whisper-medium backbone), the port of the JAX
package's ``repro/models/whisper.py``.

The conv/mel frontend is a stub, as in the JAX package: ``frames`` arrive
as precomputed ``[B, T_enc, D]`` embeddings (f32, cast to the compute
dtype).  The encoder adds sinusoidal positions and runs non-causal dense
attention layers with no rotary embedding; the decoder is the causal
stack with RoPE (the JAX package's choice, not Whisper's learned
positions) and, in every layer, cross-attention against the encoder's
K/V (``blocks.LayerDesc.cross``).

The params are ``lm.EncDecParams``: ``LMParams`` (embed, the decoder
``blocks``, ``final_norm``, ``head``) plus ``enc_blocks`` and
``enc_norm``.  The serving cache is ``{"self": <one {"k", "v"} a decoder
layer>, "cross": <one {"k", "v"} [B, T_enc, Hkv, dh] a decoder layer>}``.

``hidden`` (and so the inherited ``loss`` and ``logits``) runs the
encoder and the decoder with its cross-attention.  The JAX package's
``EncDecLM.loss`` is the same function (its aux weight is 0, as
``CausalLM.loss``'s is for a model without experts); its inherited
``EncDecLM.logits`` runs the decoder without the encoder (its
``hidden`` passes no cross K/V), which the port does not copy.

Prefill, a decision against the reference: the JAX ``EncDecLM.prefill``
runs ``blocks.stack_forward`` and returns ``init_cache`` zeros as the
self-attention cache, so a decode step after it attends to empty keys.
The port's ``prefill`` walks the decoder once with
``blocks.stack_prefill(..., cross_kv=...)``, as the JAX package's own
``blocks.stack_prefill`` (which takes ``cross_kv``) would: the logits are
the JAX prefill's, the self cache is filled at ``[0, S)``, and prefill
plus decode gives the full forward's logits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, blocks, common
from repro_torch.models.lm import (CausalLM, EncDecParams, _embed_tokens,
                                   _head_logits, _refuse_sharded_prefill)

__all__ = ["EncDecLM", "encoder_config"]


def _sinusoid(t: int, d: int, device=None) -> torch.Tensor:
    """[t, d] f32 positions: sin then cos of pos · 10000^(-i / (d/2 - 1)),
    the JAX package's divisor."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    log_base = torch.log(torch.tensor(10000.0, device=device))
    ang = pos * torch.exp(-dim * (log_base / (d // 2 - 1)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder's stack: ``n_enc_layers`` dense attention layers, no
    cross-attention, no rotary embedding."""
    return dataclasses.replace(cfg, n_layers=cfg.n_enc_layers, encdec=False,
                               rope_style="none")


@dataclasses.dataclass(frozen=True)
class EncDecLM(CausalLM):
    """cfg.n_layers = decoder depth; cfg.n_enc_layers = encoder depth."""

    def init(self, seed: int = 0, device=None,
             trainable: bool = False) -> EncDecParams:
        """As ``CausalLM.init``, with the encoder's stack and norm."""
        cfg = self.cfg
        dev, gen, dt = self._draw(seed, device, trainable)
        embed = common.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt,
                                  dev)
        enc = blocks.init_stack(gen, encoder_config(cfg), dt, dev)
        layers = blocks.init_stack(gen, cfg, dt, dev)
        head = common.dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                 dtype=dt, device=dev)

        def ones():
            return torch.ones(cfg.d_model, dtype=dt, device=dev)
        params = EncDecParams(embed, layers, ones(), head, enc, ones())
        return params.requires_grad_(trainable)

    # --------------------------------------------------------- encoder
    def encode(self, params: EncDecParams, frames, remat: bool = True,
               mode: Optional[str] = None) -> torch.Tensor:
        """frames [B, T, D] → the normed encoder output [B, T, D] in the
        compute dtype."""
        cfg = self.cfg
        x = torch.as_tensor(frames, device=params.embed.device).to(
            cfg.cdtype())
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        x, _ = blocks.stack_forward(params.enc_blocks, x, encoder_config(cfg),
                                    None, causal=False, remat=remat,
                                    mode=mode)
        return common.rms_norm(x, params.enc_norm, cfg.norm_eps, mode)

    def cross_kv(self, params: EncDecParams,
                 enc_out: torch.Tensor) -> list[dict[str, torch.Tensor]]:
        """Each decoder layer's cross K/V ``{"k", "v"}`` [B, T, Hkv, dh]."""
        return [attention.encoder_kv(layer.cross, enc_out, self.cfg)
                for layer in params.blocks]

    def _context(self, params: EncDecParams, batch, remat: bool,
                 mode: Optional[str]):
        """(the embedded decoder tokens [B, S, D], their rope, the cross
        K/V of ``batch["frames"]``)."""
        cfg = self.cfg
        kv = self.cross_kv(params, self.encode(params, batch["frames"],
                                               remat, mode))
        x, _ = self._inputs(params, batch)
        rope = common.make_rope(torch.arange(x.shape[1], device=x.device),
                                cfg.head_dim, cfg.rope_theta, cfg.rope_style)
        return x, rope, kv

    # ------------------------------------------------------------ train
    def hidden(self, params: EncDecParams, batch, remat: bool = True,
               mode: Optional[str] = None, run=None, ctx=None):
        """(final-normed decoder states [B, S, D], aux, 0): the encoder on
        ``batch["frames"]``, then the decoder on ``batch["tokens"]`` with
        cross-attention to it; ``run``: how a decoder layer runs
        (``blocks.stack_forward``)."""
        cfg = self.cfg
        x, rope, kv = self._context(params, batch, remat, mode)
        x, aux = blocks.stack_forward(params.blocks, x, cfg, rope,
                                      causal=True, remat=remat, mode=mode,
                                      cross_kv=kv, run=run, ctx=ctx)
        return common.rms_norm(x, params.final_norm, cfg.norm_eps,
                               mode), aux, 0

    # ------------------------------------------------------------ serve
    def prefill(self, params: EncDecParams, batch,
                max_len: Optional[int] = None, mode: Optional[str] = None,
                ctx=None):
        """The encoder, then one walk over the decoder that fills the self
        cache at [0, S) (see the module docstring).  Returns (the last
        position's logits [B, vocab_size], ``{"self", "cross"}``)."""
        _refuse_sharded_prefill(ctx)
        cfg = self.cfg
        with torch.no_grad():
            x, rope, kv = self._context(params, batch, False, mode)
            cache = self.init_cache(x.shape[0], max_len or cfg.max_seq,
                                    device=x.device)
            x, cache = blocks.stack_prefill(params.blocks, cache, x, cfg,
                                            rope, mode, cross_kv=kv)
            x = common.rms_norm(x, params.final_norm, cfg.norm_eps, mode)
            logits = _head_logits(params, x[:, -1:], cfg)
        return logits[:, 0, :cfg.vocab_size], {"self": cache, "cross": kv}

    def decode_step(self, params: EncDecParams, tokens: torch.Tensor,
                    cache, pos, mode: Optional[str] = None, ctx=None,
                    shards: int = 1):
        """As ``CausalLM.decode_step`` on ``cache["self"]`` (updated in
        place; sequence-sharded as there), with cross-attention to
        ``cache["cross"]``."""
        cfg = self.cfg
        dev = params.embed.device
        x = _embed_tokens(params, torch.as_tensor(tokens, device=dev), cfg)
        pos = torch.as_tensor(pos, device=dev).long()
        rope = common.make_rope(pos[:, None] if pos.ndim else pos[None],
                                cfg.head_dim, cfg.rope_theta,
                                cfg.rope_style)
        x, new_self = blocks.stack_decode(params.blocks, cache["self"], x,
                                          cfg, rope, pos, mode,
                                          cross_kv=cache["cross"], ctx=ctx,
                                          shards=shards)
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps, mode)
        return (_head_logits(params, x, cfg)[:, 0, :cfg.vocab_size],
                {"self": new_self, "cross": cache["cross"]})
