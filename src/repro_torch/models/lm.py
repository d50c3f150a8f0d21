"""Causal LM for decoder-only models (dense, MoE, SSM, hybrid and VLM):
``init`` → params, the train path (``hidden``, ``loss``, ``logits``,
``chunked_nll``) and the serving path (``init_cache``,
``prefill(params, batch)`` → (last logits, cache),
``decode_step(params, tokens, cache, pos)`` → (logits, cache)).
``build_model`` gives the encoder-decoder ``whisper.EncDecLM`` for an
``encdec`` config, whose params are ``EncDecParams``.

batch keys: ``tokens`` [B, S]; for a VLM optionally ``prefix_embeds``
[B, Np, D] (the vision frontend's output, a stub here as in the JAX
package), cast to the compute dtype and put before the tokens; for
Whisper ``frames`` [B, T_enc, D] (the audio frontend's stub output).

For serving, weights are stored in the compute dtype without gradients.
The JAX package keeps them in ``param_dtype`` (f32) and casts each
weight to the compute dtype at use; storing the cast once is the same
rounding, and on the card it halves the bytes every decode step reads.
For training (``trainable=True``) they are stored in ``param_dtype``
with gradients and cast at use, as the JAX package does; every family
trains.  Mamba-2's ``dt_bias``, ``a_log`` and ``d_skip`` are f32 in
both, as the JAX package keeps them.
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
from repro_torch.models import attention, blocks, common, ffn, mamba2, moe

__all__ = ["LMParams", "EncDecParams", "norm_calls", "CausalLM",
           "build_model", "param_paths", "params_from_numpy"]


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


class EncDecParams(LMParams):
    """``LMParams`` of the decoder (its layers with cross-attention) plus
    the encoder: ``enc_blocks`` (one ``blocks.Layer`` per encoder layer)
    and ``enc_norm`` [D]."""

    def __init__(self, embed: torch.Tensor, layers: nn.ModuleList,
                 final_norm: torch.Tensor, head: torch.Tensor,
                 enc_blocks: nn.ModuleList, enc_norm: torch.Tensor):
        super().__init__(embed, layers, final_norm, head)
        self.enc_blocks = enc_blocks
        self.enc_norm = nn.Parameter(enc_norm, requires_grad=False)


def norm_calls(params: LMParams) -> int:
    """rmsnorm calls of one forward over ``params``: the decoder stack's
    (``blocks.norm_calls``) and the final norm, and a Whisper encoder's
    stack and ``enc_norm``."""
    n = blocks.norm_calls(params.blocks) + 1
    if isinstance(params, EncDecParams):
        n += blocks.norm_calls(params.enc_blocks) + 1
    return n


def _embed_tokens(params: LMParams, tokens: torch.Tensor,
                  cfg: ModelConfig, ctx=None) -> torch.Tensor:
    """The tokens' rows of the embedding.  In a tensor-parallel forward
    ``embed`` holds this rank's rows of the vocabulary (the rules' ``P(model,
    None)``): a token outside them gives zeros, and the ranks' sum is the
    lookup (``CausalLM._inputs``)."""
    # cast, then gather, as the JAX package: the gradient of the gather
    # accumulates in the compute dtype there too
    w = params.embed.to(cfg.cdtype())
    if not common.tensor_parallel(ctx):
        return w[tokens]
    vl = w.shape[0]
    local = tokens - ctx.tp_rank * vl
    mine = (local >= 0) & (local < vl)
    return w[local.clamp(0, vl - 1)] * mine[..., None].to(w.dtype)


def _head_logits(params: LMParams, x: torch.Tensor, cfg: ModelConfig,
                 dtype=None) -> torch.Tensor:
    """x's logits, the product in ``dtype`` (default x's: the f32 rows of
    ``common.tp_enter`` narrowed by ``common.entry_mm``)."""
    dt = dtype or x.dtype
    if cfg.tie_embeddings:
        return common.entry_mm(x, params.embed.T, dt)
    return common.entry_mm(x, params.head, dt)


def _chunk_nll(params: LMParams, xs, ls, ms, cfg: ModelConfig, ctx=None,
               dtype=None):
    logits = _head_logits(params, xs, cfg, dtype).float()
    if common.tensor_parallel(ctx):
        return _VocabNLL.apply(logits, ls, ms, cfg.vocab_size, ctx), ms.sum()
    if cfg.padded_vocab != cfg.vocab_size:      # mask pad columns
        pad = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = logits.masked_fill(pad >= cfg.vocab_size, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, ls[..., None].long())[..., 0]
    nll = (lse - ll + 1e-4 * lse ** 2) * ms
    return nll.sum(), ms.sum()


class _VocabNLL(torch.autograd.Function):
    """Σ (lse − ll + 1e-4·lse²) · mask over a chunk whose f32 logits
    [B, cs, Vp / tp] are this rank's columns of the vocabulary (rank r
    holds columns [r·Vp/tp, (r+1)·Vp/tp)): the pad columns past
    ``vocab_size`` masked at -1e30, the rows' maximum all-reduced (max)
    over the model group, then their sums of exp and the label's logit
    (from the rank that holds it, 0 elsewhere) all-reduced in one; lse =
    max + log(sum).  The result is equal on every rank.  Backward: this
    rank's columns of (softmax · (1 + 2e-4·lse) − onehot(label)) · mask
    · g, with no collective."""

    @staticmethod
    def forward(fctx, logits, labels, mask, vocab: int, ctx):
        from repro_torch.sharding import collectives
        vl = logits.shape[-1]
        lo = ctx.tp_rank * vl
        cols = torch.arange(lo, lo + vl, device=logits.device)
        logits = logits.masked_fill(cols >= vocab, -1e30)
        m = logits.amax(dim=-1)
        collectives.all_reduce(m, ctx.tp_group, op="max", axis=ctx.tp_axis)
        local = labels.long() - lo
        mine = (local >= 0) & (local < vl)
        idx = local.clamp(0, vl - 1)
        ll = torch.gather(logits, -1, idx[..., None])[..., 0]
        both = torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                            torch.where(mine, ll, torch.zeros_like(ll))])
        collectives.all_reduce(both, ctx.tp_group, axis=ctx.tp_axis)
        lse = m + torch.log(both[0])
        nll = (lse - both[1] + 1e-4 * lse ** 2) * mask
        fctx.save_for_backward(logits, lse, idx, mine, mask)
        return nll.sum()

    @staticmethod
    def backward(fctx, g):
        logits, lse, idx, mine, mask = fctx.saved_tensors
        w = (g * mask)[..., None]
        d = torch.exp(logits - lse[..., None]) * (1 + 2e-4 * lse)[..., None]
        d.scatter_add_(-1, idx[..., None], -mine[..., None].to(d.dtype))
        return d * w, None, None, None, None


def chunked_nll(params: LMParams, x, labels, mask, cfg: ModelConfig,
                n_chunks: int = 8, ctx=None, dtype=None):
    """Cross-entropy without materializing [B,S,V] at once: the sequence
    in chunks, each under activation checkpointing (memory: B*S/n*V per
    chunk), with the z-loss 1e-4·lse² and pad columns masked at -1e30.
    In a tensor-parallel forward x [B, S, D] is whole on every rank and
    the head this rank's columns of the vocabulary (``head``'s
    ``P(None, model)`` or, tied, ``embed``'s rows): each chunk's logits
    stay vocab-sharded (:class:`_VocabNLL`).  ``dtype``: the head
    product's (default x's)."""
    b, s, d = x.shape
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * cs, (i + 1) * cs)
        s_nll, s_cnt = checkpoint(_chunk_nll, params, x[:, sl],
                                  labels[:, sl], mask[:, sl], cfg, ctx,
                                  dtype, use_reentrant=False)
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
        with gradients where ``trainable``.  On ``device="meta"`` nothing
        is drawn (meta has no generator): shapes and dtypes only, as
        ``launch.steps.abstract_params`` wants them."""
        cfg = self.cfg
        dev, gen, dt = self._draw(seed, device, trainable)
        embed = common.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt,
                                  dev)
        layers = blocks.init_stack(gen, cfg, dt, dev)
        head = (None if cfg.tie_embeddings else common.dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), dtype=dt, device=dev))
        params = LMParams(embed, layers,
                          torch.ones(cfg.d_model, dtype=dt, device=dev), head)
        return params.requires_grad_(trainable)

    def _draw(self, seed: int, device, trainable: bool):
        """(device, its ``torch.Generator`` seeded with ``seed`` or None on
        meta, the weights' dtype) for ``init``."""
        dev = resolve_device(device)
        gen = None
        if dev.type != "meta":
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        return dev, gen, (self.cfg.pdtype() if trainable
                          else self.cfg.cdtype())

    def _inputs(self, params: LMParams, batch, ctx=None):
        """(the embedded inputs [B, Np + S, D], Np): a VLM's
        ``prefix_embeds`` cast to the compute dtype before the tokens'
        embeddings; Np = 0 without them.  In a tensor-parallel forward
        each rank's partial lookup (the prefix on model rank 0, zeros on
        the others) is summed over the model group by ``common.tp_exit``:
        reduce-scattered to this rank's S / tp rows where the sequence
        is sharded, else all-reduced.  Every partial sum has one nonzero
        term, so the sum is the lookup exactly."""
        cfg = self.cfg
        dev = params.embed.device
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        x = _embed_tokens(params, tokens, cfg, ctx)
        n_prefix = 0
        if cfg.n_prefix_embeds and "prefix_embeds" in batch:
            pre = torch.as_tensor(batch["prefix_embeds"],
                                  device=dev).to(x.dtype)
            if common.tensor_parallel(ctx) and ctx.tp_rank:
                pre = torch.zeros_like(pre)
            x = torch.cat([pre, x], dim=1)
            n_prefix = pre.shape[1]
        return common.tp_exit(x, ctx), n_prefix

    # ---------------------------------------------------------- train
    def hidden(self, params: LMParams, batch, remat: bool = True,
               mode: Optional[str] = None, run=None, ctx=None):
        """(final-normed hidden states [B, Np + S, D], aux, n_prefix);
        ``run``: how a layer runs (``blocks.stack_forward``); ``ctx``: the
        mesh context of a sharded step.  With a model axis of more than
        one rank the forward is tensor-parallel (``common.tp_layout``) and
        the states are this rank's S / tp rows where the sequence is
        sharded."""
        cfg = self.cfg
        s = seq_len(cfg, batch)
        ctx = common.tp_layout(ctx, s)
        x, n_prefix = self._inputs(params, batch, ctx)
        rope = common.make_rope(torch.arange(s, device=x.device),
                                cfg.head_dim, cfg.rope_theta, cfg.rope_style)
        x, aux = blocks.stack_forward(params.blocks, x, cfg, rope,
                                      causal=True, remat=remat, mode=mode,
                                      run=run, ctx=ctx)
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps, mode)
        return x, aux, n_prefix

    def loss(self, params: LMParams, batch, remat: bool = True,
             mode: Optional[str] = None, run=None, ctx=None):
        """(total loss, {"nll", "aux"}): next-token NLL of
        ``batch["tokens"]`` [B, S] with the z-loss; ``run``: how a layer
        runs (``blocks.stack_forward``); ``ctx``: the mesh context of a
        sharded step (:meth:`hidden`).  In a tensor-parallel forward the
        final norm's rows are made whole (``common.tp_enter``) for the
        vocab-parallel head and loss (``chunked_nll``)."""
        cfg = self.cfg
        x, aux, n_prefix = self.hidden(params, batch, remat, mode, run, ctx)
        ctx = common.tp_layout(ctx, seq_len(cfg, batch))
        dtype = x.dtype
        x = common.tp_enter(x, ctx)[:, n_prefix:]
        tokens = torch.as_tensor(batch["tokens"], device=x.device).long()
        labels = tokens[:, 1:]
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=x.device)
        nll = chunked_nll(params, x[:, :-1], labels, mask, cfg, ctx=ctx,
                          dtype=dtype)
        aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
        return nll + aux_w * aux, {"nll": nll, "aux": aux}

    def logits(self, params: LMParams, batch, mode: Optional[str] = None):
        x, _, n_prefix = self.hidden(params, batch, remat=False, mode=mode)
        out = _head_logits(params, x[:, n_prefix:], self.cfg)
        return out[..., :self.cfg.vocab_size]

    # ---------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, device=None,
                   ctx=None) -> list[dict[str, torch.Tensor]]:
        """Every layer's cache (``blocks.init_stack_cache``); a collective
        ``ctx`` (its model axis the decode's ``shards`` wide) gives this
        rank's slice of each attention cache's sequence."""
        return blocks.init_stack_cache(self.cfg, batch, max_len,
                                       self.cfg.cdtype(),
                                       resolve_device(device), ctx)

    def prefill(self, params: LMParams, batch, max_len: Optional[int] = None,
                mode: Optional[str] = None, ctx=None):
        """Single-pass prefill of ``batch["tokens"]`` [B, S] (after a
        VLM's ``prefix_embeds`` [B, Np, D]): hidden states and the caches
        from one walk over the layers.  Returns (the last position's
        logits [B, vocab_size], the cache of ``max_len`` (default
        ``cfg.max_seq``) positions, attention's filled at [0, Np + S),
        Mamba-2's the state after the sequence).  The next decode
        position is Np + S.  ``mode="ref"`` runs every kernel's plain
        version.  Prefill runs unsharded, as the JAX one does: a ctx
        whose model axis has more than one rank raises rather than write
        a whole cache where each rank holds a slice."""
        _refuse_sharded_prefill(ctx)
        cfg = self.cfg
        dev = params.embed.device
        with torch.no_grad():
            x, _ = self._inputs(params, batch)
            b, s = x.shape[:2]
            rope = common.make_rope(torch.arange(s, device=dev),
                                    cfg.head_dim, cfg.rope_theta,
                                    cfg.rope_style)
            cache = self.init_cache(b, max_len or cfg.max_seq, device=dev)
            x, cache = blocks.stack_prefill(params.blocks, cache, x, cfg,
                                            rope, mode, ctx=ctx)
            x = common.rms_norm(x, params.final_norm, cfg.norm_eps, mode)
            logits = _head_logits(params, x[:, -1:], cfg)
        return logits[:, 0, :cfg.vocab_size], cache

    def decode_step(self, params: LMParams, tokens: torch.Tensor, cache,
                    pos, mode: Optional[str] = None, ctx=None,
                    shards: int = 1):
        """tokens: [B, 1]; pos: scalar current length, or a [B] vector of
        per-row lengths (ragged continuous batching).  The cache is
        updated in place and returned.  ``mode="ref"`` runs every kernel's
        plain version (for comparison on the card).  ``shards > 1`` runs
        the sequence-sharded flash-decode: collectively over ``ctx``'s
        model axis where it is ``shards`` wide (the cache from
        ``init_cache(..., ctx=ctx)``), else the static split."""
        cfg = self.cfg
        dev = params.embed.device
        x = _embed_tokens(params, torch.as_tensor(tokens, device=dev), cfg)
        pos = torch.as_tensor(pos, device=dev).long()
        rope = common.make_rope(pos[:, None] if pos.ndim else pos[None],
                                cfg.head_dim, cfg.rope_theta,
                                cfg.rope_style)
        x, cache = blocks.stack_decode(params.blocks, cache, x, cfg, rope,
                                       pos, mode, ctx=ctx, shards=shards)
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps, mode)
        return _head_logits(params, x, cfg)[:, 0, :cfg.vocab_size], cache


def seq_len(cfg: ModelConfig, batch) -> int:
    """The positions the layers run over: a VLM's prefix and the
    tokens."""
    s = batch["tokens"].shape[1]
    if cfg.n_prefix_embeds and "prefix_embeds" in batch:
        s += batch["prefix_embeds"].shape[1]
    return s


def _refuse_sharded_prefill(ctx) -> None:
    if ctx is not None and ctx.tp > 1:
        raise NotImplementedError(
            "prefill runs unsharded and writes a whole cache; under a "
            f"model axis of {ctx.tp} ranks each rank's cache is a slice of "
            "the sequence: prefill through the engine's decode steps")


def build_model(cfg: ModelConfig) -> CausalLM:
    if cfg.encdec:
        from repro_torch.models.whisper import EncDecLM
        return EncDecLM(cfg)
    return CausalLM(cfg)


_ATTN = ("wq", "wk", "wv", "wo")
_MAMBA = ("in_proj", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip",
          "norm", "out_proj")
_MOE = ("router", "w_in", "w_gate", "w_out")


def param_paths(cfg: ModelConfig) -> dict[str, tuple[tuple[str, ...],
                                                     Optional[int]]]:
    """The JAX package's place of each port parameter: ``{port name:
    (key path in the JAX ``init`` tree, index into its stacked lead or
    None)}``.  Layer ``l`` of a stack of period P is index ``l // P`` of
    the leaves under ``pos{l % P}``; the JAX spec of a stacked leaf is the
    port's with a lead None (``sharding.rules``)."""
    def stack(prefix: str, scfg: ModelConfig) -> dict:
        out = {}
        descs = blocks.layer_descriptors(scfg)
        for layer in range(scfg.n_layers):
            desc, i = descs[layer % len(descs)], layer // len(descs)
            jp = (prefix, f"pos{layer % len(descs)}")
            name = f"{prefix}.{layer}."

            def put(*keys):
                out[name + ".".join(keys)] = (jp + keys, i)
            put("norm1")
            for k in (_ATTN if desc.mixer == "attn" else _MAMBA):
                put(desc.mixer, k)
            if desc.cross:
                put("norm_x")
                for k in _ATTN:
                    put("cross", k)
            if desc.ffn != "none":
                put("norm2")
            ffn_keys = ("w_in", "w_out") + (
                ("w_gate",) if scfg.act == "swiglu" else ())
            if desc.ffn == "moe":
                for k in _MOE:
                    put("moe", k)
                if scfg.moe.dense_residual:
                    for k in ffn_keys:
                        put("moe", "dense", k)
            elif desc.ffn == "dense":
                for k in ffn_keys:
                    put("ffn", k)
        return out

    paths = {"embed": (("embed",), None),
             "final_norm": (("final_norm",), None)}
    if not cfg.tie_embeddings:
        paths["head"] = (("head",), None)
    paths.update(stack("blocks", cfg))
    if cfg.encdec:
        from repro_torch.models.whisper import encoder_config
        paths["enc_norm"] = (("enc_norm",), None)
        paths.update(stack("enc_blocks", encoder_config(cfg)))
    return paths


def params_from_numpy(cfg: ModelConfig, tree: Mapping, device=None,
                      trainable: bool = False) -> LMParams:
    """Carry a JAX ``CausalLM.init`` or ``EncDecLM.init`` tree (as numpy
    arrays, with the JAX key paths) into port params on ``device``: cast
    to the compute dtype for serving, or kept in ``param_dtype`` with
    gradients where ``trainable``; Mamba-2's ``dt_bias``, ``a_log`` and
    ``d_skip`` stay f32 in both.

    ``embed [Vp, D]``, ``head [D, Vp]``, ``final_norm [D]``; every
    ``blocks/pos{i}/...`` leaf has a leading ``[n_periods]`` axis, and
    layer ``l`` is period ``l // P`` of position ``l % P``
    (:func:`param_paths`).  An encdec tree adds ``enc_blocks/pos0/...``
    (leaves ``[n_enc_layers, ...]``) and ``enc_norm [D]``, and its decoder
    layers ``norm_x`` and ``cross/{wq, wk, wv, wo}`` (``EncDecParams``)."""
    dev = resolve_device(device)
    dt = cfg.pdtype() if trainable else cfg.cdtype()
    leaves = {}
    for name, (path, i) in param_paths(cfg).items():
        a = tree
        for k in path:
            a = a[k]
        a = np.asarray(a if i is None else a[i])
        f32 = "mamba" in path and path[-1] in mamba2.F32_PARAMS
        leaves[name] = torch.tensor(a).to(dev, torch.float32 if f32 else dt)

    def attn(pre) -> attention.Attention:
        return attention.Attention(*(leaves[pre + k] for k in _ATTN))

    def dense_ffn(pre) -> ffn.FFN:
        return ffn.FFN(leaves[pre + "w_in"], leaves[pre + "w_out"],
                       leaves.get(pre + "w_gate"))

    def stack(prefix: str, scfg: ModelConfig) -> nn.ModuleList:
        layers = nn.ModuleList()
        for layer, desc in enumerate(blocks.stack_descriptors(scfg)):
            pre = f"{prefix}.{layer}."
            if desc.mixer == "attn":
                mixer = attn(pre + "attn.")
            else:
                mixer = mamba2.Mamba(*(leaves[pre + "mamba." + k]
                                       for k in _MAMBA))
            f = None
            if desc.ffn == "moe":
                f = moe.MoE(*(leaves[pre + "moe." + k] for k in _MOE),
                            dense_ffn(pre + "moe.dense.")
                            if pre + "moe.dense.w_in" in leaves else None)
            elif desc.ffn == "dense":
                f = dense_ffn(pre + "ffn.")
            cross = attn(pre + "cross.") if desc.cross else None
            layers.append(blocks.Layer(
                leaves[pre + "norm1"], mixer, leaves.get(pre + "norm2"), f,
                leaves.get(pre + "norm_x"), cross))
        return layers

    head = leaves.get("head")
    layers = stack("blocks", cfg)
    if cfg.encdec:
        from repro_torch.models.whisper import encoder_config
        params = EncDecParams(leaves["embed"], layers, leaves["final_norm"],
                              head, stack("enc_blocks", encoder_config(cfg)),
                              leaves["enc_norm"])
    else:
        params = LMParams(leaves["embed"], layers, leaves["final_norm"],
                          head)
    return params.requires_grad_(trainable)
