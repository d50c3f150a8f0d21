"""ZeRO-3 over the mesh's ``data`` axis: each rank keeps its shard of
every parameter the sharding rules cut over ``data`` (and of its AdamW
moments), and a layer's whole weights exist only while that layer runs.

``shard_params_`` swaps each such parameter's storage for this rank's
shard (``sharding.layout``: ``ceil(D / n)`` entries of the cut dim, the
last shards zero-padded).  :class:`Runner` is the layer runner the train
step hands ``blocks.stack_forward`` (through the model's ``loss``): it
runs every layer that holds a shard through the layer's
:class:`LayerGather`, whose forward casts each shard to the compute dtype
(half the bytes of gathering f32 in a 16-bit model, the same values
since the cast is elementwise), all-gathers it over ``data`` and runs
the layer on the whole weights (``torch.func.functional_call``); its
backward reduce-scatters each whole weight's gradient, in f32, back to
the shard and divides it by the ``data`` size.  Under activation
checkpointing the gather reruns in the backward pass, as in ZeRO-3, so
one layer's whole weights and their gradients live at a time.

The rules shard only per-layer weights over ``data``; the embedding, the
head and every norm gain stay whole over ``data`` on each rank (their
gradients are averaged by the train step).  On a ``model`` axis of more
than one rank the rules also cut the Megatron blocks over ``model``
(``wq``, ``wk``, ``wv``, ``w_in``, ``w_gate`` by columns, ``wo`` and
``w_out`` by rows, ``embed`` and ``head`` by the vocabulary) and a MoE's
experts (``E / tp`` a rank, expert parallelism): each rank keeps its
``data`` piece of its ``model`` block, and the gather and the
reduce-scatter run over ``data`` alone, within the block, so the layer
runs on its whole ``model`` block (the tensor-parallel forward,
``models.common.tp_layout``).  A head count the ``model`` ranks do not
divide keeps the attention weights whole (the sequence-sharded
attention, ``models.attention.attn_seqshard``).  Refused, each naming its
ROADMAP entry: a vocabulary the ``model`` ranks do not divide, and the
encoder-decoder.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import _layer_forward
from repro_torch.sharding import collectives, rules
from repro_torch.sharding.layout import Shard, shard_of

__all__ = ["layout", "shard_params_", "LayerGather", "Runner",
           "sharded_names", "cut_axes", "model_partial"]

_META = torch.device("meta")


def _refuse(cfg: ModelConfig, ctx) -> None:
    item = "ROADMAP.md Queue 1 item 4"
    if ctx.tp > 1 and cfg.padded_vocab % ctx.tp:
        raise NotImplementedError(
            f"a vocabulary of {cfg.padded_vocab} rows over a model axis of "
            f"{ctx.tp} ranks: the rules cut the embedding by d_model then, "
            f"which is not ported ({item}, the odd-model vocabulary cut)")
    if cfg.encdec:
        raise NotImplementedError(
            "sharded training of an encoder-decoder: the decoder's cross "
            "K/V are computed outside the layers' runs, where ZeRO-3 "
            f"gathers their weights ({item}, Whisper's sharded training)")


def layout(model, ctx) -> dict[str, Shard]:
    """``{parameter name: Shard}`` of ``model``'s trainable parameters on
    ``ctx``'s mesh, for this rank, from the sharding rules (training:
    ZeRO-3 over ``data``, tensor parallelism over ``model``)."""
    cfg = model.cfg
    _refuse(cfg, ctx)
    meta = model.init(device=_META, trainable=True)
    specs = rules.param_specs(meta, cfg, ctx.mesh)
    out = {}
    for name, p in meta.named_parameters():
        sh = shard_of(tuple(p.shape), specs[name], ctx.mesh)
        if any(a not in (("data",), ("model",)) for a in sh.axes):
            raise NotImplementedError(
                f"{name}: spec {sh.spec} cuts it over {sh.axes}; the "
                "sharded step cuts a dim over 'data' or 'model' alone")
        out[name] = sh
    return out


def cut_axes(sh: Shard) -> tuple[str, ...]:
    """The mesh axes a leaf is cut over."""
    return tuple(a for axes in sh.axes for a in axes)


def _data_cut(sh: Shard):
    """(dim, pieces) of the leaf's cut over ``data``, or None."""
    for (dim, n, _), axes in zip(sh.cuts, sh.axes):
        if axes == ("data",):
            return dim, n
    return None


def sharded_names(shards: dict[str, Shard]) -> frozenset:
    """The parameters cut over ``data``: ZeRO-3's shards, whose gradients
    come out of their layer's gather reduce-scattered."""
    return frozenset(n for n, s in shards.items()
                     if _data_cut(s) is not None)


def model_partial(cfg: ModelConfig, ctx,
                  seq_sharded: bool) -> Callable[[str], bool]:
    """``partial(name) → bool``: whether each model rank's gradient of the
    parameter ``name`` (whole over ``model``) is a part of it, to be
    summed over ``model``: the norm gains where the layer boundaries are
    sequence-sharded (each rank's S / tp rows), and, where the ranks
    divide the heads, ``wk`` / ``wv`` where the rules leave them whole
    (each rank projects its query heads' KV heads).  Every other leaf's
    gradient is whole on each rank: a ``model`` block's is its block's; a
    part the rules keep whole (Mamba-2, an FFN the ranks do not divide,
    attention over an unsharded sequence of undivided heads, experts
    the ranks do not divide) runs whole on every rank; and the parts of
    the sequence-sharded attention's weights and of an expert-parallel
    MoE's router are summed over ``model`` in the layer's backward
    (``models.common.model_summed``)."""
    if ctx.tp == 1:
        return lambda name: False
    kv_whole = (cfg.n_heads % ctx.tp == 0
                and cfg.n_kv_heads % ctx.tp != 0)
    norms = ("norm1", "norm2", "norm_x", "final_norm")

    def partial(name: str) -> bool:
        leaf = name.rsplit(".", 1)[-1]
        if seq_sharded and leaf in norms:
            return True
        return kv_whole and name.endswith(("attn.wk", "attn.wv"))
    return partial


class _Gather(torch.autograd.Function):
    """Forward: a layer's whole weights from this rank's shards.
    Backward: each whole gradient's reduce-scatter back to the shard."""

    @staticmethod
    def forward(ctx, plan: "LayerGather", *shards):
        ctx.plan = plan
        return tuple(plan.gather(i, s) for i, s in enumerate(shards))

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        return (None,) + tuple(plan.scatter(i, g)
                               for i, g in enumerate(grads))


class LayerGather:
    """The ZeRO-3 gather of one layer: ``names`` (relative to the layer)
    of its parameters cut over ``data``, each one's :class:`Shard`, the
    ``data`` group and the dtype the weights are gathered in.  A leaf cut
    over ``model`` too is gathered to its ``model`` block."""

    def __init__(self, names: list[str], shards: list[Shard], group,
                 dtype: torch.dtype):
        self.names, self.shards = names, shards
        self.cuts = [_data_cut(sh) for sh in shards]
        self.group, self.dtype = group, dtype

    def __call__(self, layer, *args):
        """``_layer_forward(layer, *args)`` on the gathered weights."""
        local = [layer.get_parameter(n) for n in self.names]
        whole = _Gather.apply(self, *local)
        return functional_call(_Call(layer), {
            "layer." + n: w for n, w in zip(self.names, whole)}, args)

    def gather(self, i: int, shard: torch.Tensor) -> torch.Tensor:
        return self.shards[i].block(shard.detach().to(self.dtype), "data",
                                    self.group)

    def scatter(self, i: int, grad: torch.Tensor) -> torch.Tensor:
        sh = self.shards[i]
        dim, n = self.cuts[i]
        c = -(-sh.shape[dim] // n)
        g = grad.float()
        if c * n != sh.shape[dim]:
            pad = list(g.shape)
            pad[dim] = c * n - sh.shape[dim]
            g = torch.cat([g, g.new_zeros(pad)], dim=dim)
        split = list(g.shape)
        split[dim:dim + 1] = [n, c]
        pieces = g.reshape(split).movedim(dim, 0).contiguous()
        out = torch.empty(pieces.shape[1:], dtype=torch.float32,
                          device=g.device)
        collectives.reduce_scatter(out.view(-1), pieces.view(-1),
                                   self.group, axis="data")
        return out.div_(n)


def _stacks(params):
    yield "blocks", params.blocks
    if hasattr(params, "enc_blocks"):
        yield "enc_blocks", params.enc_blocks


class _Call(nn.Module):
    """``layer`` run by ``_layer_forward`` as a module's forward, so that
    ``functional_call`` can swap its weights."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, *args):
        return _layer_forward(self.layer, *args)


def shard_params_(params, shards: dict[str, Shard]):
    """Swap each sharded parameter of ``params`` (whole, on this rank)
    for this rank's shard, one at a time.  Returns ``params``."""
    named = dict(params.named_parameters())
    if set(named) != set(shards):
        raise ValueError("parameters do not match the layout: "
                         f"{sorted(set(named) ^ set(shards))}")
    for name, p in named.items():
        if shards[name].sharded:
            p.data = shards[name].local(p.data)
    return params


class Runner:
    """``run(layer, *args)`` for ``blocks.stack_forward`` over the
    sharded ``params``: a layer that holds ZeRO-3 shards runs through its
    :class:`LayerGather` (gathering in ``dtype``, the model's compute
    dtype, over ``ctx``'s ``data`` group), any other as it is."""

    def __init__(self, params, shards: dict[str, Shard], ctx,
                 dtype: torch.dtype):
        names = [n for n, _ in params.named_parameters()]
        self.gathers = {}
        for stack_name, stack in _stacks(params):
            for i, layer in enumerate(stack):
                pre = f"{stack_name}.{i}."
                mine = [n[len(pre):] for n in names
                        if n.startswith(pre) and _data_cut(shards[n])]
                if mine:
                    self.gathers[id(layer)] = LayerGather(
                        mine, [shards[pre + n] for n in mine],
                        ctx.data_group, dtype)

    def __call__(self, layer, *args):
        gather = self.gathers.get(id(layer))
        if gather is None:
            return _layer_forward(layer, *args)
        return gather(layer, *args)
