"""Shared model components: the mesh context, initializers, the norm
(with its gradient), RoPE, the loss."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Names of the axes of a ``torch.distributed`` ``DeviceMesh`` (with
    named dims) that the layers and the train step read: ``dp_axes`` for
    the batch (``("pod", "data")`` or ``("data",)``, as the JAX package's
    ``mesh_ctx`` gives them), ``tp_axis`` for the model axis, over which
    serving shards the KV cache's sequence
    (``kernels.decode_attn.sharded``) and training cuts the Megatron
    heads, FFN and vocabulary.  The sharded train step
    (``train.trainstep``) shards parameters and optimizer state over
    ``data`` (ZeRO-3) and reads each axis's process group and this rank's
    index along it.  None in place of a MeshCtx is the single-device
    context.

    ``seq_sharded`` is the layout of one tensor-parallel forward
    (:func:`tp_layout`): None outside one (serving keeps its weights
    whole on every rank); in one, whether its layer boundaries hold this
    rank's S / tp positions (Megatron sequence parallelism, the JAX
    ``constrain_tokens`` rule) or the whole sequence.  The JAX package's
    GSPMD layout hints ``constrain_act`` and ``constrain_tokens`` are
    the explicit steps :func:`tp_enter`, :func:`tp_exit`,
    :func:`rep_enter` and :func:`rep_exit` here."""
    mesh: Any
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    seq_sharded: Optional[bool] = None

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``; 1 for an axis the mesh lacks."""
        names = self.mesh.mesh_dim_names
        return self.mesh.size(names.index(name)) if name in names else 1

    def axis_group(self, name: str):
        """The process group of this rank's line along axis ``name``."""
        return self.mesh.get_group(name)

    def axis_rank(self, name: str) -> int:
        """This rank's index along axis ``name``; 0 for an axis the mesh
        lacks."""
        if name not in self.mesh.mesh_dim_names:
            return 0
        return self.mesh.get_local_rank(name)

    @property
    def tp(self) -> int:
        return self.axis_size(self.tp_axis)

    @property
    def tp_group(self):
        """The process group of this rank's model axis."""
        return self.axis_group(self.tp_axis)

    @property
    def tp_rank(self) -> int:
        """This rank's index along the model axis."""
        return self.axis_rank(self.tp_axis)

    @property
    def data(self) -> int:
        """The size of the fsdp axis ``data``."""
        return self.axis_size("data")

    @property
    def data_group(self):
        return self.axis_group("data")

    @property
    def data_rank(self) -> int:
        return self.axis_rank("data")

    @property
    def pod(self) -> int:
        """The size of the cross-pod axis ``pod`` (1 without one)."""
        return self.axis_size("pod")

    @property
    def pod_group(self):
        return self.axis_group("pod")

    @property
    def pod_rank(self) -> int:
        return self.axis_rank("pod")

    @property
    def n_batch(self) -> int:
        """The ranks the batch is split over: the product of ``dp_axes``."""
        return math.prod(self.axis_size(a) for a in self.dp_axes)

    @property
    def batch_rank(self) -> int:
        """This rank's index over ``dp_axes``, row-major (the first axis
        outermost, as GSPMD indexes a dim sharded over several axes)."""
        r = 0
        for a in self.dp_axes:
            r = r * self.axis_size(a) + self.axis_rank(a)
        return r

    def batch_axes(self, b: int) -> tuple[str, ...]:
        return self.dp_axes if b % self.n_batch == 0 else ()

    @property
    def tensor_parallel(self) -> bool:
        """Whether this is a tensor-parallel forward: the layers hold
        their weights' ``model`` blocks and run the layout steps."""
        return self.seq_sharded is not None and self.tp > 1


def tensor_parallel(ctx: Optional[MeshCtx]) -> bool:
    return ctx is not None and ctx.tensor_parallel


def seq_shardable(tp: int, s: int) -> bool:
    """The JAX ``constrain_tokens`` rule: a sequence of ``s`` positions is
    sharded over a model axis of ``tp`` ranks where ``tp`` divides it
    into pieces of at least 128."""
    return tp > 1 and s % tp == 0 and s // tp >= 128


def tp_layout(ctx: Optional[MeshCtx], s: int) -> Optional[MeshCtx]:
    """``ctx`` for a tensor-parallel forward over ``s`` positions (its
    ``seq_sharded`` set by :func:`seq_shardable`); ``ctx`` itself where
    the model axis has one rank or there is no ctx."""
    if ctx is None or ctx.tp == 1:
        return ctx
    return dataclasses.replace(ctx, seq_sharded=seq_shardable(ctx.tp, s))


# ------------------------------------------------ tensor-parallel layout
#
# Each step is a ``torch.autograd.Function`` over the model group, on
# activations [B, S, D] whose sequence dim is 1.  A sequence-sharded
# tensor holds this rank's S / tp positions, rank r the r-th piece.

def _seq_gather(x: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """[B, S/tp, D] of every rank → [B, S, D] (contiguous), in rank
    order."""
    from repro_torch.sharding import collectives
    x = x.contiguous()
    buf = x.new_empty((ctx.tp,) + tuple(x.shape))
    collectives.all_gather(buf.view(-1), x.view(-1), ctx.tp_group,
                           axis=ctx.tp_axis)
    b, s, d = x.shape
    return buf.permute(1, 0, 2, 3).reshape(b, ctx.tp * s, d)


def _seq_reduce_scatter(x: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """[B, S, D] summed over the ranks → this rank's [B, S/tp, D]."""
    from repro_torch.sharding import collectives
    b, s, d = x.shape
    pieces = x.reshape(b, ctx.tp, s // ctx.tp, d).transpose(0, 1)
    out = x.new_empty((b, s // ctx.tp, d))
    collectives.reduce_scatter(out.view(-1), pieces.contiguous().view(-1),
                               ctx.tp_group, axis=ctx.tp_axis)
    return out


def _seq_piece(x: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """This rank's [B, S/tp, D] of a whole [B, S, D]."""
    n = x.shape[1] // ctx.tp
    return x.narrow(1, ctx.tp_rank * n, n).contiguous()


def _all_reduce(x: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    from repro_torch.sharding import collectives
    return collectives.all_reduce(x.contiguous().clone(), ctx.tp_group,
                                  axis=ctx.tp_axis)


class _CopyIn(torch.autograd.Function):
    """Into a tensor-parallel region: x in f32 (exact); backward
    all-reduces the ranks' partial gradients in f32 and rounds the sum
    once to x's dtype (see :func:`tp_enter`)."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx, fctx.dtype = ctx, x.dtype
        return x.float() if x.dtype != torch.float32 else x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return _all_reduce(g.float(), fctx.ctx).to(fctx.dtype), None


class _ReduceOut(torch.autograd.Function):
    """Out of a tensor-parallel region: the ranks' partial sums
    all-reduced, then cast to ``dtype``; backward is the identity (cast
    back to the partials' dtype, exactly)."""

    @staticmethod
    def forward(fctx, x, ctx, dtype):
        fctx.dtype = x.dtype
        return _all_reduce(x, ctx).to(dtype)

    @staticmethod
    def backward(fctx, g):
        return g.to(fctx.dtype), None, None


class _GatherSeq(torch.autograd.Function):
    """Sequence-sharded → whole, into a tensor-parallel region: all-gather
    of S (in x's dtype), handed on in f32; backward reduce-scatters the
    ranks' partial gradients in f32 and rounds once to x's dtype (see
    :func:`tp_enter`)."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx, fctx.dtype = ctx, x.dtype
        return _seq_gather(x, ctx).float()

    @staticmethod
    def backward(fctx, g):
        return (_seq_reduce_scatter(g.float(), fctx.ctx).to(fctx.dtype),
                None)


class _ScatterSeq(torch.autograd.Function):
    """Out of a tensor-parallel region, sequence-sharded: reduce-scatter
    of the partial sums over S, then cast to ``dtype``; backward
    all-gathers (in ``dtype``, then cast back exactly)."""

    @staticmethod
    def forward(fctx, x, ctx, dtype):
        fctx.ctx, fctx.dtype = ctx, x.dtype
        return _seq_reduce_scatter(x, ctx).to(dtype)

    @staticmethod
    def backward(fctx, g):
        return _seq_gather(g, fctx.ctx).to(fctx.dtype), None, None


class _RowParallel(torch.autograd.Function):
    """``x @ w`` for x [..., K] and w [K, N] in a 16-bit dtype, its sum
    over K kept in f32: a row-parallel product's partial sum, which
    :func:`tp_exit` adds over the model group before it rounds once to
    x's dtype, as the one-card product rounds its whole sum once (a
    16-bit partial would round each rank's part, then their sum).  On
    the card ``torch.bmm(..., out_dtype=torch.float32)``, which has no
    gradient in torch; elsewhere the operands widened first (exact).
    Backward: the one-card product's, the gradient narrowed to x's dtype
    first (exact: it comes from a 16-bit tensor)."""

    @staticmethod
    def forward(fctx, x, w):
        fctx.save_for_backward(x, w)
        k = x.shape[-1]
        if x.is_cuda:
            out = torch.bmm(x.reshape(1, -1, k), w[None],
                            out_dtype=torch.float32)
        else:
            out = x.reshape(-1, k).float() @ w.float()
        return out.reshape(tuple(x.shape[:-1]) + (w.shape[1],))

    @staticmethod
    def backward(fctx, g):
        x, w = fctx.saved_tensors
        g = g.to(x.dtype)
        dx = dw = None
        if fctx.needs_input_grad[0]:
            dx = g @ w.T
        if fctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return dx, dw


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 ctx: Optional[MeshCtx]) -> torch.Tensor:
    """``x @ w``; in a tensor-parallel forward with 16-bit operands, this
    rank's partial sum in f32 (:class:`_RowParallel`) for
    :func:`tp_exit`."""
    if not tensor_parallel(ctx) or x.dtype == torch.float32:
        return x @ w
    return _RowParallel.apply(x, w)


def _f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D operands of one dtype, summed in f32 and never
    rounded to 16 bits (on the card ``torch.bmm(..., out_dtype=f32)``)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a[None], b[None], out_dtype=torch.float32)[0]
    return a.float() @ b.float()


class _NarrowMM(torch.autograd.Function):
    """``x @ w`` in ``dtype`` for the f32 rows ``x`` that :func:`tp_enter`
    hands on: both narrowed to ``dtype`` first, so the forward is the
    plain product's.  Backward: x's gradient, this rank's part of it, in
    f32 (:func:`_f32_mm`), not rounded to ``dtype`` before the entry's
    sum; w's as the plain product's (in ``dtype``)."""

    @staticmethod
    def forward(fctx, x, w, dtype):
        xd, wd = x.to(dtype), w.to(dtype)
        fctx.save_for_backward(xd, wd)
        fctx.wdtype = w.dtype
        return xd @ wd

    @staticmethod
    def backward(fctx, g):
        xd, wd = fctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = _f32_mm(g2, wd.T).view(*g.shape[:-1], wd.shape[0])
        dw = (xd.reshape(-1, xd.shape[-1]).T @ g2).to(fctx.wdtype)
        return dx, dw, None


def entry_mm(x: torch.Tensor, w: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` in ``dtype``: a column-parallel product of the f32 rows
    :func:`tp_enter` hands on (:class:`_NarrowMM`), else the plain
    product."""
    if x.dtype == dtype:
        return x @ w.to(dtype)
    return _NarrowMM.apply(x, w, dtype)


class _ModelSummed(torch.autograd.Function):
    """``x @ w`` (w cast to x's dtype) for a weight whole over the model
    group whose gradient each rank holds a part of (its own rows of x):
    backward sums the parts over the model group in f32 and rounds the
    sum once to w's dtype, as the one-card product rounds its whole sum
    once (a part rounded to 16 bits on each rank, then summed, rounds tp
    times).  The gradient is then whole on every rank.  x's gradient is
    the plain product's, or in f32 where x is the f32 rows of
    :func:`tp_enter` (as :class:`_NarrowMM`'s)."""

    @staticmethod
    def forward(fctx, x, w, ctx, dtype):
        xd = x.to(dtype)
        fctx.save_for_backward(xd, w)
        fctx.ctx, fctx.x_dtype = ctx, x.dtype
        return xd @ w.to(dtype)

    @staticmethod
    def backward(fctx, g):
        xd, w = fctx.saved_tensors
        dx = dw = None
        g2 = g.reshape(-1, g.shape[-1])
        if fctx.needs_input_grad[0]:
            wd = w.to(g.dtype)
            if fctx.x_dtype == xd.dtype:
                dx = g @ wd.T
            else:
                dx = _f32_mm(g2, wd.T).view(*g.shape[:-1], wd.shape[0])
        if fctx.needs_input_grad[1]:
            part = _f32_mm(xd.reshape(-1, xd.shape[-1]).T, g2)
            dw = _all_reduce(part, fctx.ctx).to(w.dtype)
        return dx, dw, None, None


def model_summed(x: torch.Tensor, w: torch.Tensor, ctx: Optional[MeshCtx],
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` in ``dtype`` (default x's); in a tensor-parallel forward,
    where w is whole over the model group and this rank's x holds only
    its part of the rows, :class:`_ModelSummed` (w's gradient summed over
    the group in f32)."""
    dtype = dtype or x.dtype
    if not tensor_parallel(ctx):
        return entry_mm(x, w, dtype)
    return _ModelSummed.apply(x, w, ctx, dtype)


class _GatherRep(torch.autograd.Function):
    """Sequence-sharded → whole, into a replicated region (every rank
    computes the same function of the whole sequence): all-gather of S;
    backward keeps this rank's piece of the (whole, equal) gradient."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _seq_gather(x, ctx)

    @staticmethod
    def backward(fctx, g):
        return _seq_piece(g, fctx.ctx), None


class _SplitSeq(torch.autograd.Function):
    """Whole and equal on every rank → this rank's piece of S; backward
    all-gathers the pieces' gradients."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return _seq_piece(x, ctx)

    @staticmethod
    def backward(fctx, g):
        return _seq_gather(g.contiguous(), fctx.ctx), None


def tp_enter(x: torch.Tensor, ctx: Optional[MeshCtx]) -> torch.Tensor:
    """A layer boundary's tokens into a column-parallel product: the
    whole sequence (all-gathered where sharded, backward
    reduce-scatter), else the identity with an all-reduce backward.  The
    identity outside a tensor-parallel forward.

    In one the rows are handed on in f32, for products that narrow them
    to the compute dtype (:func:`entry_mm`, :func:`model_summed` with a
    ``dtype``): each rank's part of their gradient stays f32 and the
    parts are summed in f32 and rounded once, as the one-card product
    rounds its whole sum once.  Rounded to 16 bits on each rank and then
    summed in 16 bits over 8 ranks, a bf16 step lies measurably farther
    from the f32 step than the one-card bf16 step does."""
    if not tensor_parallel(ctx):
        return x
    return (_GatherSeq if ctx.seq_sharded else _CopyIn).apply(x, ctx)


def tp_exit(x: torch.Tensor, ctx: Optional[MeshCtx],
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A row-parallel product's partial sums back to the layer boundary
    in ``dtype`` (default x's; a :func:`row_parallel` partial is f32 and
    rounds once, after the sum): reduce-scattered over S where the
    sequence is sharded (backward all-gather, in ``dtype``), else
    all-reduced (backward identity)."""
    if not tensor_parallel(ctx):
        return x if dtype is None else x.to(dtype)
    return (_ScatterSeq if ctx.seq_sharded else _ReduceOut).apply(
        x, ctx, dtype or x.dtype)


def rep_enter(x: torch.Tensor, ctx: Optional[MeshCtx]) -> torch.Tensor:
    """Into a part the rules keep whole over ``model`` (Mamba-2, an FFN
    whose width the ranks do not divide), which every rank computes on
    the whole sequence: all-gathered where sharded."""
    if not tensor_parallel(ctx) or not ctx.seq_sharded:
        return x
    return _GatherRep.apply(x, ctx)


def rep_exit(x: torch.Tensor, ctx: Optional[MeshCtx]) -> torch.Tensor:
    """Out of a whole part: this rank's piece of S where sharded."""
    if not tensor_parallel(ctx) or not ctx.seq_sharded:
        return x
    return _SplitSeq.apply(x, ctx)


def _truncated_normal(shape, generator: torch.Generator, device,
                      lo: float = -2.0, hi: float = 2.0) -> torch.Tensor:
    """Standard normal truncated to [lo, hi], by inverse CDF (the same
    distribution as ``jax.random.truncated_normal``; not the same draws)."""
    a, b = math.erf(lo / math.sqrt(2.0)), math.erf(hi / math.sqrt(2.0))
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(a, b, generator=generator)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(lo, hi)


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-ish, standard for LMs)."""
    std = 1.0 / math.sqrt(shape[in_axis])
    return (_truncated_normal(shape, generator, device) * std).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    x = torch.empty((vocab, d), dtype=torch.float32, device=device)
    x.normal_(generator=generator)
    return (x * (1.0 / math.sqrt(d))).to(dtype)


class _RMSNorm(torch.autograd.Function):
    """rmsnorm with a gradient.  Forward is the K1 kernel (its plain
    version on the CPU or with ``mode="ref"``), which also returns the f32
    inverse rms of each row; backward is the closed form in f32 from the
    saved x, w and inverse rms, cast back to their dtypes.  The JAX
    package has no backward kernel (XLA differentiates its reference),
    so this one is plain PyTorch too."""

    @staticmethod
    def forward(ctx, x, w, eps, mode):
        out, inv = rmsnorm_ops.rmsnorm(x, w, eps=eps, mode=mode,
                                       with_inv_rms=True)
        ctx.save_for_backward(x, w, inv)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, inv = ctx.saved_tensors
        inv = inv.unsqueeze(-1)
        xhat = x.float() * inv
        g = dy.float() * w.float()
        # d/dx of x * inv(x) * w, inv = (mean(x^2) + eps)^-1/2
        dx = inv * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
        dw = (dy.float() * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             mode: Optional[str] = None) -> torch.Tensor:
    """The multi-strided rmsnorm kernel on the card; its plain version on
    the CPU or with ``mode="ref"``.  Differentiable in x and scale."""
    return _RMSNorm.apply(x, scale.to(x.dtype), eps, mode)


def make_rope(positions: torch.Tensor, head_dim: int, theta: float,
              style: str) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
    """Rotary embedding tables for given positions [*(B,) S].

    style 'full': rotate all head dims (llama). 'half': rotate only the
    first half of the head dims (ChatGLM's 2D-RoPE layout). 'none': None.
    """
    if style == "none":
        return None
    rot = head_dim if style == "full" else head_dim // 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), -exps)
    ang = positions[..., None].float() * freqs            # [..., rot/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, rope, style: str) -> torch.Tensor:
    """x: [B, S, H, dh]; rope cos/sin: [B?, S, rot/2] or [S, rot/2].

    Rotates INTERLEAVED pairs (dims 0::2 with 1::2), as the JAX package
    does — not the rotate-half layout of other implementations."""
    if rope is None or style == "none":
        return x
    cos, sin = rope
    while cos.ndim < x.ndim - 1:  # broadcast over batch/head dims
        cos, sin = cos[None], sin[None]
    cos, sin = cos[..., None, :], sin[..., None, :]  # add head axis
    dh = x.shape[-1]
    rot = dh if style == "full" else dh // 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp.to(yr.dtype)], dim=-1) if rot != dh else yr


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token NLL with optional z-loss, f32 stable."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp(min=1)
    return nll.mean()
