"""Roofline terms of one step on one card.

The JAX package's ``repro/roofline/analysis.py`` has two halves.  The
analytic half, ``analytic_memory_bytes``, ``_kv_cache_bytes`` and
``model_flops``, is arithmetic on the configs and is carried over here
as it is.  The other half parses XLA's post-SPMD HLO text
(``parse_hlo``, ``analyze_hlo``, ``collective_bytes``) to count one
step's per-device dot FLOPs and collective bytes.  PyTorch runs eagerly
and has no HLO, so that half has no counterpart here; its role is taken
by :func:`count_flops`, which runs the step under
``torch.utils.flop_counter.FlopCounterMode`` and counts every matrix
product the step dispatches (the same dots the HLO parser counts, each
masked attention score included), and under
``sharding.collectives.recording``, which counts the wire bytes of every
collective the step issues (ring model, as the HLO parser reckons
them).  :func:`roofline_terms` takes the collective term as those bytes
over the card's measured link bandwidth (``HwSpec.link_bw``).
"""
from __future__ import annotations

import math
from collections import defaultdict

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.roofline.hw import H100_HW, HwSpec
from repro_torch.sharding import collectives

__all__ = ["analytic_memory_bytes", "model_flops", "count_flops",
           "roofline_terms", "collective_s_by_axis", "sharded_step_wire"]


# ------------------------------------------------------------- op counts

def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """``aten.bmm`` in both its overloads: ``bmm(a, b)`` and
    ``bmm.dtype(a, b, out_dtype)``, the f32 scores from 16-bit operands
    (``models/attention.py`` ``_ScoresF32``).  The stock formula takes
    ``out_dtype``, the third positional argument, for its output shape
    and fails."""
    b, m, k = a_shape
    b2, k2, n = b_shape
    if (b, k) != (b2, k2):
        raise ValueError(f"bmm of {tuple(a_shape)} and {tuple(b_shape)}")
    return 2 * b * m * n * k


def count_flops(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once and count its matrix products' FLOPs
    (2 per multiply-add, as the HLO parser counts a dot), on whatever
    device the arguments live, and this rank's collectives.  Returns the
    keys of the JAX package's ``analyze_hlo`` (``flops``, the collective
    operand and wire bytes by kind and their totals; empty on one card)
    and ``by_op``, the FLOPs of each ATen op."""
    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.bmm: _bmm_flop})
    with counter, collectives.recording() as log:
        fn(*args, **kw)
    by_op: dict = defaultdict(int)
    for op, n in counter.get_flop_counts()["Global"].items():
        by_op[str(op)] += n
    return {"flops": float(counter.get_total_flops()),
            **collectives.summarize(log),
            "by_op": dict(by_op)}


# ------------------------------------------------------------- memory model

def analytic_memory_bytes(cfg: ModelConfig, shape: ShapeConfig,
                          n_chips: int) -> float:
    """Per-device HBM traffic (bytes) for one step — structural model.

    train: params read twice (fwd+bwd) in compute dtype + optimizer
    read/write (p,m,v fp32 ×2) + rematerialized activations (~2 writes +
    3 reads of one activations set per layer at bf16).
    prefill: params once + activations once.
    decode: params once + full KV cache read + one-token write.
    """
    cd = 2  # bf16
    n_params_shard = cfg.n_params() / n_chips
    n_active_shard = cfg.n_active_params() / n_chips
    tokens = shape.global_batch * shape.seq_len / n_chips
    act_unit = tokens * cfg.d_model * cd  # one activations tensor, sharded
    if shape.kind == "train":
        opt = n_params_shard * 4 * 3 * 2          # p,m,v fp32 read+write
        wread = 2 * n_active_shard * cd + n_params_shard * cd
        acts = cfg.n_layers * act_unit * 5
        return opt + wread + acts
    if shape.kind == "prefill":
        return n_active_shard * cd + cfg.n_layers * act_unit * 2
    # decode: one token
    kv = _kv_cache_bytes(cfg, shape) / n_chips
    tok = shape.global_batch * cfg.d_model * cd * cfg.n_layers / n_chips
    return n_active_shard * cd + kv + tok


def _kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    cd = 2
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg._is_attn_layer(i))
    kv = (n_attn * 2 * shape.global_batch * shape.seq_len
          * cfg.n_kv_heads * cfg.head_dim * cd)
    if cfg.ssm is not None:
        s = cfg.ssm
        n_ssm = cfg.n_layers - n_attn
        kv += n_ssm * shape.global_batch * (
            s.n_heads(cfg.d_model) * s.head_dim * s.d_state * 4
            + (s.d_conv - 1) * (s.d_inner(cfg.d_model)
                                + 2 * s.n_groups * s.d_state) * cd)
    return kv


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global MODEL_FLOPS: 6·N_active·D tokens (train: fwd+bwd; serve:
    2·N_active·D). Attention O(s²) term added for train/prefill."""
    tokens = shape.global_batch * shape.seq_len
    n = cfg.n_active_params()
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg._is_attn_layer(i))
    attn_flops = (4 * shape.global_batch * shape.seq_len ** 2
                  * cfg.n_heads * cfg.head_dim * n_attn) / 2  # causal
    if shape.kind == "train":
        return 6.0 * n * tokens + 3 * attn_flops
    if shape.kind == "prefill":
        return 2.0 * n * tokens + attn_flops
    # decode: one token per sequence + KV attention
    dec_attn = (4 * shape.global_batch * shape.seq_len
                * cfg.n_heads * cfg.head_dim * n_attn)
    return 2.0 * n * shape.global_batch + dec_attn


# ------------------------------------------------------------- roofline

def roofline_terms(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
                   counts: dict, hw: HwSpec = H100_HW) -> dict:
    """The roofline terms (seconds) of one step on each of ``n_chips``
    cards, its bottleneck and the share of the card's peak the bound
    allows, with the keys of the JAX package's ``roofline_terms``.
    ``counts`` is :func:`count_flops`'s result for one rank's step:
    compute time is its FLOPs over the card's peak for
    ``cfg.compute_dtype``, memory time the analytic bytes over
    ``hw.hbm_bw``, collective time its counted wire bytes over the
    card's measured link bandwidth ``hw.link_bw`` (NCCL's bus bandwidth,
    where the JAX package divides by the TPU's ICI links): every
    recorded collective, ZeRO-3's over ``data`` and tensor parallelism's
    over ``model`` alike (:func:`collective_s_by_axis` splits it)."""
    if n_chips < 1:
        raise ValueError(f"roofline_terms: n_chips={n_chips}")
    peak = hw.peak_flops[cfg.compute_dtype]
    flops_dev = counts["flops"]
    mflops = model_flops(cfg, shape)
    compute_s = flops_dev / peak
    mem_bytes = analytic_memory_bytes(cfg, shape, n_chips)
    memory_s = mem_bytes / hw.hbm_bw
    collective_s = counts["total_wire_bytes"] / hw.link_bw
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda t: t[1])[0]
    bound = max(compute_s, memory_s, collective_s)
    mfu_at_roofline = (mflops / n_chips / peak) / bound if bound > 0 else 0.0
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "hlo_flops_per_device": flops_dev,
        "model_flops_global": mflops,
        "useful_ratio": (mflops / n_chips) / flops_dev if flops_dev else 0.0,
        "memory_bytes_per_device": mem_bytes,
        "wire_bytes_per_device": counts["total_wire_bytes"],
        "roofline_fraction": min(mfu_at_roofline, 1.0),
    }


def collective_s_by_axis(counts: dict, hw: HwSpec = H100_HW) -> dict:
    """:func:`roofline_terms`' collective term apart by the mesh axis
    its bytes went over (``count_flops``' ``collective_wire_bytes_by_
    axis``): the ``data`` axis's ZeRO-3 gathers and gradient syncs, the
    ``model`` axis's tensor-parallel activation steps and loss, the
    ``pod`` axis's gradient means."""
    return {a: b / hw.link_bw for a, b in
            counts.get("collective_wire_bytes_by_axis", {}).items()}


# --------------------------------------------------- sharded step's wire

def sharded_step_wire(cfg: ModelConfig, sizes: dict, batch: int, seq: int,
                      n_prefix: int = 0, remat: bool = True,
                      n_metrics: int = 3) -> dict:
    """The ring model of the collectives one rank issues in one step of
    the sharded train step (``trainstep.make_train_step(ctx=)``) of
    ``cfg`` on a mesh of ``sizes`` (``{"pod", "data", "model"}``, a
    missing axis 1), for a global batch of ``batch`` rows of ``seq``
    tokens after ``n_prefix`` prefix embeddings: ``{kind: wire bytes}``
    of this rank, from the layout alone (what ``sharding.collectives``
    records when the step runs).  With ``remat`` every layer runs its
    forward twice, and so do the loss's checkpointed chunks always.

    * ZeRO-3 (``train.zero``): each parameter cut over ``data`` is
      all-gathered in the compute dtype each time its layer runs, and
      its f32 gradient reduce-scattered once.
    * Tensor parallelism (``models.common``), activations [rows, S, D]
      in the compute dtype (a row-parallel product's partial sums, and a
      column-parallel entry's partial gradients, in f32): a column/row
      pair (attention, a divisible FFN) all-gathers
      and reduce-scatters S each way where the sequence is sharded, else
      all-reduces forward and backward once each (a FFN's reduction, the
      layer's last step, is not recomputed); a
      part whole over ``model`` (Mamba-2, an FFN the ranks do not
      divide) all-gathers S forward and backward where it is sharded;
      a head count the ranks do not divide runs the sequence-sharded
      attention where S is sharded (an all-gather of S forward, its
      reduce-scatter backward, and the four weights' gradients
      all-reduced in f32 backward) and attention whole elsewhere (none);
      a MoE whose experts the ranks divide (expert parallelism,
      ``models.moe.moe_ep``) enters and leaves as a whole part, its
      token slice's gradient all-gathered, its router loss all-reduced
      (f32) each forward and the router's gradient backward, its
      capacity buffers ``[E, cap, D]`` exchanged (all-to-all) twice each
      forward and twice backward, and its slices' outputs all-gathered
      once (the layer's last step);
      the embedding's partial lookup is reduce-scattered (all-reduced)
      and the final states gathered for the head (an all-reduce in the
      backward); each loss chunk all-reduces its rows' maxima and, in
      one, their sums and label logits (f32).
    * The gradients: parts held by each ``model`` rank
      (``zero.model_partial``) all-reduced over ``model``; every
      parameter whole over ``data`` all-reduced over ``data``, and every
      one over ``pod``; the metrics over each batch axis; the norm's
      f32 squares over each axis a leaf is cut over."""
    import types
    from repro_torch.models import blocks, common, moe
    from repro_torch.models.lm import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.layout import shard_of
    from repro_torch.train import zero
    mesh = types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))
    pods, data, tp = (sizes.get(a, 1) for a in ("pod", "data", "model"))
    meta = dict(build_model(cfg).init(device="meta",
                                      trainable=True).named_parameters())
    specs = rules.param_specs(meta, cfg, mesh)
    shards = {k: shard_of(tuple(p.shape), specs[k], mesh,
                          {a: 0 for a in sizes}) for k, p in meta.items()}
    n_b = pods * data
    rows = (batch // n_b if batch % n_b == 0
            else batch // data if batch % data == 0 else batch)
    s_all = seq + n_prefix
    sp = common.seq_shardable(tp, s_all)
    cd = torch.empty((), dtype=cfg.cdtype()).element_size()
    act = rows * s_all * cfg.d_model * cd
    # a row-parallel product's partial sums go out in f32 (common.row_parallel)
    part = rows * s_all * cfg.d_model * 4
    out: dict = {}

    def add(kind: str, nbytes: float, g: int, times: int = 1) -> None:
        if g > 1:
            f = 2 * (g - 1) / g if kind == "all-reduce" else (g - 1) / g
            out[kind] = out.get(kind, 0.0) + times * nbytes * f

    runs = 2 if remat else 1

    def column_row(exit_runs: int):
        """enter: forward ``runs``, backward once (the partial gradients,
        in f32); exit: forward ``exit_runs`` (the partial sums), backward
        once."""
        if sp:
            add("all-gather", act, tp, runs + 1)
            add("reduce-scatter", part, tp)
            add("reduce-scatter", part, tp, exit_runs)
        else:
            add("all-reduce", part, tp)
            add("all-reduce", part, tp, exit_runs)

    def whole_part():
        if sp:
            add("all-gather", act, tp, runs + 1)

    def n_local(k):
        return math.prod(shards[k].local_shape)

    def experts():
        e = cfg.moe
        if e.n_experts % tp:
            whole_part()
            return
        ts, cap = moe.capacity(rows * s_all, tp, e)
        whole_part()
        add("all-gather", tp * ts * cfg.d_model * cd, tp)
        add("all-reduce", 4, tp, runs)
        add("all-reduce", cfg.d_model * e.n_experts * 4, tp)
        add("all-to-all", e.n_experts * cap * cfg.d_model * cd, tp,
            2 * runs + 2)
        add("all-gather", tp * ts * cfg.d_model * cd, tp)

    for i, desc in enumerate(blocks.stack_descriptors(cfg)):
        pre = f"blocks.{i}."
        for k in meta:
            if k.startswith(pre) and "data" in zero.cut_axes(shards[k]):
                add("all-gather", data * n_local(k) * cd, data, runs)
                add("reduce-scatter", data * n_local(k) * 4, data)
        if tp == 1:
            continue
        if desc.mixer == "attn" and cfg.n_heads % tp == 0:
            column_row(runs)
        elif desc.mixer == "attn" and sp:
            add("all-gather", act, tp, runs)
            add("reduce-scatter", part, tp)
            q = cfg.n_heads * cfg.head_dim
            kv = cfg.n_kv_heads * cfg.head_dim
            add("all-reduce", 4 * cfg.d_model * (2 * q + 2 * kv), tp)
        elif desc.mixer != "attn":
            whole_part()
        if desc.ffn == "dense" and cfg.d_ff % tp == 0:
            # the layer's last step: torch.utils.checkpoint ends its
            # recompute once every saved tensor is back, before it
            column_row(1)
        elif desc.ffn == "dense":
            whole_part()
        elif desc.ffn == "moe":
            if cfg.moe.dense_residual:
                column_row(runs) if cfg.d_ff % tp == 0 else whole_part()
            experts()
    if tp > 1:
        # the embedding's sum and the head's gather, each once a way
        add("reduce-scatter" if sp else "all-reduce", act, tp)
        if sp:
            add("all-gather", act, tp, 2)
            add("reduce-scatter", part, tp)
        else:
            add("all-reduce", part, tp)
        n_chunks, s_tok = 8, seq - 1
        while s_tok % n_chunks:
            n_chunks -= 1
        cs = s_tok // n_chunks
        add("all-reduce", rows * cs * 4, tp, 2 * n_chunks)      # maxima
        add("all-reduce", 2 * rows * cs * 4, tp, 2 * n_chunks)  # sums, ll
    partial = zero.model_partial(cfg, types.SimpleNamespace(tp=tp), sp)
    parts = set()
    for k in meta:
        axes = zero.cut_axes(shards[k])
        parts.add(tuple(sorted(set(axes))))
        if partial(k):
            add("all-reduce", n_local(k) * 4, tp)
        if "data" not in axes:
            add("all-reduce", n_local(k) * 4, data)
        add("all-reduce", n_local(k) * 4, pods)
    for a, g in (("pod", pods), ("data", data)):
        add("all-reduce", n_metrics * 4, g)
    for a, g in (("data", data), ("model", tp)):
        add("all-reduce", 4 * sum(a in p for p in parts), g)
    return out
