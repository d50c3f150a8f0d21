#!/usr/bin/env python3
"""Sequence-sharded serving across cards: the serving engine
(``repro_torch.serve.ServingEngine``, as ``launch/serve.py`` builds it)
over ``serving_ctx(K)``, K ranks, one a card, over NCCL, each rank
holding its ``[B, S/K, Hkv, dh]`` slice of every layer's KV cache.

Run on one host with K cards:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tools/torch_sharded_serve.py [--batch 32] [--seq 32768] [--steps 8]

Yi-9B at full width and depth on random bf16 weights (seed 0), a cache
of ``--batch`` slots of ``--seq`` positions: at B=32 x S=32768 that is
103 GB of K and V, which no one card holds beside the 17.7 GB of
weights, and 25.8 GB a card at K=4.  Each rank fills its slice with
random rows (seed 1 + rank), the slots' lengths are set to ragged
positions in the last 1024 of the cache, and the engine's batched step
(``decode_step`` with ``ctx`` and ``shards``, then rank 0's tokens
broadcast) is timed over ``--steps`` steps after two warm ones: wall
time on the host clock (each step ends in the host's read of its
tokens), the decode kernel's launches a step, then over as many steps
under ``torch.profiler`` the device's kernel time a step: NCCL's (whose
kernels also run while they wait for the other ranks, so their span is
not work) and the rest's, whose share of the wall time is the busy
share; and peak memory.  Rank 0 prints the card's name and power limit
and one JSON line.  Nothing here imports JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _device_ms(step, steps: int) -> tuple[float, float]:
    """(ms a step of the device kernels other than NCCL's, ms a step of
    NCCL's) over ``steps`` calls of ``step`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev(e) > 0]
    nccl = sum(dev(e) for e in kernels
               if "nccl" in e.key.lower()) / steps / 1e3
    return sum(dev(e) for e in kernels) / steps / 1e3 - nccl, nccl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.launch.serve import process_group
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServingEngine, serving_ctx

    if not torch.cuda.is_available():
        print("torch_sharded_serve: no CUDA device", file=sys.stderr)
        return 1
    device, owned = process_group("cuda")
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        ctx = serving_ctx(world)
        rank = ctx.tp_rank if ctx is not None else 0
        cfg = get_config(args.arch)
        model = build_model(cfg)
        params = model.init(seed=0, device=device)
        b, s = args.batch, args.seq
        eng = ServingEngine(model, params, ServeConfig(
            slots=b, max_len=s, max_new_tokens=args.steps + 4,
            shards=world), ctx=ctx)
        torch.cuda.reset_peak_memory_stats()
        eng.cache = model.init_cache(b, s, device=device, ctx=ctx)
        gen = torch.Generator(device=device).manual_seed(1 + rank)
        for layer in eng.cache:               # a served cache's scale
            for t in layer.values():
                t.copy_(torch.randn(t.shape, generator=gen, device=device)
                        .mul_(0.5))
        rng = np.random.default_rng(0)        # the same on every rank
        eng.lengths[:] = rng.integers(s - 1024, s - 2 * args.steps - 8, b)
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        every = list(range(b))

        def step():
            toks[:, 0] = eng._step(toks, every)

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        dk.SPLIT.launches = 0
        w0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) / args.steps * 1e3
        launches = dk.SPLIT.launches / args.steps
        if launches != cfg.n_layers:
            raise AssertionError(f"rank {rank}: {launches} decode launches "
                                 f"a step, expected {cfg.n_layers}")
        dev, nccl = _device_ms(step, args.steps)
        per = torch.tensor([wall, dev, nccl,
                            torch.cuda.max_memory_allocated() / 2 ** 30],
                           device=device, dtype=torch.float64)
        every_rank = [torch.zeros_like(per) for _ in range(world)]
        if world > 1:
            dist.all_gather(every_rank, per)
        else:
            every_rank = [per]
        if rank == 0:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip().splitlines()
            cache_gb = (2 * cfg.n_layers * b * s * cfg.n_kv_heads
                        * cfg.head_dim * 2 / 1e9)
            print(f"cards: {card}")
            print(json.dumps({
                "arch": cfg.name, "layers": cfg.n_layers, "batch": b,
                "seq": s, "ranks": world, "backend": dist.get_backend()
                if dist.is_initialized() else None,
                "cache_gb_total": round(cache_gb, 2),
                "cache_gb_per_card": round(cache_gb / world, 2),
                "positions": [int(eng.lengths.min()),
                              int(eng.lengths.max())],
                "decode_launches_per_step": launches,
                "step_wall_ms": [round(float(r[0]), 3) for r in every_rank],
                "step_kernels_but_nccl_ms": [round(float(r[1]), 3)
                                             for r in every_rank],
                "step_nccl_span_ms": [round(float(r[2]), 3)
                                      for r in every_rank],
                "busy_share": [round(float(r[1] / r[0]), 4)
                               for r in every_rank],
                "peak_gib": [round(float(r[3]), 2) for r in every_rank],
                "card": card[0] if card else None}))
        return 0
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
