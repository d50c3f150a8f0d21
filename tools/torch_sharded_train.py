#!/usr/bin/env python3
"""Training across cards: the sharded train step
(``repro_torch.train.trainstep.make_train_step(..., ctx=)``: ZeRO-3 over
``data``, tensor parallelism over ``model``) and the int8 error-feedback
compressed step (``make_compressed_train_step``), K ranks, one a card,
over NCCL.

Run on one host with 4 cards:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        tools/torch_sharded_train.py [--mesh model=4 --mesh data=2,model=2]
        [--arch qwen3-moe-30b-a3b --layers 12]

(``--device cpu --reduced`` rehearses it under gloo on the CPU: reduced
configs, a 4 x 32 batch.)

1. The link: NCCL ``all_gather_into_tensor`` (bf16) and
   ``reduce_scatter_tensor`` (f32) over every rank at 256 MiB and at the
   step's largest layer weight, timed with CUDA events; bus bandwidth =
   the wire bytes of one rank (N (K - 1) / K, N the gathered or
   scattered bytes) over the time.
2. Yi-9B (or ``--arch``, at ``--layers`` of its depth) at full width
   and depth (48 layers: 141 GB of f32 params, grads, m and v, which no
   one card holds), random weights (seed 0), on each ``--mesh`` (default
   ``data=K``, ZeRO-3; ``model=K`` and ``data=2,model=2`` are
   tensor-parallel, with Megatron sequence parallelism at S / model >=
   128, a MoE's experts E / model a rank (expert parallelism), heads the
   ranks do not divide on the sequence-sharded attention), global batch
   8 x 4096 (seeded numpy tokens),
   remat, 4 steps: the wall of each (host clock, ending in a
   synchronize), tokens/s, the kernels' launches a step, peak memory a
   card; one more step counted
   (``roofline.analysis.count_flops``: its dots and the wire bytes of
   its collectives, by kind and by mesh axis) for
   ``roofline_terms(n_chips=K)`` with the measured link bandwidth, and
   against ``roofline.analysis.sharded_step_wire``'s ring model of the
   layout; one more under ``torch.profiler`` for the device's kernel
   time a step, NCCL's apart (its kernels also run while they wait for
   the other ranks), and the adamw_update kernel's.
3. Without ``--mesh``: InternVL2-2B at full
   width and depth (the JAX package's own compressed-step arch) at
   pod=2, data=K/2, the compressed step, 4 steps: wall, and the int8
   wire bytes of the pod sync counted against
   ``train.compression.wire_bytes``.

Rank 0 prints the card's name and power limit and one JSON line, and
writes the line to ``chiprun_out/sharded_train.json``.  Nothing here
imports JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

STEPS = 4
BATCH, SEQ = 8, 4096                # the global batch
REHEARSAL = 4, 32                   # its cut on the CPU (``--reduced``)


def _sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _link(device, world: int, sizes: dict, reps: int = 10) -> dict:
    """Bus bandwidth (bytes/s a rank) of all-gather (bf16) and
    reduce-scatter (f32) at each of ``sizes`` (name → gathered bytes)."""
    import torch
    import torch.distributed as dist
    out = {}
    for name, nbytes in sizes.items():
        for kind, dtype in (("all_gather", torch.bfloat16),
                            ("reduce_scatter", torch.float32)):
            esz = torch.tensor([], dtype=dtype).element_size()
            n = nbytes // esz // world * world
            big = torch.ones(n, dtype=dtype, device=device)
            small = torch.ones(n // world, dtype=dtype, device=device)
            if kind == "all_gather":
                def op():
                    dist.all_gather_into_tensor(big, small)
            else:
                def op():
                    dist.reduce_scatter_tensor(small, big)
            for _ in range(3):
                op()
            _sync(device)
            t0 = time.perf_counter()
            if str(device).startswith("cuda"):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                for _ in range(reps):
                    op()
                e1.record()
                e1.synchronize()
                sec = e0.elapsed_time(e1) / 1e3 / reps
            else:
                for _ in range(reps):
                    op()
                sec = (time.perf_counter() - t0) / reps
            wire = n * esz * (world - 1) / world
            out[f"{kind} {name}"] = {"bytes": n * esz, "ms": sec * 1e3,
                                     "bus_bytes_per_s": wire / sec}
            del big, small
    return out


def _profile(step, device) -> dict:
    """Device kernel ms of one ``step()``: NCCL's, adamw_update's, the
    rest's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if str(device).startswith("cuda") else \
        [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        step()
        _sync(device)

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev(e) > 0]
    nccl = sum(dev(e) for e in kernels if "nccl" in e.key.lower()) / 1e3
    adamw = [e for e in kernels if "adamw" in e.key.lower()]
    return {"all_ms": sum(dev(e) for e in kernels) / 1e3, "nccl_ms": nccl,
            "adamw_ms": sum(dev(e) for e in adamw) / 1e3,
            "adamw_calls": sum(e.count for e in adamw)}


def _gather(x: dict, device) -> list:
    """Every rank's ``x`` (a dict of floats), in rank order."""
    import torch
    import torch.distributed as dist
    keys = sorted(x)
    t = torch.tensor([float(x[k]) for k in keys], dtype=torch.float64,
                     device=device)
    out = [torch.zeros_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return [dict(zip(keys, (float(v) for v in o))) for o in out]


def _batches(cfg, b, s, n):
    import numpy as np
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s),
                                        dtype=np.int32)}
        if cfg.n_prefix_embeds:
            batch["prefix_embeds"] = rng.standard_normal(
                (b, cfg.n_prefix_embeds, cfg.d_model), dtype=np.float32)
        out.append(batch)
    return out


def _run(cfg, ctx, device, shape: tuple, link_bw, compressed: bool) -> dict:
    """STEPS steps of the sharded (or compressed) step on global batches
    of ``shape`` (B, S), then a counted step and a profiled one (plain
    step only); ``link_bw``: the measured link's bytes/s, for the
    roofline's collective term."""
    import torch
    from repro_torch.configs import get_shape
    from repro_torch.kernels import cuda
    from repro_torch.models.lm import build_model
    from repro_torch.roofline import analysis
    from repro_torch.roofline.hw import H100_HW
    from repro_torch.sharding import collectives
    from repro_torch.train import AdamWConfig, trainstep
    model = build_model(cfg)
    ocfg = AdamWConfig()
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if compressed:
        state = trainstep.init_compressed_state(model, seed=0,
                                                device=device, ctx=ctx)
        step_fn = trainstep.make_compressed_train_step(model, ocfg, ctx)
    else:
        state = trainstep.init_state(model, seed=0, device=device, ctx=ctx)
        step_fn = trainstep.make_train_step(model, ocfg, ctx=ctx)
    _sync(device)
    init_s = time.perf_counter() - t0
    named = dict(state["params"].named_parameters())
    local = sum(p.numel() for p in named.values())
    b, s = shape
    batches = [{k: torch.from_numpy(v).to(device) for k, v in bt.items()}
               for bt in _batches(cfg, b, s, STEPS + 2)]
    walls, metrics, launches, wire = [], [], [], None
    for i in range(STEPS):
        for k in cuda.KERNELS.values():
            k.launches = 0
        _sync(device)
        t0 = time.perf_counter()
        with collectives.recording() as log:
            state, m = step_fn(state, batches[i])
            _sync(device)
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        launches.append({n: k.launches for n, k in cuda.KERNELS.items()
                         if k.launches})
        wire = log
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "params": cfg.n_params(), "local_params": local,
           "init_s": init_s, "step_wall_s": walls,
           "tokens_per_s": [b * (s + cfg.n_prefix_embeds) / w
                            for w in walls[1:]],
           "metrics": metrics, "launches": launches,
           "wire_bytes": collectives.summarize(wire)}
    if compressed:
        from repro_torch.train import compression
        int8 = sum(r.wire_bytes for r in wire if r.dtype == "int8")
        out["int8_wire_bytes"] = int8
        out["wire_bytes_fn_local"] = compression.wire_bytes(local, ctx.pod)
        out["wire_bytes_fn_whole"] = compression.wire_bytes(
            cfg.n_params(), ctx.pod)
    else:
        counts = analysis.count_flops(step_fn, state, batches[-2])
        _sync(device)
        shape = dataclasses.replace(get_shape("train_4k"), global_batch=b,
                                    seq_len=s)
        hw = dataclasses.replace(H100_HW, link_bw=link_bw)
        import torch.distributed as dist
        terms = analysis.roofline_terms(cfg, shape, dist.get_world_size(),
                                        counts, hw)
        out["counted"] = {k: counts[k] for k in (
            "flops", "collective_wire_bytes", "collective_wire_bytes_by_axis",
            "total_wire_bytes")}
        sizes = {a: ctx.axis_size(a) for a in ("pod", "data", "model")}
        out["ring_model"] = analysis.sharded_step_wire(
            cfg, sizes, b, s, cfg.n_prefix_embeds)
        out["roofline"] = terms
        out["collective_s_by_axis"] = analysis.collective_s_by_axis(counts,
                                                                    hw)
        t0 = time.perf_counter()
        prof = _profile(lambda: step_fn(state, batches[-1]), device)
        prof["wall_ms"] = (time.perf_counter() - t0) * 1e3
        out["profile"] = prof
    if str(device).startswith("cuda"):
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs and batch (a CPU rehearsal under "
                    "gloo)")
    ap.add_argument("--mesh", action="append", default=None,
                    help="a mesh of the step (repeatable): axis=size "
                    "pairs over data and model, e.g. model=4 or "
                    "data=2,model=2; default data=K")
    ap.add_argument("--arch", default="yi-9b",
                    help="the config the --mesh steps train")
    ap.add_argument("--layers", type=int, default=None,
                    help="its depth (default the config's)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import process_group
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_sharded_train: no CUDA device", file=sys.stderr)
        return 1
    device, owned = process_group(args.device)
    try:
        world = dist.get_world_size()
        rank = dist.get_rank()
        shape = REHEARSAL if args.reduced else (BATCH, SEQ)

        def cfg_of(arch):
            cfg = get_config(arch)
            return reduced(cfg) if args.reduced else cfg
        out = {"ranks": world, "backend": dist.get_backend()}
        cfg = cfg_of(args.arch)
        if args.layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        # a layer's w_in (a MoE's every expert's) in bf16
        layer = cfg.d_model * (cfg.moe.n_experts * cfg.moe.d_ff_expert
                               if cfg.moe else cfg.d_ff) * 2
        link = _link(device, world, {"256MiB": 256 * 2 ** 20,
                                     "w_in": layer})
        out["link"] = link
        big = [v["bus_bytes_per_s"] for k, v in link.items()
               if k.endswith("256MiB")]
        link_bw = out["link_bw"] = sum(big) / len(big)
        from repro_torch.launch.train import parse_mesh
        meshes = args.mesh or [f"data={world}"]
        out["meshes"] = meshes
        for text in meshes:
            mesh = make_mesh(*parse_mesh(text))
            run = _run(cfg, steps.mesh_ctx(mesh), device, shape, link_bw,
                       False)
            run["mesh"] = text
            run["per_rank"] = _gather({
                "peak_gib": run.get("peak_gib", 0.0),
                "wall_s": run["step_wall_s"][-1],
                "nccl_ms": run["profile"]["nccl_ms"],
                "all_ms": run["profile"]["all_ms"]}, device)
            out["zero" if text == f"data={world}" else text] = run
            del mesh
            if str(device).startswith("cuda"):
                torch.cuda.empty_cache()
        if not args.mesh:
            mesh = make_mesh((2, world // 2, 1), ("pod", "data", "model"))
            run = _run(cfg_of("internvl2-2b"), steps.mesh_ctx(mesh), device,
                       shape, link_bw, True)
            run["per_rank"] = _gather({"peak_gib": run.get("peak_gib", 0.0),
                                       "wall_s": run["step_wall_s"][-1]},
                                      device)
            out["compressed"] = run
        if rank == 0:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip().splitlines() \
                if args.device == "cuda" else ["cpu"]
            out["card"] = card
            print(f"cards: {card}")
            line = json.dumps(out)
            print(line)
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out",
                                   "sharded_train.json"), "w") as f:
                f.write(line + "\n")
        return 0
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
