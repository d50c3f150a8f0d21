"""Serving launcher: batched generation with the continuous-batching
engine (multi-strided rmsnorm and flash-decode kernels on the hot path;
one batched step per engine round).  The engine refuses models with
SSM state (mamba2, jamba) and encoder-decoder models (whisper): their
``prefill`` and ``decode_step`` serve them.

    python -m repro_torch.launch.serve --device cuda

``--shards K`` shards the KV cache's sequence K ways.  In one process it
is the static split on one card; under ``torchrun --nproc-per-node K``
(``WORLD_SIZE`` > 1) it is the collective merge, one rank a card over
NCCL, each rank holding its slice of the cache; with ``--device cpu``
the same command runs over gloo with the kernels' plain versions:

    python -m repro_torch.launch.serve --shards 4
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --shards 4
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --shards 2 \
        --device cpu

Under a process group only rank 0 prints.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.models.lm import build_model
from repro_torch.serve import ServeConfig, ServingEngine, serving_ctx


def process_group(device: str) -> tuple[str, bool]:
    """(the device this rank serves on, whether this call initialised the
    group).  Under a launcher that sets ``WORLD_SIZE`` > 1 and with no
    group yet: NCCL with one rank a card (``LOCAL_RANK``), or gloo on
    the CPU."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device, False
    if device == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=local)
        return str(local), True
    dist.init_process_group("gloo")
    return device, True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--shards", type=int, default=1,
                    help="KV sequence shards for the flash-decode merge "
                         "(collective over a process group of that many "
                         "ranks, the static split in one process)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request wall-clock budget in seconds")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission queue (default unbounded)")
    ap.add_argument("--stats", action="store_true",
                    help="dump engine.stats() as JSON on exit")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or the CPU's plain "
                         "kernel versions")
    args = ap.parse_args(argv)

    device, owned = process_group(args.device)
    try:
        cfg = reduced(get_config(args.arch))
        model = build_model(cfg)
        params = model.init(seed=0, device=device)
        ctx = serving_ctx(args.shards)
        engine = ServingEngine(
            model, params,
            ServeConfig(slots=args.slots, max_len=128,
                        max_new_tokens=args.max_new, shards=args.shards,
                        deadline_s=args.deadline, max_queue=args.max_queue),
            ctx=ctx)
        rng = np.random.default_rng(0)
        for uid in range(args.requests):
            engine.submit(uid, rng.integers(0, cfg.vocab_size,
                                            args.prompt_len))
        results = engine.run()
        if ctx is None or ctx.tp_rank == 0:
            for uid in sorted(results):
                print(f"req {uid}: {len(results[uid])} tokens -> "
                      f"{results[uid][:8]}...")
            if args.stats:
                json.dump(engine.stats(), sys.stdout, indent=1)
                print()
        return results
    finally:
        if owned:
            import torch.distributed as dist
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
