"""Serving launcher: batched generation with the continuous-batching
engine (multi-strided rmsnorm and flash-decode kernels on the hot path;
one batched step per engine round).  The engine refuses models with
SSM state (mamba2, jamba) and encoder-decoder models (whisper): their
``prefill`` and ``decode_step`` serve them.

    python -m repro_torch.launch.serve --device cuda
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.models.lm import build_model
from repro_torch.serve import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--shards", type=int, default=1,
                    help="KV sequence shards (only 1 is ported)")
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

    cfg = reduced(get_config(args.arch))
    model = build_model(cfg)
    params = model.init(seed=0, device=args.device)
    engine = ServingEngine(
        model, params,
        ServeConfig(slots=args.slots, max_len=128,
                    max_new_tokens=args.max_new, shards=args.shards,
                    deadline_s=args.deadline, max_queue=args.max_queue))
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        engine.submit(uid, rng.integers(0, cfg.vocab_size,
                                        args.prompt_len))
    results = engine.run()
    for uid in sorted(results):
        print(f"req {uid}: {len(results[uid])} tokens -> "
              f"{results[uid][:8]}...")
    if args.stats:
        json.dump(engine.stats(), sys.stdout, indent=1)
        print()
    return results


if __name__ == "__main__":
    main()
