#!/usr/bin/env python3
"""Serve decode step of the PyTorch port, timed on one card for several
checkouts in turn (an A/B of two commits, run as parent, change, change,
parent).

    python3 tools/torch_decode_step_ab.py ROOT [ROOT ...] [--steps N]

Each ROOT is a checkout of the repository (its ``src/repro_torch`` and
``csrc`` are built and run as they stand there).  For each ROOT, in its
own process: build the rmsnorm and decode_attn libraries, draw Yi-9B at
full width (48 layers, random weights from seed 0) and a 4-slot cache
of 4096 rows, and time ``CausalLM.decode_step`` at positions in
[16, 64) (the profile phase of ``chip_smoke.py``):

  * ``step_ms``: wall time of a synchronized step, the median and the
    least of 7 runs of N steps, and every run's value;
  * ``attn_host_us``: host time of one decode-attention call
    (``run_spec`` of the masked decode spec at the serve shape: B=4,
    S=4096, Hkv=4, dh=128, Hq=32, bf16, kv_len 17-64), the median and
    the least of 7 runs of 200 calls enqueued back to back, synchronized
    once at the end of a run, at the config the op resolves with none
    given (``decode_config``: D, P, block_rows and the resolve source);
    ``op_host_us`` the same for the ``decode_attn`` op itself (its
    config resolution and mask included); ``split_host_us`` and
    ``merge_host_us``
    the same for the kernel module's ``split`` and ``merge`` wrappers
    alone (the plan made once);
  * ``attn_events_ms``: CUDA events around a run of 200 ``run_spec``
    calls, divided by 200 (the host's pace where it is the slower).

The card's host is shared, so host times vary from process to process:
compare roots over several alternations, by their least times.

Prints one JSON line per ROOT, then the card's name and power limit.
"""
from __future__ import annotations

import os
import statistics
import sys
import time

import ab_turns


def one(root: str, steps: int, _first: bool) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.codegen import run_spec
    from repro_torch.codegen.transforms import plan_blocks
    from repro_torch.configs import get_config
    from repro_torch.core import StridingConfig
    from repro_torch.kernels import cuda
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.decode_attn import specs as dspecs
    from repro_torch.models.lm import build_model
    cuda.build(["rmsnorm", "decode_attn"])
    cfg = get_config("yi-9b")
    model = build_model(cfg)
    params = model.init(seed=0)
    b, s = 4, 4096
    cache = model.init_cache(b, s)
    rng = np.random.default_rng(4)
    pos = torch.as_tensor(rng.integers(16, 64, b), device="cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, 1)),
                           device="cuda")
    runs = []
    with torch.inference_mode():
        for _ in range(3):
            model.decode_step(params, toks, cache, pos)
        torch.cuda.synchronize()
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(steps):
                model.decode_step(params, toks, cache, pos)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / steps * 1e3)
    del model, params, cache
    torch.cuda.empty_cache()

    hkv, dh, hq, n = 4, 128, 32, 200
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").bfloat16()
               for shape in ((b, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    kv_len = torch.as_tensor(rng.integers(17, 65, b), device="cuda")
    inputs = (*dops._flatten(q, k, v), dops.validity_mask(kv_len, b, s,
                                                          "cuda"))
    build = dspecs.decode_spec(hkv, dh, masked=True)
    # the config the op runs with none given, from its kernel.resolve
    # event (each checkout's own resolution)
    with obs.collect() as col:
        dops.decode_attn(q, k, v, kv_len=kv_len)
    ev = col.named("kernel.resolve")[0].attrs
    scfg = StridingConfig(ev["d"], ev["p"], block_rows=ev["block_rows"])
    spec = build(*inputs)
    bp = plan_blocks(spec, scfg)
    states = dk.split(spec, bp, inputs)

    def host_us(fn):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        host, events = [], []
        for _ in range(7):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t1 = time.perf_counter()
            e1.record()
            torch.cuda.synchronize()
            host.append((t1 - t0) / n * 1e6)
            events.append(e0.elapsed_time(e1) / n)
        return host, events

    attn, events = host_us(lambda: run_spec(build, inputs, scfg))
    op, _ = host_us(lambda: dops.decode_attn(q, k, v, kv_len=kv_len))
    split, _ = host_us(lambda: dk.split(spec, bp, inputs))
    merge, _ = host_us(lambda: dk.merge(spec.combine, *states))
    out = {"root": root, "steps": steps, "step_runs_ms": runs,
           "decode_config": [ev["d"], ev["p"], ev["block_rows"],
                             ev["source"]]}
    for name, xs in (("step_ms", runs), ("attn_host_us", attn),
                     ("op_host_us", op),
                     ("split_host_us", split), ("merge_host_us", merge),
                     ("attn_events_ms", events)):
        out[name] = statistics.median(xs)
        out[name.replace("_ms", "_min_ms").replace("_us", "_min_us")] = min(xs)
    return out


if __name__ == "__main__":
    sys.exit(ab_turns.main(__file__, __doc__, one, "--steps", 10))
