#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

  1. device   — require CUDA; print the card, its count and its power limit
  2. build    — compile every CUDA source (one nvcc each, all at once) and
                print the -Xptxas -v register / shared-memory / spill lines,
                and one line of every doitgen, stream, rmsnorm, reduction,
                stream_reduction, decode_attn, gemver and stencil
                instance's registers and spill bytes (an rmsnorm, rowstat,
                column-dot, K1 stream, gemver_sum or stencil instance that
                spills fails the run)
  3. kernels  — each kernel against its plain PyTorch version on the card at
                the main path's shapes: rmsnorm at the decode rows (1, 4)
                and the train rows (8192) of 4096, 4 f32 rows of 12288 (a
                cluster), and rows that are not whole 16-byte vectors
                ([8, 1001], [3, 4098] in f32 and bf16: the narrower-lane
                instances, with a lost-element control), with each
                launch's geometry, a
                lost-chunk or lost-stream control and a sweep of the
                geometry's choices; max error vs the stated tolerance,
                and device times (CUDA graphs of many launches, timed with
                CUDA events): kernel, plain version, bound, and one PyTorch
                library call as a yardstick.  Decode at B=8 x S=32768, the
                serve shape (B=4, S=4096) and the profile's (kv_len 17-64):
                launch counts, both passes against SDPA and the bound over the rows kv_len leaves, a D sweep; a
                batch row with no valid position and a mask with holes;
                two runs' bits; chatglm3-6b's g=16; Phi-2's dh=80 and
                Phi-3-mini's dh=96 at kv_len 17-64 and uniform (B=4,
                S=4096) against the plain version, SDPA and the bound
  3b. linalg — mxv, mxv_t, bicg, gemver at 16384^2 and 4096^2 f32 through
                their public functions, each kernel against its plain
                version with lost-stream controls, and timed; mxv in
                bf16 and gemver_outer in bf16 and f16 at both sizes (the
                f32 arrays cast), with the row-dot's and gemver_outer's
                launch geometry in every type; the
                column-dot's launch geometry (cluster, blocks, clusters
                resident, waves) in f32 and bf16 and its cluster sweep at
                4096^2,
                mxv_t in bf16 against its plain fold with a lost-chunk
                control
  3c. stream  — read, copy, init, triad at 8192 x 4096 in f32 and bf16
                (K1, K2), the K4 ring at lookahead 1, 3, 4 (copy, triad,
                fill) and gemver_sum's ring at lookahead 1, 3; each kernel
                against its plain version (equality, or the f32 sum limit
                for the read) with lost-stream and lost-step controls,
                timed, each K1 launch's geometry (blocks, blocks an SM,
                waves, registers), each ring's launch
                geometry (tile, boxes a step,
                bytes a box, shared memory, blocks an SM, waves), the D
                and lookahead sweeps of the paper's Fig. 2, and sweeps
                over the ring's step rows and tile and the read's chunks
                an SM
  3d. stencil — jacobi2d and conv3x3 at 2050 x 2048 and 16386 x 16384,
                in f32 and bf16, and at 2050 x 2047 (an output row of 2045
                columns) in bf16 and f16; doitgen at
                (16, 256, 256) and (256, 256, 256) x (256, 256) in f32 and
                bf16 (on the tensor cores) and at the first in f16; through
                their public functions; each kernel against its plain
                version (equality for the stencils, the f32 dot limit for
                doitgen) with lost-stream, lost-tap, lost-tail-column and
                lost-tile controls, each stencil launch's geometry
                (streams, tiles, runs, blocks an SM, waves), timed, conv3x3's
                weight packing alone, and the D sweep at the larger sizes
                (the stencils in f32 and bf16, doitgen in f32 and bf16), and
                the stencils' again at a row pitch of 16386 elements
  3e. adamw  — the fused AdamW update at the registry's bench size
                (4096 x 1024 f32) and at Yi-9B's embedding (64000 x 4096
                f32) through its public op: the K1 kernel and the K4
                ring's adamw body at lookahead 1, 3, 4 (each ring's
                geometry); equality with the plain version, a lost-stream
                control, times against the bound and torch._fused_adamw_
  3f. k4      — the K4 ring's rank-1 side write (t_rowstat: o = 2 x next
                to r = sum_j f32(x), x f32 and bf16 at 8192 x 4096, whole-row
                steps) and its mixed operand dtypes (adamw_update with bf16
                p and g, f32 m and v, at 4096 x 1024), each at lookahead 1,
                3, 4: equality (the row sums within the f32 sum limit),
                lost-stream and lost-step controls, times against the bound
  3g. registry — every one of the 35 registry rows at its six conformance
                points and its bench size, kernels against plain versions
                at the row's rtol / atol (a line per family with the worst
                excess); then the five instances the *_gen rows brought
                (transpose, rowstat, gemver_mxv2, gemver_mxv1,
                gemver_mxv1_sum) at 16384^2 and 4096^2 f32 (transpose and
                rowstat also bf16 at both) through their public ops:
                equality or the f32 dot limit, lost-stream controls, and
                times against the bound and one PyTorch call
  4. serve    — Yi-9B at full width (random weights from a seeded
                torch.Generator) serves 8 requests x 16 tokens through the
                continuous-batching engine; the launch counts, reset just
                before the run, must show every step went through both
                kernels
  5. in-model — two decode steps with the kernels and with mode="ref" on
                the same weights, tokens and a cache filled in every decode
                segment; logits must agree within 2x a one-ulp rounding
                control, a lost segment must fall outside it, and argmax
                must agree wherever rounding cannot close the top-2 margin
  6. profile  — where a full-width decode step's time goes (host wall
                time, device busy share, decode attention's device time
                and launches, top kernels by device time)
  7. train    — with the serve model freed: Yi-9B at full width, 8 of 48
                layers, f32 params and bf16 compute, trains 6 steps of
                seq 4096 x batch 2 through the launcher's path; every
                step must launch rmsnorm 33 times and adamw_update 75
                times, step 0's loss lie in [11, 12]; then a bit-equal
                checkpoint round trip of the state, one step with the
                kernels against one with mode="ref" from the same state
                (with a lost-stream control), and where a step's time
                goes (torch.profiler)
  8. report   — a JSON line of kernels, the card's name and power limit, and
                as the last line {"ok": true, "device": {...}}

Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
# H100 SXM dense peaks by operand type: f32 outside the tensor cores;
# bf16 and f16 on the tensor cores (products exact in their f32 sums)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}

SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW, SERVE_REQUESTS = 4, 4096, 16, 8


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, arg_sets, reps: int = 20, replays: int = 5,
              hold: bool = False) -> float:
    """Device time of one ``fn(*args)`` call: ``reps`` calls, at least one
    per argument set (cycling over ``arg_sets``, so inputs larger than L2
    in total arrive cold), captured in one CUDA graph, replayed
    ``replays`` times between CUDA events.  With ``hold`` every call's
    output is kept to the end of the capture, so each call writes memory
    of its own: an output that fits L2 no longer stays there from one
    call to the next (the graph would otherwise give every call the same
    buffer), and its bytes reach HBM as the inputs' do."""
    import torch
    reps = max(reps, len(arg_sets))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    held = []
    with torch.cuda.graph(graph):
        for i in range(reps):
            out = fn(*arg_sets[i % len(arg_sets)])
            if hold:
                held.append(out)
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    t1.synchronize()
    ms = t0.elapsed_time(t1) / (replays * reps)
    del graph, held
    return ms


def bound_ms(nbytes: float, flops: float,
             dtype: str = "float32") -> tuple[float, str]:
    """The least time for the work: its bytes at the memory rate, or its
    operations at the card's peak for the operands' ``dtype``."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def ring_line(what: str, plan, sms: int, card: str) -> str:
    """One K4 ring's launch geometry (``kernels/manual.py`` ``ring_plan``):
    boxes a step, bytes a box, shared memory, blocks an SM and waves."""
    waves = -(-plan.blocks // (plan.per_sm * sms))
    return (f"{what} ring: tile {plan.tw} columns, {plan.copies} boxes a "
            f"step per operand of {'/'.join(map(str, plan.box_bytes))} B, "
            f"{plan.smem} B of shared memory, {plan.per_sm} blocks an SM, "
            f"{plan.blocks} blocks of {plan.per} steps ({plan.steps} steps), "
            f"{waves} wave{'s' if waves > 1 else ''} [{card}]")


def _copies(make, each_bytes: int, cap: int = 8) -> list:
    """Enough input copies (at most ``cap``) that one cycle through them
    exceeds 3x the 50 MB L2, so each call finds its inputs cold, as a
    decode layer finds its cache."""
    n = max(1, min(cap, -(-3 * 50 * 2 ** 20 // max(each_bytes, 1))))
    return [make() for _ in range(n)]


def phase_build(card: str) -> float:
    from repro_torch.kernels import cuda
    t0 = time.perf_counter()
    reports = cuda.build()
    secs = time.perf_counter() - t0
    for stem, text in sorted(reports.items()):
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                print(f"  [{stem}] {line.strip()}")
    print(f"build: {len(reports)} libraries in {secs:.1f} s "
          f"(nvcc, sm_90a) [{card}]")
    inst = {}
    for stem in ("doitgen", "stream", "rmsnorm", "reduction",
                 "stream_reduction", "decode_attn", "gemver", "stencil"):
        inst.update(ptxas_instances(reports.get(stem, "")))
    PTXAS.update(inst)
    print(f"ptxas doitgen, stream, rmsnorm, reduction, stream_reduction, "
          f"decode_attn, gemver and stencil instances, [registers, spill "
          f"store bytes, spill load bytes]: {json.dumps(inst)} [{card}]")
    spills = {n: v for n, v in inst.items()
              if any(w in n for w in ("rmsnorm", "rowstat", "rowdot",
                                      "coldot", "stream_copy",
                                      "stream_triad", "stream_init",
                                      "gemver_sum", "gemver_outer",
                                      "stencil<")) and any(v[1:])}
    if spills:
        raise AssertionError(f"build: rmsnorm / rowstat / row-dot / "
                             f"column-dot / K1 stream / gemver_sum / "
                             f"gemver_outer / stencil instances "
                             f"spill: {spills}")
    return secs


# {kernel instance: [registers, spill store bytes, spill load bytes]} of
# the build (ptxas_instances), for the geometry lines
PTXAS: dict = {}


def _regs(prefix: str):
    """The ptxas entry of the first instance whose name starts with
    ``prefix`` (None where the build printed none)."""
    return next((v for n, v in PTXAS.items() if n.startswith(prefix)), None)


def ptxas_instances(report: str) -> dict:
    """``{kernel instance: [registers, spill store bytes, spill load
    bytes]}`` from an ``-Xptxas -v`` report, the names demangled by
    ``c++filt`` where it is installed."""
    import re
    found, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            found[name] = [None, None, None]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            found[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found[name][0] = int(m.group(1))
    if found and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(found),
                               capture_output=True, text=True,
                               timeout=60).stdout.split("\n")
        found = {re.sub(r"\(anonymous namespace\)::", "", n).split("(")[0]
                 .removeprefix("void "): v
                 for n, v in zip(names, found.values())}
    return found


# (rows, width, dtype): the serve path's decode rows and the train
# step's rows of Yi-9B's 4096, a Mistral-Large-wide f32 row (12288:
# 48 KB, over one block's registers, so a cluster of two), and rows
# that are not whole 16-byte vectors (1001: 2-byte vectors in bf16,
# 4-byte in f32; 4098: 4- and 8-byte vectors over a cluster of two)
RMSNORM_CASES = ((1, 4096, "bfloat16"), (SERVE_SLOTS, 4096, "bfloat16"),
                 (8192, 4096, "bfloat16"), (8192, 4096, "float32"),
                 (SERVE_SLOTS, 12288, "float32"), (8, 1001, "bfloat16"),
                 (8, 1001, "float32"), (3, 4098, "bfloat16"),
                 (3, 4098, "float32"))
RMSNORM_SWEEP_CLUSTERS = (1, 2, 4, 8)     # at the decode rows
RMSNORM_SWEEP_ITEMS = (1, 2, 4, 16)       # items a block at 8192 rows


def check_rmsnorm(card: str, results: dict) -> None:
    """rmsnorm at the serve path's decode rows (1 and 4 of Yi-9B's 4096,
    bf16), the train step's 8192 rows (bf16, and f32) and 4 f32 rows of
    12288: each launch's geometry, the kernel against its plain version
    (o within one ulp of its dtype, r within 1e-5) with a control that
    must land outside the limit (a cluster rank's columns lost where the
    launch has a cluster, else stream 1's rows), and times; then the
    sweep of the geometry's choices (cluster size at the decode rows,
    items a block at 8192 rows)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.codegen import plan_blocks
    from repro_torch.kernels import common
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import specs as rspecs
    eps = 1e-5
    gen = torch.Generator(device="cuda").manual_seed(1)
    rtol_r = 1e-5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"rmsnorm: tolerance o: |d| <= u*|ref| + 1e-6 (one ulp of o's "
          f"dtype, u = 2^-7 in bf16, {rtol_r:g} in f32: the kernel's f32 "
          f"row sum is reassociated, which can flip one rounding); r: "
          f"|d| <= {rtol_r:g}*|ref| (f32 reassociation over the squares)")
    for t, dm, dt_name in RMSNORM_CASES:
        dt = getattr(torch, dt_name)
        rtol_o = 2.0 ** -7 if dt == torch.bfloat16 else rtol_r

        def make():
            x = torch.randn(t, dm, generator=gen, device="cuda")
            w = 1 + 0.1 * torch.randn(dm, generator=gen, device="cuda")
            return x.to(dt), w.to(dt)
        x, w = make()
        cfg = common.resolve_config("rmsnorm", None, t, rops._DEFAULT)
        bp = plan_blocks(rspecs.rmsnorm_spec(x, w, eps), cfg)
        g = rk.geometry(bp.rows, dm, x.element_size(), bp.d, sms)
        print(_rms_geometry_line(f"x [{t}, {dm}] {dt_name}", bp, g, dt,
                                 sms, card))
        o, r = rops.rmsnorm(x, w, eps, with_inv_rms=True)
        o_ref, r_ref = rops.rmsnorm(x, w, eps, mode="ref", with_inv_rms=True)
        torch.cuda.synchronize()
        lost, what = _rms_control(x, bp, g)
        lo, lr = rops.rmsnorm(lost, w, eps, mode="ref", with_inv_rms=True)
        ctl_o, ctl_r = {what: lo}, {what: lr}
        if g.vector_bytes < 16:         # narrow lanes: one element lost,
            one = x.clone()             # row 1's largest (it moves r too)
            row = min(1, t - 1)
            one[row, int(x[row].float().abs().argmax())] = 0
            eo, er = rops.rmsnorm(one, w, eps, mode="ref", with_inv_rms=True)
            ctl_o["lost element"], ctl_r["lost element"] = eo, er
        err_o, line_o = _hold(f"rmsnorm t={t} dm={dm} {dt_name} o", o, o_ref,
                              rtol_o * o_ref.float().abs() + 1e-6, ctl_o)
        err_r, line_r = _hold(f"rmsnorm t={t} dm={dm} {dt_name} r", r, r_ref,
                              rtol_r * r_ref.abs(), ctl_r)
        err_t = max(err_o, err_r)
        isz = x.element_size()
        sets = _copies(make, t * dm * isz)
        ms = device_ms(lambda a, b: rops.rmsnorm(a, b, eps), sets)
        plain = device_ms(lambda a, b: rops.rmsnorm(a, b, eps, mode="ref"),
                          sets)
        lib = device_ms(lambda a, b: F.rms_norm(a, (dm,), b, eps), sets)
        bms, by = bound_ms(2 * t * dm * isz + dm * isz + 4 * t, 4.0 * t * dm,
                           dt_name)
        print(f"rmsnorm t={t} dm={dm} {dt_name}: max_abs_err={err_t:g}; o "
              f"{line_o}; r {line_r}; ms={ms:.5f} plain_ms={plain:.5f} "
              f"bound_ms={bms:.6f} ({by}) library_ms={lib:.5f} "
              f"(F.rms_norm) [{card}]")
        if (t, dm, dt) == (SERVE_SLOTS, 4096, torch.bfloat16):
            results["rmsnorm"] = dict(          # the serve path's shape
                name="rmsnorm", route="cuda",
                source="src/repro_torch/csrc/rmsnorm.cu",
                replaces="src/repro/codegen/emit.py:410",
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib, max_abs_err=err_t,
                shape=f"x [{t}, {dm}] {dt_name}")
        sweep = {}
        if (t, dm, dt) == (SERVE_SLOTS, 4096, torch.bfloat16):
            sweep = {f"cluster {c}": rk.geometry(bp.rows, dm, isz, bp.d, sms,
                                                  cluster=c)
                     for c in RMSNORM_SWEEP_CLUSTERS}
        if (t, dm, dt) == (8192, 4096, torch.bfloat16):
            sweep = {f"{i} items a block": rk.geometry(bp.rows, dm, isz,
                                                       bp.d, sms, items=i)
                     for i in RMSNORM_SWEEP_ITEMS}
        for label, sg in sweep.items():
            sweep_ms = device_ms(lambda a, b: rk.launch(a, b, eps, bp, sg),
                                 sets)
            print(f"rmsnorm sweep x [{t}, {dm}] {dt_name} {label}: ms="
                  f"{sweep_ms:.5f} ({sg.blocks} blocks of {sg.threads} "
                  f"threads, {sg.vectors} vectors of {sg.streams} rows a "
                  f"thread, {sg.items} items a block) [{card}]")
        del sets, x, w, o, r, o_ref, r_ref, lost, lo, lr
        torch.cuda.empty_cache()


def _rms_control(x, bp, g):
    """x with one unit of the kernel's work lost, for the plain version:
    a cluster rank's columns (rank 1) where the launch has a cluster,
    else stream 1's rows, else (one stream) the vectors thread 1 holds."""
    lost = x.clone()
    per = g.vector_bytes // x.element_size()
    if g.cluster > 1:
        lost[:, g.chunk * per:2 * g.chunk * per] = 0
        return lost, "lost chunk"
    seg = bp.rows // bp.d
    if bp.d > 1:
        lost[seg:2 * seg] = 0
        return lost, "lost stream"
    for v in range(1, g.nvec, g.threads):
        lost[:, v * per:(v + 1) * per] = 0
    return lost, "lost thread"


def _rms_geometry_line(what, bp, g, dtype, sms, card) -> str:
    """One rmsnorm launch's geometry (``kernels/rmsnorm/kernel.py``
    ``geometry``): cluster, blocks, blocks an SM (the occupancy API) and
    waves."""
    from repro_torch.kernels.rmsnorm import kernel as rk
    per_sm = rk.occupancy(dtype, g)
    waves = -(-g.blocks // (per_sm * sms))
    return (f"rmsnorm {what} launch: D={bp.d}, cluster {g.cluster}, "
            f"{g.blocks} blocks of {g.threads} threads ({g.chunk} of a row's "
            f"{g.nvec} {g.vector_bytes}-byte vectors a block, {g.vectors} "
            f"a thread, "
            f"{g.streams} rows an item, {g.items} items a block), {per_sm} "
            f"blocks an SM, {waves} wave{'s' if waves > 1 else ''} [{card}]")


DECODE_SHAPES = ((8, 32768, "uniform"), (SERVE_SLOTS, SERVE_MAX_LEN,
                                          "uniform"),
                 (SERVE_SLOTS, SERVE_MAX_LEN, "profile"))
DECODE_D_SWEEP = (1, 2, 4, 8)
# (model, Hkv, Hq, dh): head dims of public models other than 2^k x 16
DECODE_HEAD_DIMS = (("phi-2", 32, 32, 80), ("phi-3-mini", 32, 32, 96))


def check_decode(card: str, results: dict) -> None:
    """The decode kernels (``csrc/decode_attn.cu``) at Yi-9B's heads
    (Hkv=4, dh=128, Hq=32, bf16): B=8 with a 32768-row cache and the
    serve shape (B=4, S=4096), kv_len uniform on [1, S], and the profile
    phase's shape (kv_len in [17, 64]).  Each: a main-path run with the
    counts set to 0 just before and read just after, the kernels against
    the plain version, the fold alone against its plain version, and
    device times of both passes, the plain version, SDPA and the bound
    over the rows kv_len leaves.  Then on the card: a batch row with no valid position and a
    mask with holes; two runs' bits; a D sweep; chatglm3-6b's g = 16."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.codegen import run_spec
    from repro_torch.core import StridingConfig
    from repro_torch.kernels import common, cuda
    from repro_torch.kernels.decode_attn import kernel as dk, ops as dops
    from repro_torch.kernels.decode_attn import specs as dspecs
    from repro_torch.codegen.transforms import plan_blocks
    hkv, dh, hq = 4, 128, 32
    atol = 1e-4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"decode_attn: tolerance out, lse: |d| <= {atol:g} + {atol:g}*|ref| "
          "(f32 reassociation: the kernel folds 64-row tiles, scores from "
          "the tensor cores in bf16, and merges chunk states; the plain "
          "version sums whole rows); main path: two launches (split, "
          f"merge); {sms} SMs, WAVES={dk.WAVES}, "
          f"MAX_UNITS={dk.MAX_UNITS} [{card}]")
    rng = np.random.default_rng(2)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def make_for(b, s, hkv_, hq_, mask):
        def make():
            k = torch.randn(b, s, hkv_, dh, generator=gen, device="cuda")
            v = torch.randn(b, s, hkv_, dh, generator=gen, device="cuda")
            q = torch.randn(b, hq_, dh, generator=gen, device="cuda")
            return (*dops._flatten(q.bfloat16(), k.bfloat16(), v.bfloat16()),
                    mask)
        return make

    def hold(what, got, ref):
        for g_, r_, name in zip(got, ref, ("out", "lse")):
            d = (g_ - r_).abs()
            if g_.shape != r_.shape or not bool(torch.isfinite(g_).all()):
                raise AssertionError(f"{what}: {name} shape or finiteness")
            if not bool((d <= atol + atol * r_.abs()).all()):
                raise AssertionError(f"{what}: {name} disagrees (max "
                                     f"|d|={d.max():g})")
        return max(float((g_ - r_).abs().max()) for g_, r_ in zip(got, ref))

    def sdpa_inputs(b, s, a):
        kf, vf, qf, mask = a
        k4 = kf.reshape(b, s, hkv, dh).transpose(1, 2).contiguous()
        v4 = vf.reshape(b, s, hkv, dh).transpose(1, 2).contiguous()
        return (qf.reshape(b, hq, 1, dh), k4, v4,
                (mask > 0.5)[:, None, None, :].contiguous())

    def sdpa(q_, k_, v_, m_):
        return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_,
                                              enable_gqa=True)

    build = dspecs.decode_spec(hkv, dh, masked=True)
    for b, s, kind in DECODE_SHAPES:
        lo = 17 if kind == "profile" else 1
        hi = 65 if kind == "profile" else s + 1
        kv_len = torch.as_tensor(rng.integers(lo, hi, b), device="cuda")
        mask = dops.validity_mask(kv_len, b, s, "cuda")
        cfg = common.resolve_config("decode_attn", None, s,
                                    StridingConfig(4, 1))
        make = make_for(b, s, hkv, hq, mask)
        inputs = make()
        spec = build(*inputs)
        bp = plan_blocks(spec, cfg)
        upb, chunks = dk.plan_chunks(b, s, bp.d, hkv, hq // hkv, sms)
        for k in cuda.KERNELS.values():
            k.launches = 0
        got = run_spec(build, inputs, cfg)              # the main path
        torch.cuda.synchronize()
        counts = {n: cuda.KERNELS[n].launches
                  for n in ("decode_attn", "decode_attn_merge")}
        want = {"decode_attn": 1, "decode_attn_merge": 1}
        if counts != want:
            raise AssertionError(f"decode_attn B={b} S={s}: launches "
                                 f"{counts}, expected {want}")
        ref = run_spec(build, inputs, cfg, mode="ref")
        err_t = hold(f"decode_attn B={b} S={s} {kind}", got, ref)
        # the fold alone, on the split kernel's states
        states = dk.split(spec, bp, inputs)
        m_got = dk.merge(spec.combine, *states)
        m_ref = dk.merge_plain(spec.combine, *states)
        torch.cuda.synchronize()
        em = max(float((a - r).abs().max()) for a, r in zip(m_got, m_ref))
        if em > 1e-5:
            raise AssertionError(f"decode_attn_merge B={b} S={s}: max "
                                 f"|d|={em:g} > 1e-5")

        sets = _copies(make, 2 * b * s * hkv * dh * 2)
        ms = device_ms(lambda *a: run_spec(build, a, cfg), sets)
        plain = device_ms(lambda *a: run_spec(build, a, cfg, mode="ref"),
                          sets)
        state_sets = [dk.split(spec, bp, a) for a in sets]
        ms_m = device_ms(lambda *st: dk.merge(spec.combine, *st),
                         state_sets)
        plain_m = device_ms(lambda *st: dk.merge_plain(spec.combine, *st),
                            state_sets)
        lib_sets = [sdpa_inputs(b, s, a) for a in sets]
        lib = device_ms(sdpa, lib_sets)
        del lib_sets
        rows = int(kv_len.sum())
        nbytes = (2 * rows * hkv * dh * 2 + b * hq * dh * 2 + b * s * 4
                  + b * hq * dh * 4 + b * hq * 4)
        bms, by = bound_ms(nbytes, 4.0 * rows * hq * dh, "bfloat16")
        nb_m = (b * chunks * (2 * hq + hq * dh) * 4 + b * hq * dh * 4
                + b * hq * 4)
        bms_m, by_m = bound_ms(nb_m, 6.0 * b * chunks * hq * dh)
        print(f"decode_attn B={b} S={s} Hkv={hkv} dh={dh} Hq={hq} bf16 "
              f"kv_len {kind} [{lo}, {hi - 1}] D={bp.d} {chunks} chunks of "
              f"{upb} units, sum(kv_len)={rows}: max_abs_err={err_t:g} "
              f"ms={ms:.5f} (both passes) plain_ms={plain:.5f} "
              f"bound_ms={bms:.6f} ({by}) library_ms={lib:.5f} (SDPA, "
              f"enable_gqa, on a [B, Hkv, S, dh] copy) "
              f"{ms / bms:.2f}x bound, {ms / lib:.2f}x SDPA; launches "
              f"{json.dumps(counts)} [{card}]")
        print(f"decode_attn_merge (the second pass alone) B={b} C={chunks} "
              f"Hq={hq} dh={dh}: max_abs_err={em:g} ms={ms_m:.5f} "
              f"plain_ms={plain_m:.5f} bound_ms={bms_m:.6f} ({by_m}) "
              f"[{card}]")
        if (b, s, kind) == (SERVE_SLOTS, SERVE_MAX_LEN, "uniform"):
            results["decode_attn"] = dict(
                name="decode_attn", route="cuda",
                source="src/repro_torch/csrc/decode_attn.cu",
                replaces="src/repro/codegen/emit.py:564",
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib, max_abs_err=err_t,
                shape=f"K,V [{b}, {s}, {hkv * dh}] bf16, Hq={hq}, kv_len "
                      f"uniform, both passes")
            results["decode_attn_merge"] = dict(
                name="decode_attn_merge", route="cuda",
                source="src/repro_torch/csrc/decode_attn.cu",
                replaces="src/repro/codegen/emit.py:564",
                ms=ms_m, plain_ms=plain_m, bound_ms=bms_m, bound_by=by_m,
                library_ms=None, max_abs_err=em,
                shape=f"states [{b}, {chunks}, {hq}x{dh}] f32")
        if kind == "uniform":
            for dd in DECODE_D_SWEEP:
                bpd = plan_blocks(spec, StridingConfig(dd, 1))
                t = device_ms(lambda *a: dk.merge(
                    spec.combine, *dk.split(build(*a), bpd, a)), sets)
                print(f"decode sweep D={dd} B={b} S={s} kv_len uniform: "
                      f"{dk.plan_chunks(b, s, dd, hkv, hq // hkv, sms)[1]} "
                      f"chunks, both passes ms={t:.5f} ({t / bms:.2f}x "
                      f"bound) [{card}]")
        del sets, state_sets, inputs, states
        torch.cuda.empty_cache()

    # a batch row with no valid position (the spec's mean of V over all
    # S rows, lse = -1e30 + log S) and a mask with holes; and
    # two runs' bits
    b, s = SERVE_SLOTS, SERVE_MAX_LEN
    cfg = StridingConfig(4, 1)
    holes = torch.zeros(b, s, device="cuda")
    holes[0] = (torch.rand(s, generator=gen, device="cuda") < 0.3).float()
    holes[1, :64] = 1.0
    holes[1, 1000:1064] = 1.0
    holes[1, s - 1] = 1.0
    holes[2, 2048:3000] = 1.0                 # row 3: no valid position
    cases = {"kv_len [0, 1, 2048, 4096]": dops.validity_mask(
                 torch.tensor([0, 1, 2048, 4096], device="cuda"), b, s,
                 "cuda"),
             "holes (row 3 empty)": holes}
    for what, mask in cases.items():
        inputs = make_for(b, s, hkv, hq, mask)()
        got = run_spec(build, inputs, cfg)
        again = run_spec(build, inputs, cfg)
        ref = run_spec(build, inputs, cfg, mode="ref")
        err = hold(f"decode_attn {what}", got, ref)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        if not same:
            raise AssertionError(f"decode_attn {what}: two runs differ")
        empty = mask.sum(1) == 0
        mean_v = inputs[1].float().reshape(b, s, hkv, dh).mean(1)
        mean_err = float((got[0].reshape(b, hkv, hq // hkv, dh)[empty]
                          - mean_v[empty][:, :, None]).abs().max())
        if mean_err > atol:
            raise AssertionError(f"decode_attn {what}: the empty row is not "
                                 f"the mean of V ({mean_err:g})")
        print(f"decode_attn {what} B={b} S={s}: max_abs_err={err:g}; "
              f"empty row vs mean of V max|d|={mean_err:g}, lse "
              f"{float(got[1][empty].max()):g}; two runs bit-equal {same} "
              f"[{card}]")
        del inputs
    torch.cuda.empty_cache()

    # chatglm3-6b's group (g = Hq / Hkv = 16, dh = 128) at the serve shape:
    # two 8-head tensor-core tiles a block
    b, s, hkv16, hq16 = SERVE_SLOTS, SERVE_MAX_LEN, 2, 32
    kv_len = torch.as_tensor(rng.integers(1, s + 1, b), device="cuda")
    cfg = common.resolve_config("decode_attn", None, s, StridingConfig(4, 1))
    build16 = dspecs.decode_spec(hkv16, dh, masked=True)
    make_g16 = make_for(b, s, hkv16, hq16,
                        dops.validity_mask(kv_len, b, s, "cuda"))
    inputs = make_g16()
    n0 = dk.SPLIT.launches
    got = run_spec(build16, inputs, cfg)
    ref = run_spec(build16, inputs, cfg, mode="ref")
    torch.cuda.synchronize()
    if dk.SPLIT.launches != n0 + 1:
        raise AssertionError("decode_attn g=16: the split kernel did not run")
    err_t = hold("decode_attn g=16", got, ref)
    sets = _copies(make_g16, 2 * b * s * hkv16 * dh * 2)
    ms = device_ms(lambda *a: run_spec(build16, a, cfg), sets)
    print(f"decode_attn g=16 (chatglm3-6b's group) B={b} S={s} Hkv={hkv16} "
          f"dh={dh} Hq={hq16} bf16 D={cfg.stride_unroll}: "
          f"max_abs_err={err_t:g} "
          f"(tolerance as above) ms={ms:.5f} [{card}]")
    del sets, inputs
    torch.cuda.empty_cache()

    # head dims that are not 16, 32, 64 or 128: Phi-2's 80 and
    # Phi-3-mini's 96 (32 query and 32 KV heads each), at the profile
    # phase's kv_len 17-64 and kv_len uniform on [1, S], B=4, S=4096
    for model, hkv_d, hq_d, dh_d in DECODE_HEAD_DIMS:
        build_d = dspecs.decode_spec(hkv_d, dh_d, masked=True)
        for kind in ("profile", "uniform"):
            lo, hi = (17, 65) if kind == "profile" else (1, s + 1)
            kv_len = torch.as_tensor(rng.integers(lo, hi, b), device="cuda")
            mask = dops.validity_mask(kv_len, b, s, "cuda")

            def make_d(mask=mask, hkv_d=hkv_d, hq_d=hq_d, dh_d=dh_d):
                k = torch.randn(b, s, hkv_d, dh_d, generator=gen,
                                device="cuda")
                v = torch.randn(b, s, hkv_d, dh_d, generator=gen,
                                device="cuda")
                q = torch.randn(b, hq_d, dh_d, generator=gen, device="cuda")
                return (*dops._flatten(q.bfloat16(), k.bfloat16(),
                                       v.bfloat16()), mask)
            inputs = make_d()
            for k in cuda.KERNELS.values():
                k.launches = 0
            got = run_spec(build_d, inputs, cfg)        # the main path
            torch.cuda.synchronize()
            counts = {n: cuda.KERNELS[n].launches
                      for n in ("decode_attn", "decode_attn_merge")}
            if counts != {"decode_attn": 1, "decode_attn_merge": 1}:
                raise AssertionError(f"decode_attn dh={dh_d}: launches "
                                     f"{counts}")
            ref = run_spec(build_d, inputs, cfg, mode="ref")
            err_t = hold(f"decode_attn dh={dh_d} {kind}", got, ref)
            sets = _copies(make_d, 2 * b * s * hkv_d * dh_d * 2)
            ms = device_ms(lambda *a: run_spec(build_d, a, cfg), sets)
            plain = device_ms(lambda *a: run_spec(build_d, a, cfg,
                                                  mode="ref"), sets)

            def sdpa_d(q_, k_, v_, m_):
                return F.scaled_dot_product_attention(
                    q_, k_, v_, attn_mask=m_, enable_gqa=True)
            lib_sets = [(qf.reshape(b, hq_d, 1, dh_d),
                         kf.reshape(b, s, hkv_d, dh_d).transpose(1, 2)
                         .contiguous(),
                         vf.reshape(b, s, hkv_d, dh_d).transpose(1, 2)
                         .contiguous(),
                         (m > 0.5)[:, None, None, :].contiguous())
                        for kf, vf, qf, m in sets]
            lib = device_ms(sdpa_d, lib_sets)
            del lib_sets
            rows = int(kv_len.sum())
            nbytes = (2 * rows * hkv_d * dh_d * 2 + b * hq_d * dh_d * 2
                      + b * s * 4 + b * hq_d * dh_d * 4 + b * hq_d * 4)
            bms, by = bound_ms(nbytes, 4.0 * rows * hq_d * dh_d, "bfloat16")
            print(f"decode_attn dh={dh_d} ({model}) B={b} S={s} Hkv={hkv_d} "
                  f"Hq={hq_d} bf16 kv_len {kind} [{lo}, {hi - 1}] "
                  f"D={cfg.stride_unroll}, sum(kv_len)={rows}: "
                  f"max_abs_err={err_t:g} (tolerance as above) "
                  f"ms={ms:.5f} (both passes) plain_ms={plain:.5f} "
                  f"bound_ms={bms:.6f} ({by}) library_ms={lib:.5f} (SDPA, "
                  f"enable_gqa) {ms / bms:.2f}x bound, {ms / lib:.2f}x SDPA; "
                  f"launches {json.dumps(counts)} [{card}]")
            del sets, inputs, got, ref
            torch.cuda.empty_cache()


GAMMA = 2.0 ** -24              # f32 unit roundoff
LAMBDA = 8.0                    # confidence of the probabilistic dot limit
LINALG_SIZES = (16384, 4096)    # square f32 matrices: 1 GiB, 64 MiB
GEMVER_SUM_N = 4 * 2 ** 20      # the registry's bench size of gemver_sum
COLDOT_CLUSTERS = (1, 2, 4, 8)    # the column-dot's cluster sweep
ALPHA, BETA = 1.5, 1.2


def _dot_factor(n: int) -> float:
    """c in the limit c 2^-24 sum|a x| on how far a computed f32 dot of
    length n lies from the exact one.  Worst case c = n.  With rounding
    errors independent and of mean zero (Higham and Mary, SIAM J. Sci.
    Comput. 41 (2019), Thm 3.1), c = LAMBDA sqrt(n) holds except with
    probability at most 2 n exp(-LAMBDA^2 / 2), 4e-10 per dot at
    n = 16384; the smaller of the two is used."""
    return min(float(n), LAMBDA * n ** 0.5)


def _dot_limit(terms, ref, n: int):
    """Limit on |kernel - plain| of an f32 dot of length n: each sum lies
    within _dot_factor(n) 2^-24 sum|a x| of the exact one, and each is
    rounded once more into the output (f32 here)."""
    return 2 * _dot_factor(n) * GAMMA * terms + 2 * GAMMA * ref.abs()


def _total_limit(col_terms, rounds_per_col: int, row_abs_sum,
                 n: int, total):
    """Limit on |kernel - plain| of a total of n f32 row entries, each
    entry itself an f32 sum: every rounding error of both computations
    lies within 2^-24 times the largest partial sum it rounds (for an
    entry's rounds_per_col roundings on both sides, col_terms[j] =
    sum|terms| of entry j; for the 2 n roundings of the two totals,
    row_abs_sum = sum_j |entry_j|).  With the errors independent and of
    mean zero (as _dot_factor assumes), Hoeffding's inequality puts
    their sum within LAMBDA 2^-24 sqrt(sum of squared bounds) except with
    probability 2 exp(-LAMBDA^2 / 2); plus the output rounding."""
    import torch
    sq = rounds_per_col * (col_terms.double() ** 2).sum() + (
        2 * n * row_abs_sum.double() ** 2)
    return (LAMBDA * GAMMA * torch.sqrt(sq)
            + 2 * GAMMA * total.abs().double()).float()


def _excess(got, ref, limit) -> float:
    """max (|got - ref| - limit): <= 0 inside the limit."""
    return float(((got.float() - ref.float()).abs() - limit).max())


def _hold(what, got, ref, limit, controls) -> tuple[float, str]:
    """Hold a kernel's output against its plain version: same shape and
    dtype, finite, |got - ref| within ``limit``, and every control (a
    plain output with a fault put in) above it.  Returns the max error
    and a line of the controls' distances."""
    import torch
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype}, "
                             f"expected {tuple(ref.shape)} {ref.dtype}")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: non-finite values")
    if _excess(got, ref, limit) > 0:
        raise AssertionError(f"{what}: disagrees with its plain version "
                             "beyond the limit")
    seen = []
    for name, control in controls.items():
        if _excess(control, ref, limit) <= 0:
            raise AssertionError(f"{what}: the {name} control stays "
                                 "inside the limit")
        seen.append(f"{name} max|d|="
                    f"{float((control.float() - ref.float()).abs().max()):.4g}")
    err = float((got.float() - ref.float()).abs().max())
    return err, ", ".join(seen)


def phase_linalg(card: str, results: dict) -> None:
    """The paper's own kernels (mxv, mxv_t, bicg, gemver) through their
    public functions at full size, then each kernel against its plain
    version with a lost-stream control, and timed.

    Every count is set to 0 just before the op calls of a size and read
    just after; the JSON line's launches are their sum over both sizes."""
    import torch
    from repro_torch.codegen import plan_blocks
    from repro_torch.kernels import cuda
    from repro_torch.kernels.bicg import bicg
    from repro_torch.kernels.gemver import gemver, gemver_outer, gemver_sum
    from repro_torch.kernels.gemver import kernel as gk  # noqa: F401 (counts)
    from repro_torch.kernels.mxv import kernel as mk
    from repro_torch.kernels.mxv import mxv, mxv_t
    from repro_torch.kernels.mxv import specs as mspecs
    from repro_torch.kernels.mxv.ops import _DEFAULT as MXV_DEFAULT
    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    names = ("mxv", "mxv_t", "gemver_outer", "gemver_sum")
    launches = dict.fromkeys(names, 0)
    print(f"linalg: tolerances: dot products (mxv, mxv_t, bicg, gemver's "
          f"x and w) |d| <= 2 c 2^-24 sum|a x| + 2^-23 |ref| with c = "
          f"min(n, {LAMBDA:g} sqrt n) (each f32 sum lies within c 2^-24 "
          f"sum|a x| of the exact one: worst case c = n, and c = "
          f"{LAMBDA:g} sqrt n but with probability 2 n exp(-{LAMBDA:g}^2/2) "
          f"for independent mean-zero roundings, Higham and Mary 2019; plus "
          f"one output rounding each; in bf16 a rank's c over its rows "
          f"against the plain fold in the kernel's rank order, plus 2^-8 "
          f"|ref| for the output's rounding); gemver_outer, gemver_sum "
          f"|d| <= 2^-24 "
          f"|ref| (the kernels round each operation as the body does). "
          f"Controls, the plain version with stream k=1's segment dropped "
          f"and (dot products) with one bm-row tile of it dropped, must land "
          f"above each limit [{card}]")
    for n in LINALG_SIZES:
        gen = torch.Generator(device="cuda").manual_seed(12 + n)

        def vec(length=n):
            return torch.randn(length, generator=gen, device="cuda")
        a = torch.randn(n, n, generator=gen, device="cuda")
        x, y, r, p, u1, v1, u2, v2, z = (vec() for _ in range(9))
        for k in cuda.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = {"mxv": mxv(a, x), "mxv_t": mxv_t(a, y), "bicg": bicg(a, r, p),
               "gemver": gemver(a, u1, v1, u2, v2, y, z, ALPHA, BETA)}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: cuda.KERNELS[name].launches for name in names}
        want = {"mxv": 3, "mxv_t": 3, "gemver_outer": 1, "gemver_sum": 1}
        if counts != want:
            raise AssertionError(f"linalg n={n}: launches {counts}, "
                                 f"expected {want}")
        for name in names:
            launches[name] += counts[name]
        ref = {"mxv": mxv(a, x, mode="ref"), "mxv_t": mxv_t(a, y, mode="ref"),
               "bicg": bicg(a, r, p, mode="ref"),
               "gemver": gemver(a, u1, v1, u2, v2, y, z, ALPHA, BETA,
                                mode="ref")}
        aa = a.abs()
        checks = [("mxv", out["mxv"], ref["mxv"],
                   _dot_limit(aa @ x.abs(), ref["mxv"], n)),
                  ("mxv_t", out["mxv_t"], ref["mxv_t"],
                   _dot_limit(y.abs() @ aa, ref["mxv_t"], n)),
                  ("bicg q", out["bicg"][0], ref["bicg"][0],
                   _dot_limit(aa @ p.abs(), ref["bicg"][0], n)),
                  ("bicg s", out["bicg"][1], ref["bicg"][1],
                   _dot_limit(r.abs() @ aa, ref["bicg"][1], n))]
        a_hat, gx, gw = out["gemver"]
        ra, rx, rw = ref["gemver"]
        checks.append(("gemver A_hat", a_hat, ra, GAMMA * ra.abs()))
        # x = 0 + beta A_hat^T y + z: the sum's limit, then the scaling
        # and the add each round once more on each side
        checks.append(("gemver x", gx, rx,
                       BETA * _dot_limit(y.abs() @ ra.abs(), rx, n)
                       + 4 * GAMMA * (rx.abs() + z.abs())))
        # w = alpha A_hat x, held against the plain step on the kernels' x
        rw_x = ALPHA * mspecs.row_dot(ra, gx)
        checks.append(("gemver w", gw, rw_x,
                       ALPHA * _dot_limit(ra.abs() @ gx.abs(), rw_x, n)))
        for what, got, want_t, limit in checks:
            if not bool(torch.isfinite(got).all()) or got.shape != want_t.shape:
                raise AssertionError(f"linalg n={n}: {what} is not finite or "
                                     f"has shape {tuple(got.shape)}")
            if _excess(got, want_t, limit) > 0:
                raise AssertionError(f"linalg n={n}: {what} disagrees with "
                                     "the plain version")
        print(f"linalg n={n} f32: mxv, mxv_t, bicg, gemver agree with their "
              f"plain versions within the limits; op calls {wall:.3f} s "
              f"host wall, launches {json.dumps(counts)} [{card}]")
        del out, ref, checks, a_hat, gx, gw, ra, rx, rw, rw_x
        torch.cuda.empty_cache()

        # each kernel: error vs limit, lost-stream control, times
        spec_t = mspecs.mxv_t_spec(a, y)
        bp = plan_blocks(spec_t, MXV_DEFAULT)
        seg = n // bp.d

        def drop_rows(t, start, count, width=1):
            """t with rows start ... start+count-1 (of width elements)
            zeroed."""
            t = t.clone().reshape(-1)
            t[start * width:(start + count) * width] = 0
            return t

        def ratio(got, want_t, limit):
            d = (got.float() - want_t.float()).abs()
            if not bool((limit > 0).any()):     # |d| = 0: the distance
                return float(d.max())
            return float((d / limit.clamp_min(1e-30)).max())

        def measure(name, fn, plain, library, make, nbytes, flops,
                    got, want_t, limit, controls, shape, cap=8, entry=True,
                    hold=False, dtype="float32"):
            err = float((got.float() - want_t.float()).abs().max())
            if _excess(got, want_t, limit) > 0:
                raise AssertionError(f"{name} n={n}: max |d|={err:g} over "
                                     "its limit")
            for what, control in controls.items():
                if _excess(control, want_t, limit) <= 0:
                    raise AssertionError(f"{name} n={n}: the {what} control "
                                         "stays inside the limit")
            ctl = " ".join(f"{what}={ratio(c, want_t, limit):.4g}"
                           for what, c in controls.items())
            sets = _copies(make, nbytes, cap)
            ms = device_ms(fn, sets, hold=hold)
            plain_ms = device_ms(plain, sets, hold=hold)
            lib_ms = device_ms(library, sets, hold=hold) if library else None
            bms, by = bound_ms(nbytes, flops, dtype)
            print(f"{name} {shape}: max_abs_err={err:g} "
                  f"max|d|/limit={ratio(got, want_t, limit):.4g} "
                  f"max(limit)={float(limit.max()):.4g}; controls "
                  f"max|d|/limit: {ctl}; ms={ms:.5f} plain_ms={plain_ms:.5f}"
                  f" bound_ms={bms:.6f} ({by}) library_ms="
                  + ("none" if lib_ms is None else f"{lib_ms:.5f}")
                  + f" ({len(sets)} input sets) [{card}]")
            if n == LINALG_SIZES[0] and entry:
                results[name] = dict(
                    name=name, route="cuda", source=SOURCES[name][0],
                    replaces=SOURCES[name][1], ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms,
                    max_abs_err=err, shape=shape)
            del sets

        f32 = f"[{n}, {n}] f32"
        bm_row = plan_blocks(mspecs.mxv_spec(a, x), MXV_DEFAULT).bm
        y_k, y_p = mxv(a, x), mxv(a, x, mode="ref")
        measure("mxv", lambda a_, x_: mxv(a_, x_),
                lambda a_, x_: mxv(a_, x_, mode="ref"),
                lambda a_, x_: torch.mv(a_, x_),
                lambda: (torch.randn(n, n, generator=gen, device="cuda"),
                         vec()) if n < 8192 else (a, x),
                n * n * 4 + 2 * n * 4, 2.0 * n * n, y_k, y_p,
                _dot_limit(aa @ x.abs(), y_p, n),
                {"lost segment": drop_rows(y_p, seg, seg),
                 "lost tile": drop_rows(y_p, seg, bm_row)},
                f"A {f32}, D={bp.d}, P={MXV_DEFAULT.portion_unroll}")
        yt_k, yt_p = mxv_t(a, y), mxv_t(a, y, mode="ref")
        measure("mxv_t", lambda a_, y_: mxv_t(a_, y_),
                lambda a_, y_: mxv_t(a_, y_, mode="ref"),
                lambda a_, y_: torch.mv(a_.t(), y_),
                lambda: (torch.randn(n, n, generator=gen, device="cuda"),
                         vec()) if n < 8192 else (a, y),
                n * n * 4 + 2 * n * 4, 2.0 * n * n, yt_k, yt_p,
                _dot_limit(y.abs() @ aa, yt_p, n),
                {"lost segment": mxv_t(a, drop_rows(y, seg, seg), mode="ref"),
                 "lost tile": mxv_t(a, drop_rows(y, seg, bp.bm), mode="ref")},
                f"A {f32}, D={bp.d}, one launch (a cluster of "
                f"{mk.launch_geometry(bp, a).cluster} a column block)")
        # the column-dot's launch geometry and its cluster sweep, f32 and
        # bf16; bf16 against the plain fold in the kernel's rank order
        for dt in (torch.float32, torch.bfloat16):
            dname = "f32" if dt == torch.float32 else "bf16"
            ab, yb = a.to(dt), y.to(dt)
            spec_d = mspecs.mxv_t_spec(ab, yb)
            g = mk.launch_geometry(bp, ab)
            print(f"mxv_t A [{n}, {n}] {dname} launch: D={bp.d}, "
                  f"{g.ncb} column blocks of 128, cluster {g.cluster} "
                  f"({mk.clusters(dt, bp.d, g.cluster)} clusters "
                  f"resident), {g.blocks} blocks of {mk.THREADS} threads "
                  f"({g.column_threads} "
                  f"column threads x {g.row_groups} row groups), a step "
                  f"{g.streams} streams x {g.slots} slots, {g.rows_a_rank} "
                  f"rows of each segment a rank, {g.waves} wave"
                  f"{'s' if g.waves > 1 else ''} [{card}]")
            # the sweep at 4096^2 only (at 16384^2 the geometry's
            # cluster of 2 already fills the card; the A/B tool times it)
            if n < 8192:
                sets_d = _copies(
                    lambda: (torch.randn(n, n, generator=gen, device="cuda")
                             .to(dt), vec().to(dt)),
                    n * n * ab.element_size())
                for cs in COLDOT_CLUSTERS:
                    gs = mk.launch_geometry(bp, ab, cs)
                    t = device_ms(lambda a_, y_, _cs=cs: mk.coldot(
                        mspecs.mxv_t_spec(a_, y_), bp, [a_, y_],
                        cluster=_cs), sets_d)
                    print(f"mxv_t sweep A [{n}, {n}] {dname} D={bp.d}: "
                          f"cluster {cs}{'*' if cs == g.cluster else ''} "
                          f"({gs.blocks} blocks, "
                          f"{mk.clusters(dt, bp.d, cs)} clusters "
                          f"resident): ms={t:.5f} [{card}]")
                del sets_d
            if dt == torch.bfloat16:
                part = mk.split_plain(spec_d, bp, [ab, yb], g)
                yk = mxv_t(ab, yb)
                ref_b = mk.merge_plain(part, torch.float32)
                terms = yb.float().abs() @ ab.float().abs()
                limit = (2 * _dot_factor(g.rows_a_rank * bp.d) * GAMMA * terms
                         + 2.0 ** -8 * ref_b.abs() + 2 * GAMMA * ref_b.abs())
                lost_k = part.clone()
                lost_k[1] = 0
                measure("mxv_t", lambda a_, y_: mxv_t(a_, y_),
                        lambda a_, y_: mxv_t(a_, y_, mode="ref"),
                        lambda a_, y_: torch.mv(a_.t(), y_),
                        (lambda: (torch.randn(n, n, generator=gen,
                                              device="cuda").to(dt),
                                  vec().to(dt))) if n < 8192
                        else (lambda: (ab, yb)), n * n * 2 + 2 * n * 2,
                        2.0 * n * n, yk, ref_b, limit,
                        {"lost chunk": mk.merge_plain(lost_k,
                                                      torch.float32)},
                        f"A [{n}, {n}] bf16, D={bp.d}, one launch (cluster "
                        f"{g.cluster}), vs the plain fold in rank order",
                        entry=False)
                del part, yk, ref_b, terms, limit, lost_k
            del ab, yb
        del y_k, y_p, yt_k, yt_p
        o_k = gemver_outer(a, u1, v1, u2, v2)
        o_p = gemver_outer(a, u1, v1, u2, v2, mode="ref")
        measure("gemver_outer",
                lambda *t: gemver_outer(*t),
                lambda *t: gemver_outer(*t, mode="ref"),
                lambda a_, u1_, v1_, u2_, v2_: torch.addr(
                    torch.addr(a_, u1_, v1_), u2_, v2_),
                lambda: ((torch.randn(n, n, generator=gen, device="cuda"),
                          vec(), vec(), vec(), vec()) if n < 8192
                         else (a, u1, v1, u2, v2)),
                2 * n * n * 4 + 4 * n * 4, 4.0 * n * n, o_k, o_p,
                GAMMA * o_p.abs(),
                {"lost segment": drop_rows(o_p, seg, seg, n).reshape(n, n)},
                f"A {f32}, D={bp.d}, P={MXV_DEFAULT.portion_unroll}")
        del o_k, o_p
        linalg_16bit(card, n, a, x, u1, v1, u2, v2, vec, gen, bp, bm_row,
                     sms, measure, drop_rows)
        del a, aa
        torch.cuda.empty_cache()
        if n == LINALG_SIZES[0]:
            vn = GEMVER_SUM_N
            xs, zs = vec(vn), vec(vn)
            cols = 128 * MXV_DEFAULT.portion_unroll
            tile_rows = -(-vn // cols) // MXV_DEFAULT.stride_unroll
            s_k, s_p = gemver_sum(xs, zs), gemver_sum(xs, zs, mode="ref")
            measure("gemver_sum", lambda *t: gemver_sum(*t),
                    lambda *t: gemver_sum(*t, mode="ref"),
                    lambda x_, z_: x_ + z_,
                    lambda: (vec(vn), vec(vn)), 3 * vn * 4, float(vn),
                    s_k, s_p, GAMMA * s_p.abs(),
                    {"lost segment": drop_rows(s_p, tile_rows, tile_rows,
                                               cols)},
                    f"x, z [{vn}] f32 ({-(-vn // cols)} x {cols} tiles, "
                    f"D={MXV_DEFAULT.stride_unroll}; every call's output "
                    f"held)", hold=True)
            del xs, zs, s_k, s_p
            check_gemver_sum(card, vec, sms)
        del x, y, r, p, u1, v1, u2, v2, z
        torch.cuda.empty_cache()
    for name in names:
        results[name]["launches"] = launches[name]
    print(f"linalg: phase took {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")


def _launch_lines(card, n, dt, d, sms) -> None:
    """The row-dot's and gemver_outer's launch geometry on A [n, n] of
    ``dt`` in ``d`` streams, with their registers and spill bytes."""
    import torch
    from repro_torch.kernels.gemver import kernel as gk
    from repro_torch.kernels.gen.kernel import ROWSTAT_BLOCKS_PER_SM
    from repro_torch.kernels.mxv import kernel as mk
    isz = torch.empty((), dtype=dt).element_size()
    name = str(dt).removeprefix("torch.")
    ct = _CTYPES[name]
    r = mk.rowdot_geometry(n, n, isz, d, sms)
    waves = r.blocks / (ROWSTAT_BLOCKS_PER_SM * sms)
    print(f"mxv A [{n}, {n}] {name} launch: D={d}, {r.blocks} blocks of "
          f"{r.slots} row slots, {r.streams} streams a group, {r.parts} "
          f"parts a slot of {r.per_part} of a row's {r.units} 16-byte lane "
          f"units{' + an 8-byte tail' if r.tail else ''}, x "
          + (f"in {r.smem} B of shared memory" if r.smem else "by __ldg")
          + f", {waves:.2f} waves of two blocks an SM; ptxas rowdot "
          f"[registers, spill bytes]: "
          f"{_regs(f'rowdot<{ct}, {r.streams}, {str(bool(r.smem)).lower()}>')}"
          f" [{card}]")
    g = gk.outer_geometry(n, n, isz, d, sms)
    per_sm = gk.outer_occupancy(dt, d)
    print(f"gemver_outer A [{n}, {n}] {name} launch: D={d}, {g.tiles} "
          f"column tiles of {g.threads} 16-byte vectors of {g.vec} "
          f"elements x {g.runs} runs of {g.run} row slots = {g.blocks} "
          f"blocks, a step {g.streams} streams x {g.slots} slots, "
          f"{g.steps} steps a block, {per_sm} blocks an SM, "
          f"{g.blocks / (per_sm * sms):.2f} waves; ptxas gemver_outer "
          f"[registers, spill bytes]: "
          f"{_regs(f'gemver_outer<{ct}, {g.streams}>')} [{card}]")


LINALG_16BIT = ("bfloat16", "float16")


def linalg_16bit(card, n, a, x, u1, v1, u2, v2, vec, gen, bp, bm_row, sms,
                 measure, drop_rows) -> None:
    """The row-dot (mxv) in bf16 and gemver_outer in bf16 and f16 at
    A [n, n], on the phase's f32 arrays cast (nothing new is drawn at
    16384^2), with the launch lines of every type: mxv within the dot
    limit plus 2^-8 |ref| for the output's rounding, with lost-segment
    and lost-tile controls; gemver_outer equal to its plain version, with
    a lost-segment control; each timed (outputs held) beside the bound,
    its plain version and torch.mv / torch.addr twice."""
    import torch
    from repro_torch.kernels.gemver import gemver_outer
    from repro_torch.kernels.mxv import mxv
    seg = n // bp.d
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        _launch_lines(card, n, dt, bp.d, sms)
    for dt_name in LINALG_16BIT:
        dt = getattr(torch, dt_name)
        isz = dt.itemsize
        ab = a.to(dt)
        tag = f"[{n}, {n}] {dt_name}, D={bp.d}"
        if dt == torch.bfloat16:
            xb = x.to(dt)
            y_k, y_p = mxv(ab, xb), mxv(ab, xb, mode="ref")
            terms = ab.float().abs() @ xb.float().abs()
            limit = _dot_limit(terms, y_p.float(), n) + 2.0 ** -8 * (
                y_p.float().abs())
            measure("mxv", lambda a_, x_: mxv(a_, x_),
                    lambda a_, x_: mxv(a_, x_, mode="ref"),
                    lambda a_, x_: torch.mv(a_, x_),
                    lambda: ((torch.randn(n, n, generator=gen, device="cuda")
                              .to(dt), vec().to(dt)) if n < 8192
                             else (ab, xb)),
                    n * n * isz + 2 * n * isz, 2.0 * n * n, y_k, y_p, limit,
                    {"lost segment": drop_rows(y_p, seg, seg),
                     "lost tile": drop_rows(y_p, seg, bm_row)},
                    f"A {tag} (outputs held)", entry=False, hold=True,
                    dtype=dt_name)
            del xb, y_k, y_p, terms, limit
        vs = [t.to(dt) for t in (u1, v1, u2, v2)]
        o_k = gemver_outer(ab, *vs)
        o_p = gemver_outer(ab, *vs, mode="ref")
        measure("gemver_outer", lambda *t: gemver_outer(*t),
                lambda *t: gemver_outer(*t, mode="ref"),
                lambda a_, u1_, v1_, u2_, v2_: torch.addr(
                    torch.addr(a_, u1_, v1_), u2_, v2_),
                lambda: ((torch.randn(n, n, generator=gen, device="cuda")
                          .to(dt), *(vec().to(dt) for _ in range(4)))
                         if n < 8192 else (ab, *vs)),
                2 * n * n * isz + 4 * n * isz, 4.0 * n * n, o_k, o_p,
                torch.zeros(o_p.shape, device=o_p.device),
                {"lost segment": drop_rows(o_p, seg, seg, n).reshape(n, n)},
                f"A {tag} (|d| = 0: controls as max|d|; outputs held)",
                entry=False, hold=True, dtype=dt_name)
        del ab, vs, o_k, o_p
        torch.cuda.empty_cache()


GEMVER_SUM_DTYPES = ("float32", "bfloat16", "float16")


def check_gemver_sum(card: str, vec, sms: int) -> None:
    """gemver_sum's launch (blocks, chunks, blocks an SM, waves,
    registers) at vn in f32, bf16 and f16, then each type at vn and at vn
    + 77 (a padded tiling) held to |d| = 0 against its plain version with
    a lost-segment and a lost-last-vector control; the 16-bit types at vn
    timed beside the bound and ``x + z``.  ``vec(n)`` draws an f32 [n] on
    the card."""
    import torch
    from repro_torch.codegen import block_1d, plan_blocks
    from repro_torch.kernels.gemver import gemver_sum
    from repro_torch.kernels.gemver import kernel as gk
    from repro_torch.kernels.gemver import specs as gspecs
    from repro_torch.kernels.gemver.ops import _DEFAULT as G_DEFAULT
    vn = GEMVER_SUM_N
    for dt_name in GEMVER_SUM_DTYPES:
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        for n in (vn, vn + 77):
            x, z = vec(n).to(dt), vec(n).to(dt)
            spec2, _ = block_1d(gspecs.gemver_sum_spec(x, z), G_DEFAULT)
            bp = plan_blocks(spec2, G_DEFAULT)
            g = gk.sum_geometry(bp, isz)
            if n == vn:
                per_sm = gk.sum_occupancy(dt, g.threads)
                print(f"gemver_sum x, z [{n}] {dt_name} launch: D={bp.d}, "
                      f"{g.blocks} blocks of {g.threads} threads ({g.steps} "
                      f"steps of {g.units} x {gk.SUM_UNIT} 16-byte vectors "
                      f"of {g.vec} elements of each of {bp.d} segments of "
                      f"{g.segv} vectors, {bp.d} blocks a step), {per_sm} "
                      f"blocks an SM, {g.blocks / (per_sm * sms):.2f} waves; "
                      f"ptxas gemver_sum [registers, spill bytes]: "
                      f"{_regs(f'gemver_sum<{_CTYPES[dt_name]}>')} [{card}]")
            got, ref = gemver_sum(x, z), gemver_sum(x, z, mode="ref")
            seg = bp.rows // bp.d * bp.cols
            lost_seg = ref.clone()
            lost_seg[seg:min(2 * seg, n)] = 0
            lost_vec = ref.clone()
            last = lost_vec[(n - 1) // g.vec * g.vec:]
            last.copy_(torch.where(last == 0, -1.0, 0.0).to(dt))
            err, ctl = _hold(f"gemver_sum [{n}] {dt_name}", got, ref, 0.0,
                             {"lost segment": lost_seg,
                              "lost last vector": lost_vec})
            line = (f"gemver_sum x, z [{n}] {dt_name}: max_abs_err={err:g} "
                    f"(|d| = 0); controls {ctl}")
            if n == vn and dt != torch.float32:
                sets = _copies(lambda: (vec(n).to(dt), vec(n).to(dt)),
                               3 * n * isz)
                bms, by = bound_ms(3 * n * isz, float(n), dt_name)
                ms = device_ms(gemver_sum, sets, hold=True)
                plain = device_ms(lambda a, b: gemver_sum(a, b, mode="ref"),
                                  sets, hold=True)
                lib = device_ms(lambda a, b: a + b, sets, hold=True)
                line += (f"; ms={ms:.5f} plain_ms={plain:.5f} bound_ms="
                         f"{bms:.6f} ({by}) library_ms={lib:.5f} (x + z; "
                         f"every call's output held)")
                del sets
            print(f"{line} [{card}]")
            del x, z, got, ref, lost_seg, lost_vec, last


# the C++ element type of each dtype, as ptxas_instances names instances
_CTYPES = {"float32": "float", "bfloat16": "__nv_bfloat16",
           "float16": "__half"}


SOURCES = {
    "mxv": ("src/repro_torch/csrc/reduction.cu",
            "src/repro/codegen/emit.py:491"),
    "mxv_t": ("src/repro_torch/csrc/stream_reduction.cu",
              "src/repro/codegen/emit.py:564 (its merge of the D streams' "
              "partial rows folded into the same launch: a cluster's "
              "distributed shared memory)"),
    "gemver_outer": ("src/repro_torch/csrc/gemver.cu",
                     "src/repro/codegen/emit.py:410"),
    "gemver_sum": ("src/repro_torch/csrc/gemver.cu",
                   "src/repro/codegen/emit.py:410"),
}


STREAM_SHAPE = (8192, 4096)        # the registry's bench size (_BENCH)
STREAM_ALPHA, STREAM_FILL = 1.5, 3.5
STREAM_LOOKAHEADS = (1, 3, 4)       # the K4 ring (2 is the K1 kernels)
GEMVER_SUM_LOOKAHEADS = (1, 3)
STREAM_DTYPES = ("float32", "bfloat16")


def phase_stream(card: str, results: dict) -> None:
    """The paper's stream micro-kernels (read, copy, init, triad) at the
    registry's bench size, in f32 and bf16, through their public
    functions: the K1 and K2 kernels at the default config and the K4
    ring at lookahead 1, 3 and 4 (copy, triad, fill), with gemver_sum's
    ring at lookahead 1 and 3.  Then each kernel against its plain
    version with lost-stream controls, timed, and the D and lookahead
    sweeps (lines only).

    Every count is set to 0 just before the op calls and read just
    after; the JSON line's launches are those counts."""
    import torch
    from repro_torch.codegen import block_1d, plan_blocks, run_spec
    from repro_torch.kernels import cuda, manual
    from repro_torch.kernels.gemver import gemver_sum
    from repro_torch.kernels.gemver import specs as gs
    from repro_torch.kernels.stream import (stream_copy, stream_copy_manual,
                                            stream_init, stream_read)
    from repro_torch.kernels.stream import kernel as sk
    from repro_torch.kernels.stream import specs as ss
    from repro_torch.kernels.stream.ops import _DEFAULT
    t_phase = time.perf_counter()
    rows, cols = STREAM_SHAPE
    d = _DEFAULT.stride_unroll
    seg = rows // d
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smem_limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    gen = torch.Generator(device="cuda").manual_seed(13)
    cfgs = {la: _DEFAULT.replace(lookahead=la) for la in STREAM_LOOKAHEADS}
    vn = GEMVER_SUM_N
    print(f"stream: tolerances: copy, init, triad and every K4 body |d| = 0 "
          f"(each operation rounded as the body rounds it); stream_read "
          f"|d| <= 2 c 2^-24 sum|x| + 2^-23 |ref| over each stream's n = "
          f"seg*cols = {seg * cols} terms, c = min(n, {LAMBDA:g} sqrt n) "
          f"(as the dot products above), on x = 1 + N(0, 1) so that a lost "
          f"stream or chunk moves a sum by more than the limit; its pass 1 "
          f"alone, chunk by chunk, under the same limit with n = the "
          f"chunk's spc*128 terms. Controls, the plain version with stream "
          f"k=1 dropped and with one step of it dropped (a K4 tile, or a "
          f"chunk of the read's pass 1: the first, and in pass 1 the "
          f"ragged last), must land above each limit [{card}]")

    def rand(shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    names = ["stream_read", "stream_read_merge", "stream_copy", "stream_init",
             "stream_triad", "manual_ring_copy", "manual_ring_triad",
             "manual_ring_fill", "manual_ring_gemver_sum"]
    want = {"stream_read": 1, "stream_read_merge": 1, "stream_copy": 1,
            "stream_init": 1, "stream_triad": 1,
            "manual_ring_copy": len(STREAM_LOOKAHEADS),
            "manual_ring_triad": len(STREAM_LOOKAHEADS),
            "manual_ring_fill": len(STREAM_LOOKAHEADS),
            "manual_ring_gemver_sum": len(GEMVER_SUM_LOOKAHEADS)}
    want = {n: len(STREAM_DTYPES) * c for n, c in want.items()}
    inputs, outs = {}, {}
    for dt_name in STREAM_DTYPES:
        dt = getattr(torch, dt_name)
        # the read's input has mean 1: the sum of a stream of mean-zero
        # values (about sqrt n) lies below the f32 rounding limit (about
        # 2^-24 n^1.5), so a lost stream or chunk could not be seen
        inputs[dt_name] = dict(x=rand(STREAM_SHAPE, dt), b=rand(STREAM_SHAPE, dt),
                               c=rand(STREAM_SHAPE, dt), v=rand((vn,), dt),
                               z=rand((vn,), dt),
                               r=(1 + rand(STREAM_SHAPE, torch.float32)).to(dt))
    for k in cuda.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    for dt_name in STREAM_DTYPES:               # the slice's main path
        dt = getattr(torch, dt_name)
        i = inputs[dt_name]
        o = {"read": stream_read(i["r"]), "copy": stream_copy(i["x"]),
             "init": stream_init(STREAM_SHAPE, STREAM_FILL, dt),
             "triad": run_spec(ss.triad_spec, (i["b"], i["c"], STREAM_ALPHA),
                               _DEFAULT)}
        for la, cfg in cfgs.items():
            o[f"copy_la{la}"] = stream_copy_manual(i["x"], config=cfg)
            o[f"triad_la{la}"] = run_spec(
                ss.triad_spec, (i["b"], i["c"], STREAM_ALPHA), cfg)
            o[f"init_la{la}"] = stream_init(STREAM_SHAPE, STREAM_FILL, dt,
                                            config=cfg)
        for la in GEMVER_SUM_LOOKAHEADS:
            o[f"gemver_sum_la{la}"] = gemver_sum(
                i["v"], i["z"], config=_DEFAULT.replace(lookahead=la))
        outs[dt_name] = o
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: cuda.KERNELS[n].launches for n in names}
    if counts != want:
        raise AssertionError(f"stream: launches {counts}, expected {want}")
    others = {n: k.launches for n, k in cuda.KERNELS.items()
              if n not in names and k.launches}
    if others:
        raise AssertionError(f"stream: other kernels launched: {others}")
    print(f"stream: main path ({', '.join(STREAM_DTYPES)}: read, copy, init, "
          f"triad at D={d}, P={_DEFAULT.portion_unroll}; the K4 ring at "
          f"lookahead {list(STREAM_LOOKAHEADS)}; gemver_sum at lookahead "
          f"{list(GEMVER_SUM_LOOKAHEADS)}, vn={vn}) {wall:.3f} s host wall, "
          f"launches {json.dumps(counts)} [{card}]")
    # each K1 launch's geometry: blocks, blocks an SM, waves, registers
    bp_k1 = plan_blocks(ss.copy_spec(inputs["float32"]["x"]), _DEFAULT)
    g = sk.k1_geometry(bp_k1)
    for dt_name in STREAM_DTYPES:
        dt = getattr(torch, dt_name)
        for name in ("stream_copy", "stream_triad", "stream_init"):
            per_sm = sk.k1_occupancy(name, dt, g.threads)
            inst = (f"{name}<float>" if dt == torch.float32
                    else f"{name}<__nv_bfloat16>")
            print(f"{name} {dt_name} launch: D={d}, bm={bp_k1.bm}, "
                  f"{g.blocks} blocks of {g.threads} threads, {g.streams} "
                  f"streams of a step in registers ({g.groups} group"
                  f"{'s' if g.groups > 1 else ''}), {per_sm} blocks an SM, "
                  f"{g.blocks / (per_sm * sms):.2f} waves; ptxas {inst} "
                  f"[registers, spill bytes]: {_regs(inst)} [{card}]")

    def lost(t, first_row, n_rows, col0=0, ncols=None):
        """The plain output with rows first_row ... first_row+n_rows-1 (of
        columns col0 ... col0+ncols-1) zeroed, or set to -1 where they
        are 0 already (a fill)."""
        t = t.clone()
        view = t.view(-1, t.shape[-1]) if t.ndim > 1 else t.view(1, -1)
        cut = view[first_row:first_row + n_rows,
                   col0:col0 + (ncols or view.shape[1])]
        cut.copy_(torch.where(cut == 0, -1.0, 0.0).to(t.dtype))
        return t

    def report(name, shape, err, ctl, ms, plain_ms, nbytes, flops, lib_ms,
               lib_name, entry: bool):
        bms, by = bound_ms(nbytes, flops, dt_name)   # the loop's dtype
        print(f"{name} {shape}: max_abs_err={err:g}; controls {ctl}; "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms={bms:.6f} "
              f"({by}) library_ms="
              + ("none" if lib_ms is None else f"{lib_ms:.5f} ({lib_name})")
              + f" [{card}]")
        if entry:
            results[name] = dict(
                name=name, route="cuda", source=STREAM_SOURCES[name][0],
                replaces=STREAM_SOURCES[name][1], launches=counts[name],
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, max_abs_err=err, shape=shape)

    n = rows * cols
    for dt_name in STREAM_DTYPES:
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        i, o = inputs[dt_name], outs[dt_name]
        entry = dt_name == "float32"
        tag = f"[{rows}, {cols}] {dt_name}"
        x, b, c = i["x"], i["b"], i["c"]

        def sets(k):
            return _copies(lambda: tuple(rand(STREAM_SHAPE, dt)
                                         for _ in range(k)), k * n * isz)

        # K2: the read, both passes, then the merge alone
        r = i["r"]
        ref = stream_read(r, mode="ref")
        x2 = r.reshape(d, -1)
        bp = plan_blocks(ss.read_spec(x2), _DEFAULT)
        spc, chunks = sk.read_chunks(bp, sms)
        drop = x2.clone()
        drop[1] = 0
        drop_chunk = x2.clone()
        drop_chunk[1, :spc * 128] = 0
        terms = r.float().abs().reshape(d, -1).sum(1)
        limit = _dot_limit(terms, ref, seg * cols)
        err, ctl = _hold(f"stream_read {dt_name}", o["read"], ref, limit,
                        {"lost stream": stream_read(drop.reshape(r.shape),
                                                    mode="ref"),
                         "lost chunk": stream_read(drop_chunk.reshape(r.shape),
                                                   mode="ref")})
        ctl += (f"; limit {float(limit.min()):.4g}-{float(limit.max()):.4g} "
                f"(x = 1 + N(0, 1))")
        # pass 1 alone against its plain version at the same chunking: a
        # chunk sums at most spc*128 terms of a stream, so its limit is
        # tight enough to see one chunk lost, the ragged last one included
        spec_r = ss.read_spec(x2)
        part = sk.read_split(spec_r, bp, x2, _DEFAULT)
        part_ref = sk.read_split_plain(spec_r, bp, x2, spc, chunks)
        w = spc * 128
        ax = x2.float().abs()
        pterms = torch.stack([ax[:, q * w:(q + 1) * w].sum(1)
                              for q in range(chunks)])
        del ax
        plimit = _dot_limit(pterms, part_ref, w)
        last = x2.shape[1] // 128 - (chunks - 1) * spc
        lost_s, lost_last = part_ref.clone(), part_ref.clone()
        lost_s[:, 1] = 0
        lost_last[-1, 1] = 0
        err_p, ctl_p = _hold(
            f"stream_read pass 1 {dt_name}", part, part_ref, plimit,
            {"lost stream": lost_s,
             f"lost last chunk ({last} of {spc} sub-portions)": lost_last})
        ctl += (f"; pass 1 vs its plain version at {chunks} chunks of "
                f"{spc} sub-portions: max|d|={err_p:.4g}, limit "
                f"{float(plimit.min()):.4g}-{float(plimit.max()):.4g}, "
                f"controls {ctl_p}")
        del lost_s, lost_last, part_ref
        s1 = sets(1)
        report("stream_read", f"x {tag}, D={d}, {chunks} chunks, both passes",
               err, ctl, device_ms(lambda a: stream_read(a), s1),
               device_ms(lambda a: stream_read(a, mode="ref"), s1),
               n * isz + d * 4, float(n), device_ms(
                   lambda a: a.view(d, -1).sum(1, dtype=torch.float32), s1),
               "x.view(D, -1).sum(1, dtype=float32)", entry)
        m_k, m_p = sk.read_merge(part), sk.read_merge_plain(part)
        lost_part = part.clone()
        lost_part[:, 1] = 0
        err_m, ctl_m = _hold(f"stream_read_merge {dt_name}", m_k, m_p,
                            chunks * GAMMA * part.abs().sum(0),
                            {"lost stream": sk.read_merge_plain(lost_part)})
        psets = [(part.clone(),) for _ in range(64)]
        report("stream_read_merge", f"partials [{chunks}, {d}] f32",
               err_m, ctl_m, device_ms(lambda p: sk.read_merge(p), psets),
               device_ms(lambda p: sk.read_merge_plain(p), psets),
               part.numel() * 4 + d * 4, float(part.numel()),
               device_ms(lambda p: p.sum(0), psets), "part.sum(0)", entry)
        del drop, drop_chunk, part, psets

        # K1: copy, init, triad
        ref = stream_copy(x, mode="ref")
        err, ctl = _hold(f"stream_copy {dt_name}", o["copy"], ref, 0.0,
                        {"lost stream": lost(ref, seg, seg)})
        report("stream_copy", f"x {tag}, D={d}, P={_DEFAULT.portion_unroll}",
               err, ctl, device_ms(lambda a: stream_copy(a), s1),
               device_ms(lambda a: stream_copy(a, mode="ref"), s1),
               2 * n * isz, 0.0, device_ms(lambda a: a.clone(), s1),
               "x.clone()", entry)
        ref = stream_init(STREAM_SHAPE, STREAM_FILL, dt, mode="ref")
        err, ctl = _hold(f"stream_init {dt_name}", o["init"], ref, 0.0,
                        {"lost stream": lost(ref, seg, seg)})
        report("stream_init", f"y {tag}, D={d}, P={_DEFAULT.portion_unroll}",
               err, ctl,
               device_ms(lambda: stream_init(STREAM_SHAPE, STREAM_FILL, dt),
                         [()]),
               device_ms(lambda: stream_init(STREAM_SHAPE, STREAM_FILL, dt,
                                             mode="ref"), [()]),
               n * isz, 0.0,
               device_ms(lambda: torch.full(STREAM_SHAPE, STREAM_FILL,
                                            dtype=dt, device="cuda"), [()]),
               "torch.full", entry)
        ref = run_spec(ss.triad_spec, (b, c, STREAM_ALPHA), _DEFAULT,
                       mode="ref")
        err, ctl = _hold(f"stream_triad {dt_name}", o["triad"], ref, 0.0,
                        {"lost stream": lost(ref, seg, seg)})
        s2 = sets(2)
        report("stream_triad", f"b, c {tag}, D={d}, "
               f"P={_DEFAULT.portion_unroll}, alpha={STREAM_ALPHA}", err, ctl,
               device_ms(lambda b_, c_: run_spec(
                   ss.triad_spec, (b_, c_, STREAM_ALPHA), _DEFAULT), s2),
               device_ms(lambda b_, c_: run_spec(
                   ss.triad_spec, (b_, c_, STREAM_ALPHA), _DEFAULT,
                   mode="ref"), s2),
               3 * n * isz, 2.0 * n,
               device_ms(lambda b_, c_: torch.add(b_, c_, alpha=STREAM_ALPHA),
                         s2), "torch.add(b, c, alpha)", entry)

        # K4: the ring's bodies at each lookahead
        bp = plan_blocks(ss.copy_spec(x), _DEFAULT)
        for la, cfg in cfgs.items():
            rings = {body: manual.ring_plan(name, dt, bp, cfg, sms)
                     for body, name in (("copy", "stream_copy"),
                                        ("triad", "stream_triad"),
                                        ("fill", "stream_init"))}
            for body, plan in rings.items():
                print(ring_line(f"manual_ring_{body} {dt_name} la={la}",
                                plan, sms, card))
            la_entry = entry and la == 3
            shape = (f"{tag}, D={d}, bm={bp.bm}, lookahead {la}; step tile "
                     + ", ".join(f"{k} {p.tw} columns" for k, p
                                 in rings.items()))

            def controls(ref, tw):
                return {"lost stream": lost(ref, seg, seg),
                        "lost tile": lost(ref, seg, bp.bm, 0, tw)}
            ref = stream_copy(x, mode="ref")
            err, ctl = _hold(f"manual_ring_copy {dt_name} la={la}",
                            o[f"copy_la{la}"], ref, 0.0,
                            controls(ref, rings["copy"].tw))
            report("manual_ring_copy", f"x {shape}", err, ctl,
                   device_ms(lambda a: stream_copy_manual(a, config=cfg), s1),
                   device_ms(lambda a: stream_copy_manual(a, config=cfg,
                                                          mode="ref"), s1),
                   2 * n * isz, 0.0, device_ms(lambda a: a.clone(), s1),
                   "x.clone()", la_entry)
            ref = run_spec(ss.triad_spec, (b, c, STREAM_ALPHA), cfg,
                           mode="ref")
            err, ctl = _hold(f"manual_ring_triad {dt_name} la={la}",
                            o[f"triad_la{la}"], ref, 0.0,
                            controls(ref, rings["triad"].tw))
            report("manual_ring_triad", f"b, c {shape}", err, ctl,
                   device_ms(lambda b_, c_: run_spec(
                       ss.triad_spec, (b_, c_, STREAM_ALPHA), cfg), s2),
                   device_ms(lambda b_, c_: run_spec(
                       ss.triad_spec, (b_, c_, STREAM_ALPHA), cfg,
                       mode="ref"), s2),
                   3 * n * isz, 2.0 * n,
                   device_ms(lambda b_, c_: torch.add(
                       b_, c_, alpha=STREAM_ALPHA), s2),
                   "torch.add(b, c, alpha)", la_entry)
            ref = stream_init(STREAM_SHAPE, STREAM_FILL, dt, mode="ref")
            err, ctl = _hold(f"manual_ring_fill {dt_name} la={la}",
                            o[f"init_la{la}"], ref, 0.0,
                            controls(ref, rings["fill"].tw))
            report("manual_ring_fill", f"y {shape}", err, ctl,
                   device_ms(lambda: stream_init(STREAM_SHAPE, STREAM_FILL,
                                                 dt, config=cfg), [()]),
                   device_ms(lambda: stream_init(STREAM_SHAPE, STREAM_FILL,
                                                 dt, config=cfg, mode="ref"),
                             [()]),
                   n * isz, 0.0,
                   device_ms(lambda: torch.full(STREAM_SHAPE, STREAM_FILL,
                                                dtype=dt, device="cuda"),
                             [()]), "torch.full", la_entry)
        cols_v = 128 * _DEFAULT.portion_unroll
        vrows = -(-vn // cols_v)
        for la in GEMVER_SUM_LOOKAHEADS:
            cfg = _DEFAULT.replace(lookahead=la)
            print(ring_line(f"manual_ring_gemver_sum {dt_name} la={la}",
                            manual.ring_plan("gemver_sum", dt, plan_blocks(
                                block_1d(gs.gemver_sum_spec(i["v"], i["z"]),
                                         cfg)[0], cfg), cfg, sms), sms, card))
            ref = gemver_sum(i["v"], i["z"], config=cfg, mode="ref")
            tile_rows = vrows // d
            err, ctl = _hold(f"manual_ring_gemver_sum {dt_name} la={la}",
                            o[f"gemver_sum_la{la}"], ref, 0.0,
                            {"lost stream": lost(ref.view(vrows, cols_v),
                                                 tile_rows,
                                                 tile_rows).view(-1)})
            vsets = _copies(lambda: (rand((vn,), dt), rand((vn,), dt)),
                            2 * vn * isz)
            report("manual_ring_gemver_sum",
                   f"x, z [{vn}] {dt_name} ({vrows} x {cols_v} tiles, D={d}, "
                   f"lookahead {la})", err, ctl,
                   device_ms(lambda a, z_: gemver_sum(a, z_, config=cfg),
                             vsets),
                   device_ms(lambda a, z_: gemver_sum(a, z_, config=cfg,
                                                      mode="ref"), vsets),
                   3 * vn * isz, float(vn),
                   device_ms(lambda a, z_: a + z_, vsets), "x + z",
                   entry and la == 3)
            del vsets
        del s1, s2, ref
        outs[dt_name] = None
        torch.cuda.empty_cache()

    # Fig. 2 on the card: copy, read and init against D (lines only), and
    # copy against lookahead at D = 4
    x = inputs["float32"]["x"]
    s1 = _copies(lambda: (rand(STREAM_SHAPE, torch.float32),), n * 4)
    for dd in (1, 2, 4, 8, 16):
        cfg = _DEFAULT.replace(stride_unroll=dd)
        t_copy = device_ms(lambda a: stream_copy(a, config=cfg), s1)
        t_read = device_ms(lambda a: stream_read(a, config=cfg), s1)
        t_init = device_ms(lambda: stream_init(STREAM_SHAPE, STREAM_FILL,
                                               config=cfg), [()])
        print(f"stream sweep D={dd} P={cfg.portion_unroll} [{rows}, {cols}] "
              f"f32: copy ms={t_copy:.5f} read ms={t_read:.5f} init "
              f"ms={t_init:.5f} (bounds 0.080, 0.040, 0.040) [{card}]")
    for la in (1, 2, 3, 4):
        cfg = _DEFAULT.replace(lookahead=la)
        t = device_ms(lambda a: stream_copy_manual(a, config=cfg), s1)
        print(f"stream sweep lookahead={la} D={cfg.stride_unroll} "
              f"P={cfg.portion_unroll} [{rows}, {cols}] f32: "
              f"stream_copy_manual ms={t:.5f} "
              f"({'K1' if la == 2 else 'K4'}) [{card}]")
    # the ring at one lookahead against the rows of a step (block_rows):
    # the same stage bytes in fewer, longer boxes
    for bm in (8, 4, 2, 1):
        cfg = _DEFAULT.replace(lookahead=3, block_rows=bm)
        bp = plan_blocks(ss.copy_spec(x), cfg)
        plan = manual.ring_plan("stream_copy", torch.float32, bp, cfg, sms)
        t = device_ms(lambda a: stream_copy_manual(a, config=cfg), s1)
        print(f"stream sweep K4 copy lookahead=3 D={d} bm={bp.bm} "
              f"[{rows}, {cols}] f32: step tile {plan.tw} columns, "
              f"{plan.copies} boxes of {plan.box_bytes[0]} B a step, "
              f"{plan.per_sm} blocks an SM: ms={t:.5f} [{card}]")
    # the ring against its tile at lookahead 1 and 3: one block an SM
    # with a wide stage, or a stage small enough for two (the chosen
    # tile marked *; fill, writes-only, takes the widest for one block)
    for dt_name in STREAM_DTYPES:
        dt = getattr(torch, dt_name)
        sx = _copies(lambda: (rand(STREAM_SHAPE, dt), rand(STREAM_SHAPE, dt)),
                     2 * n * dt.itemsize)
        for body, name in (("copy", "stream_copy"), ("triad", "stream_triad"),
                           ("fill", "stream_init")):
            for la in (1, 3):
                cfg = _DEFAULT.replace(lookahead=la)
                spec = (ss.triad_spec(sx[0][0], sx[0][1], STREAM_ALPHA)
                        if body == "triad" else ss.copy_spec(sx[0][0]))
                bp = plan_blocks(spec, cfg)
                chosen = manual.ring_plan(name, dt, bp, cfg, sms).tw
                for tw in (128, 256, 512, 1024):
                    try:
                        plan = manual.ring_plan(name, dt, bp, cfg, sms,
                                                tile=tw)
                    except ValueError:
                        continue
                    if plan.smem > smem_limit:
                        continue
                    if body == "copy":
                        def run(a, _b, _cfg=cfg, _bp=bp, _tw=tw):
                            return manual.emit(ss.copy_spec(a), _bp, [a], [],
                                               _cfg, tile=_tw)
                    elif body == "fill":
                        def run(a, _b, _cfg=cfg, _bp=bp, _tw=tw, _dt=dt):
                            return manual.emit(
                                ss.init_spec(STREAM_SHAPE, _dt, STREAM_FILL),
                                _bp, [], [STREAM_FILL], _cfg, device=a.device,
                                tile=_tw)
                    else:
                        def run(a, b, _cfg=cfg, _bp=bp, _tw=tw):
                            return manual.emit(
                                ss.triad_spec(a, b, STREAM_ALPHA), _bp,
                                [a, b], [STREAM_ALPHA], _cfg, tile=_tw)
                    t = device_ms(run, sx)
                    print(f"stream sweep K4 {body} tile lookahead={la} "
                          f"[{rows}, {cols}] {dt_name}: tile {tw}"
                          f"{'*' if tw == chosen else ''} columns, "
                          f"{plan.smem} B, {plan.per_sm} blocks an SM, "
                          f"{plan.blocks} blocks of {plan.per} steps: "
                          f"ms={t:.5f} [{card}]")
        # the read's pass 1 and merge against its chunks an SM
        r1 = _copies(lambda: ((1 + rand(STREAM_SHAPE, torch.float32))
                              .to(dt),), n * dt.itemsize)
        x2s = [(a.reshape(d, -1),) for (a,) in r1]
        bp = plan_blocks(ss.read_spec(x2s[0][0]), _DEFAULT)
        for per_sm in (1, 2, 3, 4):
            spc, chunks = sk.read_chunks(bp, sms, per_sm)
            t = device_ms(lambda a, _k=per_sm: sk.read_merge(sk.read_split(
                ss.read_spec(a), bp, a, _DEFAULT, _k)), x2s)
            print(f"stream sweep read {dt_name} [{rows}, {cols}] D={d}: "
                  f"{per_sm} chunks an SM ({chunks} of {spc} sub-portions"
                  f"{', the default' if per_sm == sk.READ_BLOCKS_PER_SM else ''}"
                  f"), both passes ms={t:.5f} [{card}]")
        del sx, r1, x2s
    del s1, inputs, outs
    torch.cuda.empty_cache()
    print(f"stream: phase took {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")


STREAM_SOURCES = {
    "stream_read": ("src/repro_torch/csrc/stream.cu",
                    "src/repro/codegen/emit.py:491"),
    "stream_read_merge": ("src/repro_torch/csrc/stream.cu",
                          "src/repro/codegen/emit.py:491"),
    "stream_copy": ("src/repro_torch/csrc/stream.cu",
                    "src/repro/codegen/emit.py:410"),
    "stream_init": ("src/repro_torch/csrc/stream.cu",
                    "src/repro/codegen/emit.py:410"),
    "stream_triad": ("src/repro_torch/csrc/stream.cu",
                     "src/repro/codegen/emit.py:410"),
    "manual_ring_copy": ("src/repro_torch/csrc/manual_ring.cu",
                         "src/repro/codegen/emit.py:708"),
    "manual_ring_triad": ("src/repro_torch/csrc/manual_ring.cu",
                          "src/repro/codegen/emit.py:708"),
    "manual_ring_fill": ("src/repro_torch/csrc/manual_ring.cu",
                         "src/repro/codegen/emit.py:708"),
    "manual_ring_gemver_sum": ("src/repro_torch/csrc/manual_ring.cu",
                               "src/repro/codegen/emit.py:708"),
}


STENCIL_SIZES = (2050, 16386)      # the registry's bench rows, and 1 GiB
# the stencils' cases, x [n, m] in a dtype: the bench size and 16386 x
# 16384 in f32 and bf16, and at 2047 columns (an output row of 2045: no
# whole 16-byte vectors, rows 2 bytes off 16-byte boundaries) in bf16
# and f16
STENCIL_CASES = tuple(((n, n - 2), dt) for dt in ("float32", "bfloat16")
                      for n in STENCIL_SIZES) + tuple(
    ((STENCIL_SIZES[0], STENCIL_SIZES[0] - 3), dt)
    for dt in ("bfloat16", "float16"))
DOITGEN_SIZES = ((16, 256, 256), (256, 256, 256))   # bench (r, q, s); p = s
# the 16-bit doitgen lines: on the tensor cores
DOITGEN_16BIT = (((16, 256, 256), "bfloat16"), ((256, 256, 256), "bfloat16"),
                 ((16, 256, 256), "float16"))
STENCIL_D_SWEEP = (1, 2, 4, 8)
STENCIL_SWEEP_DTYPES = ("float32", "bfloat16")


def phase_stencil(card: str, results: dict) -> None:
    """The paper's stencil and tensor kernels (jacobi2d, conv3x3, doitgen)
    through their public functions: the stencils at STENCIL_CASES (the
    registry's bench size 2050 x 2048 and 16386 x 16384 in f32 and bf16,
    2050 x 2047 in bf16 and f16), doitgen at its bench size (16, 256,
    256) x (256, 256) and at (256, 256, 256) x (256, 256), in f32, at
    both in bf16 and at the bench size in f16.  Then each kernel against
    its plain version with lost-stream, lost-tap and lost-tail-column
    (stencils) or lost-tile and lost-batch (doitgen) controls, timed
    beside its bound and one PyTorch call, and the D sweep at the larger
    sizes (the stencils and doitgen in f32 and bf16); the stencils' sweep
    again at 16386 x 16386 in f32, whose row pitch is not the 64 KiB of
    16386 x 16384.

    Every count is set to 0 just before the op calls and read just
    after; the JSON line's launches are those counts."""
    import torch
    import torch.nn.functional as F
    from repro_torch.codegen import plan_blocks, tap
    from repro_torch.core.striding import StridingConfig
    from repro_torch.kernels import cuda
    from repro_torch.kernels import stencil as st
    from repro_torch.kernels.conv3x3 import conv3x3
    from repro_torch.kernels.doitgen import doitgen
    from repro_torch.kernels.doitgen import kernel as dk
    from repro_torch.kernels.doitgen import specs as dspecs
    from repro_torch.kernels.doitgen.ops import _DEFAULT as D_DEFAULT
    from repro_torch.kernels.jacobi2d import jacobi2d
    from repro_torch.kernels.jacobi2d import specs as jspecs
    from repro_torch.kernels.jacobi2d.ops import _DEFAULT as J_DEFAULT
    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(14)
    halo = ((1, 1), (1, 1))
    print(f"stencil: tolerances: jacobi2d and conv3x3 |d| = 0 (the kernels "
          f"round each product and sum in f32 in the body's order, no fused "
          f"multiply-add, then once into the dtype); doitgen |d| <= 2 c "
          f"2^-24 sum_s |A C4| + 2u |ref| over its s terms, c = min(s, "
          f"{LAMBDA:g} sqrt s) (as the dot products above), u = 2^-24 in "
          f"f32, 2^-8 in bf16, 2^-11 in f16, against a plain f32 product "
          f"with TF32 off (bf16 and f16 on the tensor cores, f32 "
          f"accumulators). "
          f"Controls, the plain version with stream k=1's rows lost, one tap "
          f"row of stream 1 read one row too low, the last column of one "
          f"row lost (stencils), one p tile of "
          f"one block lost or one batch element lost (doitgen), must land "
          f"above each limit [{card}]")

    def rand(shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def stencil_plain(x, w=None, top=-1):
        """The stencil body with its top tap row read at row offset
        ``top`` (-1 is the body's own; 0 is the lost-tap fault)."""
        xf = x.float()
        if w is None:
            s_ = (((tap(xf, halo, 0, 0) + tap(xf, halo, 0, -1))
                   + tap(xf, halo, 0, 1)) + tap(xf, halo, top, 0)
                  + tap(xf, halo, 1, 0))
            return (0.2 * s_).to(x.dtype)
        acc = None
        for q in range(9):
            r, c = divmod(q, 3)
            term = w[r, c] * tap(xf, halo, top if r == 0 else r - 1, c - 1)
            acc = term if acc is None else acc + term
        return acc.to(x.dtype)

    def stream_fault(ref, seg, rows_of):
        """ref with stream 1's output rows (seg ... 2 seg - 1 of the row
        axis) replaced by ``rows_of``'s."""
        t = ref.clone()
        t[seg:2 * seg] = rows_of[seg:2 * seg]
        return t

    def lost_rows(ref, seg, dim=0):
        t = ref.clone()
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(seg, 2 * seg)
        cut = t[tuple(idx)]
        cut.copy_(torch.where(cut == 0, -1.0, 0.0).to(t.dtype))
        return t

    inputs, base = {}, {}
    for shape, dt_name in STENCIL_CASES:     # one f32 draw a shape
        if shape not in base:
            base[shape] = (rand(shape), rand((3, 3)))
        inputs[("stencil", shape, dt_name)] = tuple(
            t.to(getattr(torch, dt_name)) for t in base[shape])
    del base
    for shape in DOITGEN_SIZES:
        inputs[("doitgen", shape, "float32")] = (rand(shape),
                                                 rand((shape[2], shape[2])))
    for shape, dt_name in DOITGEN_16BIT:
        inputs[("doitgen", shape, dt_name)] = tuple(
            t.to(getattr(torch, dt_name))
            for t in inputs[("doitgen", shape, "float32")])

    names = ["jacobi2d", "conv3x3", "doitgen"]
    for k in cuda.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    outs = {}
    for key, args in inputs.items():            # the slice's main path
        if key[0] == "stencil":
            x, w = args
            outs[("jacobi2d",) + key[1:]] = jacobi2d(x)
            outs[("conv3x3",) + key[1:]] = conv3x3(x, w)
        else:
            outs[key] = doitgen(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: cuda.KERNELS[n].launches for n in names}
    want = {"jacobi2d": len(STENCIL_CASES), "conv3x3": len(STENCIL_CASES),
            "doitgen": len(DOITGEN_SIZES) + len(DOITGEN_16BIT)}
    if counts != want:
        raise AssertionError(f"stencil: launches {counts}, expected {want}")
    others = {n: k.launches for n, k in cuda.KERNELS.items()
              if n not in names and k.launches}
    if others:
        raise AssertionError(f"stencil: other kernels launched: {others}")
    print(f"stencil: main path (jacobi2d, conv3x3 at "
          f"{[f'{list(s)} {d}' for s, d in STENCIL_CASES]}, "
          f"D={J_DEFAULT.stride_unroll}; doitgen at "
          f"{[list(s) for s in DOITGEN_SIZES]} f32 and "
          f"{[f'{list(s)} {d}' for s, d in DOITGEN_16BIT]}, "
          f"D={D_DEFAULT.stride_unroll}) {wall:.3f} s host wall, launches "
          f"{json.dumps(counts)} [{card}]")

    def report(name, shape, dt_name, err, ctl, ms, plain_ms, nbytes, flops,
               lib_ms, lib_name, entry: bool):
        bms, by = bound_ms(nbytes, flops, dt_name)
        print(f"{name} {shape}: max_abs_err={err:g}; controls {ctl}; "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms={bms:.6f} "
              f"({by}) library_ms={lib_ms:.5f} ({lib_name}) [{card}]")
        if entry:
            results[name] = dict(
                name=name, route="cuda",
                source=("src/repro_torch/csrc/doitgen.cu" if name == "doitgen"
                        else "src/repro_torch/csrc/stencil.cu"),
                replaces="src/repro/codegen/emit.py:410",
                launches=counts[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                max_abs_err=err, shape=shape)

    def lost_tail(ref, row):
        """ref with the last column of one output row changed."""
        t = ref.clone()
        t[row, -1] = -1.0 if float(t[row, -1]) == 0 else 0.0
        return t

    cross = torch.tensor([[0.0, 0.2, 0.0], [0.2, 0.2, 0.2], [0.0, 0.2, 0.0]],
                         device="cuda")
    occ = {(dt, conv): st.occupancy(getattr(torch, dt), conv)
           for dt in ("float32", "bfloat16", "float16")
           for conv in (False, True)}
    for key, args in inputs.items():
        if key[0] != "stencil":
            continue
        _, (n, m), dt_name = key
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        x, w = args
        rows, cols = n - 2, m - 2
        seg = rows // J_DEFAULT.stride_unroll
        big = n == STENCIL_SIZES[-1]
        entry = big and dt_name == "float32"
        reps = 8 if big else 20
        # the plain version's and the library's times, the yardsticks:
        # one replay of the graph at the larger size (tens of ms a call);
        # at the smaller size each call's output is held (16 MB or less
        # would stay in L2 from one call to the next)
        yard = 1 if big else 5
        hold = not big
        nbytes = (n * m + rows * cols) * isz
        bp = plan_blocks(jspecs.jacobi_spec(x), J_DEFAULT)
        g = st.geometry(bp, isz, sms)
        per_sm = occ[(dt_name, False)]
        geo = (f"D={bp.d}, {g.d} streams x {g.tiles} column tiles of "
               f"{g.tile} x {g.runs} runs of {g.run} rows, {g.blocks} blocks "
               f"of {st.THREADS} threads, {per_sm} blocks an SM "
               f"({occ[(dt_name, True)]} conv3x3), "
               f"{g.blocks / (per_sm * sms):.2f} waves")
        cross_dt = cross.to(dt)
        sets = _copies(lambda: (rand((n, m), dt), w), n * m * isz)
        for name, op, ww, flops in (("jacobi2d", jacobi2d, None, 5.0),
                                    ("conv3x3", conv3x3, w, 17.0)):
            ref = stencil_plain(x, ww)
            got = outs[(name, (n, m), dt_name)]
            if not torch.equal(ref, op(x, ww, mode="ref") if ww is not None
                               else op(x, mode="ref")):
                raise AssertionError(f"{name}: the script's plain body "
                                     "differs from the op's")
            err, ctl = _hold(
                f"{name} {[n, m]} {dt_name}", got, ref, 0.0,
                {"lost stream": lost_rows(ref, seg),
                 "lost tap": stream_fault(ref, seg,
                                          stencil_plain(x, ww, top=0)),
                 "lost tail column": lost_tail(ref, seg + 1)})
            if ww is None:
                fn, plain = (lambda a, _w: jacobi2d(a),
                             lambda a, _w: jacobi2d(a, mode="ref"))
                lib = device_ms(lambda a, _w: F.conv2d(
                    a[None, None], cross_dt[None, None]), sets, reps=reps,
                    replays=yard, hold=hold)
                lib_name = "F.conv2d with the 5-point cross of 0.2"
            else:
                fn, plain = (lambda a, w_: conv3x3(a, w_),
                             lambda a, w_: conv3x3(a, w_, mode="ref"))
                lib = device_ms(lambda a, w_: F.conv2d(
                    a[None, None], w_[None, None]), sets, reps=reps,
                    replays=yard, hold=hold)
                lib_name = "F.conv2d"
            ms = device_ms(fn, sets, reps=reps, hold=hold)
            report(name, f"x [{n}, {m}] {dt_name}, {geo}", dt_name,
                   err, ctl, ms,
                   device_ms(plain, sets, reps=reps, replays=yard,
                             hold=hold), nbytes,
                   flops * rows * cols, lib, lib_name, entry)
            if ww is not None:      # the op's weight packing, timed alone
                w9 = [ww[r_, c_] for r_ in range(3) for c_ in range(3)]
                w_ms = device_ms(lambda: st.kernel_weights(w9, x.device),
                                 [()], reps=reps)
                print(f"conv3x3 [{n}, {m}] {dt_name}: the nine weights "
                      f"({ww.dtype}, a contiguous [3, 3]) packed alone "
                      f"ms={w_ms:.5f}, the op less them {ms - w_ms:.5f} "
                      f"[{card}]")
            del ref, got
        del sets
        torch.cuda.empty_cache()

    for key, args in inputs.items():
        if key[0] != "doitgen":
            continue
        _, shape, dt_name = key
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        a, c4 = args
        r, q, s = shape
        p = c4.shape[1]
        bp = plan_blocks(dspecs.doitgen_spec(a, c4), D_DEFAULT)
        geo = dk.geometry(bp, r, s, p, isz, (a.data_ptr(), c4.data_ptr(),
                                             outs[key].data_ptr()), sms)
        seg, rb, cols = q // bp.d, geo.rb, geo.cols
        u = {torch.float32: GAMMA, torch.bfloat16: 2.0 ** -8,
             torch.float16: 2.0 ** -11}[dt]
        ref = doitgen(a, c4, mode="ref")
        terms = torch.einsum("rqs,sp->rqp", a.float().abs(), c4.float().abs())
        limit = 2 * _dot_factor(s) * GAMMA * terms + 2 * u * ref.float().abs()
        del terms
        lost_tile = ref.clone()
        lost_tile[0, seg:seg + rb, :cols] = 0
        lost_batch = ref.clone()
        lost_batch[r - 1] = 0
        err, ctl = _hold(f"doitgen {shape} {dt_name}", outs[key], ref, limit,
                         {"lost stream": lost_rows(ref, seg, dim=1),
                          f"lost tile ({rb} rows x {cols} columns)":
                              lost_tile,
                          "lost batch element": lost_batch})
        ctl += f"; max(limit)={float(limit.max()):.4g}"
        del lost_tile, lost_batch, limit, ref
        sets = _copies(lambda: (rand(shape, dt), c4), r * q * s * isz)
        reps = 8 if shape == DOITGEN_SIZES[-1] else 20
        report("doitgen", f"A {list(shape)} x C4 [{s}, {p}] {dt_name}, "
               f"D={bp.d}, bm={bp.bm}, {geo.blocks} blocks of {bp.d} x {rb} "
               f"rows x {cols} columns (tile {geo.tile}), "
               f"{'16-byte' if geo.vec else 'staging'} instance"
               + (", mma.sync" if dt != torch.float32 else ", FFMA"),
               dt_name, err, ctl,
               device_ms(lambda a_, c_: doitgen(a_, c_), sets, reps=reps),
               device_ms(lambda a_, c_: doitgen(a_, c_, mode="ref"), sets,
                         reps=reps),
               (r * q * s + s * p + r * q * p) * isz, 2.0 * r * q * s * p,
               device_ms(lambda a_, c_: torch.matmul(a_.view(-1, s), c_),
                         sets, reps=reps),
               "torch.matmul(A.view(-1, s), C4)",
               shape == DOITGEN_SIZES[-1] and dt_name == "float32")
        del sets
        torch.cuda.empty_cache()

    # D at the larger sizes (lines only): the paper's claim for stencils
    n = STENCIL_SIZES[-1]
    a, c4 = inputs[("doitgen", DOITGEN_SIZES[-1], "float32")]
    a16, c16 = inputs[("doitgen", DOITGEN_SIZES[-1], "bfloat16")]
    r, q, s = DOITGEN_SIZES[-1]
    b_dg = bound_ms((2 * r * q * s + s * s) * 4, 2.0 * r * q * s * s)[0]
    b_16 = bound_ms((2 * r * q * s + s * s) * 2, 2.0 * r * q * s * s,
                    "bfloat16")[0]
    for dd in STENCIL_D_SWEEP:
        cfg = StridingConfig(dd, 1)
        line = []
        for dt_name in STENCIL_SWEEP_DTYPES:
            x, w = inputs[("stencil", (n, n - 2), dt_name)]
            isz = x.element_size()
            b_st = bound_ms((n * (n - 2) + (n - 2) * (n - 4)) * isz, 0.0)[0]
            tj = device_ms(lambda x_: jacobi2d(x_, config=cfg), [(x,)],
                           reps=8)
            tc = device_ms(lambda x_: conv3x3(x_, w, config=cfg), [(x,)],
                           reps=8)
            line.append(f"{dt_name} ms={tj:.5f}, {tc:.5f} (bound "
                        f"{b_st:.4f})")
        td = device_ms(lambda a_: doitgen(a_, c4, config=cfg), [(a,)], reps=8)
        t16 = device_ms(lambda a_: doitgen(a_, c16, config=cfg), [(a16,)],
                        reps=8)
        print(f"stencil sweep D={dd}: jacobi2d, conv3x3 [{n}, {n - 2}] "
              f"{'; '.join(line)}; doitgen "
              f"{list(DOITGEN_SIZES[-1])} f32 ms={td:.5f} (bound "
              f"{b_dg:.4f}), bf16 ms={t16:.5f} (bound {b_16:.4f}) [{card}]")
    # the same stencils at a row pitch of n elements, not a power of two
    w = inputs[("stencil", (n, n - 2), "float32")][1]
    del inputs, outs, x, a, a16
    torch.cuda.empty_cache()
    x = rand((n, n))
    b_px = bound_ms((n * n + (n - 2) * (n - 2)) * 4, 0.0)[0]
    for dd in STENCIL_D_SWEEP:
        cfg = StridingConfig(dd, 1)
        tj = device_ms(lambda x_: jacobi2d(x_, config=cfg), [(x,)], reps=8)
        tc = device_ms(lambda x_: conv3x3(x_, w, config=cfg), [(x,)], reps=8)
        print(f"stencil sweep pitch D={dd}: jacobi2d, conv3x3 [{n}, {n}] "
              f"f32 ms={tj:.5f}, {tc:.5f} (bound {b_px:.4f}) [{card}]")
    del x
    torch.cuda.empty_cache()
    print(f"stencil: phase took {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")


ADAMW_SHAPES = {"bench": (4096, 1024), "embed": (64000, 4096)}  # f32
ADAMW_LOOKAHEADS = (1, 3, 4)        # the K4 ring (2 is the K1 kernel)
ADAMW_FLOPS = 15                    # per element: 13 arithmetic, sqrt, div
TRAIN_ARGS = ["--arch", "yi-9b", "--no-reduced", "--layers", "8",
              "--seq", "4096", "--batch", "2", "--steps", "50",
              "--device", "cuda"]
TRAIN_STEPS = 6


def eager_ms(fn, args, reps: int = 3) -> float:
    """Device time of one ``fn(*args)`` call for a call long enough that
    launch overhead is noise (tens of ms): one warm call, then ``reps``
    between CUDA events, without a graph (a graph would hold every
    call's gigabyte outputs at once)."""
    import torch
    fn(*args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn(*args)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def check_adamw(card: str, results: dict) -> None:
    """Both adamw kernels through the public op ``adamw_update`` at the
    registry's bench size (4096 x 1024 f32, re-blocked [8192, 512],
    117 MB of operands, past L2) and at Yi-9B's embedding [64000, 4096]
    f32 ([512000, 512]): the K1 kernel at the default config (D=2, P=2)
    and the K4 ring's adamw body at lookahead 1, 3, 4 (D=2).  The counts
    are set to 0 just before these calls and read just after.  Each
    output is held against the plain version (the body at the native
    shape) for equality: the kernels round every operation as the body
    does.  Control: the plain outputs with stream 1's rows of the
    blocking left at their inputs (a lost stream) must differ.  Then
    times: kernel, plain, torch._fused_adamw_ (the library yardstick,
    timed only) and the bound, 28 bytes an element at the memory rate."""
    import torch
    from repro_torch.codegen import plan_blocks
    from repro_torch.kernels import cuda, manual
    from repro_torch.kernels.adamw import _HYPER
    from repro_torch.kernels.adamw import kernel as akernel
    from repro_torch.kernels.adamw import ops as aops
    from repro_torch.kernels.adamw import specs as aspecs
    gen = torch.Generator(device="cuda").manual_seed(15)
    cfgs = {"k1": aops._DEFAULT}
    cfgs.update({f"ring_la{la}": aops._DEFAULT.replace(lookahead=la)
                 for la in ADAMW_LOOKAHEADS})
    print(f"adamw: tolerance |d| = 0 for p', m', v' (each operation rounded "
          f"as the body rounds it); control: stream 1's rows of the "
          f"[rows, 512] blocking left at their inputs must differ; configs "
          f"{ {k: (c.stride_unroll, c.portion_unroll, c.lookahead) for k, c in cfgs.items()} } "
          f"(D, P, lookahead) [{card}]")

    def make(shape):
        p, g, m = (torch.randn(*shape, generator=gen, device="cuda")
                   for _ in range(3))
        v = torch.rand(*shape, generator=gen, device="cuda")
        return p, g, m, v

    names = ("adamw_update", "manual_ring_adamw")
    inputs = {k: make(s) for k, s in ADAMW_SHAPES.items()}
    for k in cuda.KERNELS.values():
        k.launches = 0
    outs = {(size, c): aops.adamw_update(*inputs[size], config=cfg, **_HYPER)
            for size in ADAMW_SHAPES for c, cfg in cfgs.items()}
    torch.cuda.synchronize()
    counts = {n: cuda.KERNELS[n].launches for n in names}
    want = {"adamw_update": len(ADAMW_SHAPES),
            "manual_ring_adamw": len(ADAMW_SHAPES) * len(ADAMW_LOOKAHEADS)}
    others = {n: k.launches for n, k in cuda.KERNELS.items()
              if n not in names and k.launches}
    if counts != want or others:
        raise AssertionError(f"adamw: launches {counts} (others {others}),"
                             f" expected {want}")
    print(f"adamw: main path launches {json.dumps(counts)} [{card}]")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for size, shape in ADAMW_SHAPES.items():
        brows, bcols = aops._blocking(shape[0] * shape[1])
        spec = aspecs.adamw_spec(torch.empty(brows, bcols, device="meta"),
                                 None, None, None)
        for la in ADAMW_LOOKAHEADS:
            cfg = cfgs[f"ring_la{la}"]
            print(ring_line(f"manual_ring_adamw {size} [{brows}, {bcols}] "
                            f"f32 la={la}", manual.ring_plan(
                                "adamw_update", torch.float32,
                                plan_blocks(spec, cfg), cfg, sms), sms, card))
    for size, shape in ADAMW_SHAPES.items():
        p, g, m, v = inputs[size]
        n = p.numel()
        ref = aops.adamw_update(p, g, m, v, mode="ref", **_HYPER)
        rows, cols = aops._blocking(n)
        seg = rows // 2

        def lost(out, inp):
            t = out.clone().view(rows, cols)
            t[seg:2 * seg] = inp.view(rows, cols)[seg:2 * seg]
            return t.view(shape)
        errs = {}
        for c in cfgs:
            err, ctl = 0.0, []
            for name, got, want_, inp in zip(("p'", "m'", "v'"),
                                             outs[(size, c)], ref, (p, m, v)):
                e, line = _hold(f"adamw {c} {size} {name}", got, want_, 0.0,
                                {"lost stream": lost(want_, inp)})
                err = max(err, e)
                ctl.append(f"{name} {line}")
            errs[c] = err
            print(f"adamw {c} {list(shape)} f32: max_abs_err={err:g}; "
                  f"controls {'; '.join(ctl)} [{card}]")
        nbytes, flops = 28 * n, ADAMW_FLOPS * n
        bms, by = bound_ms(nbytes, flops, "float32")
        step = torch.ones((), device="cuda")
        # the scalars as adamw_step passes them: 0-d views of one f32 [7]
        # on the card, which the wrapper packs with one stack
        s7 = torch.stack(aops.scalars(torch.device("cuda"),
                                      *_HYPER.values())).unbind()

        def library(p, g, m, v):
            torch._fused_adamw_([p], [g], [m], [v], [], [step],
                                lr=_HYPER["lr"], beta1=0.9, beta2=0.999,
                                weight_decay=_HYPER["wd"], eps=_HYPER["eps"],
                                amsgrad=False, maximize=False)
        if size == "bench":
            sets = _copies(lambda: make(shape), 16 * n)
            time_of = lambda fn: device_ms(fn, sets)          # noqa: E731
            lib_sets = [tuple(t.clone() for t in s) for s in sets]
            lib = device_ms(library, lib_sets)
        else:
            time_of = lambda fn: eager_ms(fn, inputs[size])   # noqa: E731
            lib = eager_ms(library, tuple(t.clone() for t in inputs[size]))
        plain = time_of(lambda *a: aops.adamw_update(*a, *s7, mode="ref"))
        if size == "bench":
            pack = device_ms(lambda: cuda.f32_scalars(s7, p.device), [()])
            print(f"adamw scalars packed alone (one stack of seven 0-d "
                  f"tensors): {pack:.5f} ms [{card}]")
        for c, cfg in cfgs.items():
            ms = time_of(lambda *a, _cfg=cfg: aops.adamw_update(
                *a, *s7, config=_cfg))
            print(f"adamw {c} {list(shape)} f32: ms={ms:.5f} "
                  f"plain_ms={plain:.5f} bound_ms={bms:.6f} ({by}) "
                  f"library_ms={lib:.5f} (torch._fused_adamw_) "
                  f"achieved {nbytes / ms / 1e6:.0f} GB/s [{card}]")
            key = {"k1": "adamw_update",
                   "ring_la3": "manual_ring_adamw"}.get(c)
            if key and size == "embed":
                results[key] = dict(
                    name=key, route="cuda",
                    source=("src/repro_torch/csrc/adamw.cu" if c == "k1"
                            else "src/repro_torch/csrc/manual_ring.cu"),
                    replaces=("src/repro/codegen/emit.py:410" if c == "k1"
                              else "src/repro/codegen/emit.py:708"),
                    launches=counts[key], ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib,
                    max_abs_err=errs[c],
                    shape=f"p, g, m, v [{shape[0]}, {shape[1]}] f32 "
                          f"(D=2, P=2, lookahead {cfg.lookahead})")
    del inputs, outs
    torch.cuda.empty_cache()


K4_LOOKAHEADS = (1, 3, 4)


def check_k4_features(card: str, results: dict) -> None:
    """The K4 ring's rank-1 side write and its mixed operand dtypes.
    ``t_rowstat`` (the map ``o = 2 x`` next to the row statistic ``r =
    sum_j f32(x)``, the spec of the JAX package's K4 test) at the stream
    phase's [8192, 4096], x f32 and bf16, D=2 and one row a step (whole
    rows: a 16 KiB row piece a stream), and ``adamw_update`` with bf16 p
    and g and f32 m and v at the registry's bench size (blocked [8192,
    512], D=2, P=2), each at lookahead 1, 3, 4 through the public entry
    points, the counts set to 0 just before and read just after.  o and
    every adamw output equal the plain version; r within the f32 sum
    limit; lost-stream and lost-step controls above it; times against
    the bound and, where one PyTorch call computes it, that call."""
    import torch
    from repro_torch.codegen import plan_blocks, run_spec
    from repro_torch.core import StridingConfig
    from repro_torch.kernels import cuda, manual
    from repro_torch.kernels.adamw import _HYPER
    from repro_torch.kernels.adamw import ops as aops
    from repro_torch.kernels.adamw import specs as aspecs
    gen = torch.Generator(device="cuda").manual_seed(17)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, cols = STREAM_SHAPE
    rcfgs = {la: StridingConfig(2, 1, lookahead=la, block_rows=1)
             for la in K4_LOOKAHEADS}
    acfgs = {la: aops._DEFAULT.replace(lookahead=la) for la in K4_LOOKAHEADS}
    shape = ADAMW_SHAPES["bench"]

    def rand(shp, dt):
        return torch.randn(*shp, generator=gen, device="cuda").to(dt)

    def adamw_inputs():
        return (rand(shape, torch.bfloat16), rand(shape, torch.bfloat16),
                rand(shape, torch.float32),
                torch.rand(*shape, generator=gen, device="cuda"))
    def rowstat_input(dt):
        # mean 1, as the read's: a lost row moves its sum by about cols,
        # far above the f32 limit (a mean-zero row sums to about sqrt(cols))
        return (1 + rand(STREAM_SHAPE, torch.float32)).to(getattr(torch, dt))
    xs = {dt: rowstat_input(dt) for dt in STREAM_DTYPES}
    ains = adamw_inputs()
    names = ("manual_ring_rowstat", "manual_ring_adamw")
    for k in cuda.KERNELS.values():
        k.launches = 0
    routs = {(dt, la): run_spec(manual.rowstat_spec, (xs[dt],), cfg)
             for dt in STREAM_DTYPES for la, cfg in rcfgs.items()}
    aouts = {la: aops.adamw_update(*ains, config=cfg, **_HYPER)
             for la, cfg in acfgs.items()}
    torch.cuda.synchronize()
    counts = {n: cuda.KERNELS[n].launches for n in names}
    want = {"manual_ring_rowstat": len(STREAM_DTYPES) * len(K4_LOOKAHEADS),
            "manual_ring_adamw": len(K4_LOOKAHEADS)}
    others = {n: k.launches for n, k in cuda.KERNELS.items()
              if n not in names and k.launches}
    if counts != want or others:
        raise AssertionError(f"k4: launches {counts} (others {others}), "
                             f"expected {want}")
    print(f"k4: main path (t_rowstat ring {list(STREAM_DTYPES)} x lookahead "
          f"{list(K4_LOOKAHEADS)}; adamw_update ring, bf16 p and g, f32 m "
          f"and v, lookahead {list(K4_LOOKAHEADS)}) launches "
          f"{json.dumps(counts)} [{card}]")
    print(f"k4: tolerances: o and p', m', v' |d| = 0; r |d| <= 2 c 2^-24 "
          f"sum|x| + 2^-23 |r| over a row's n = {cols} terms, c = min(n, "
          f"{LAMBDA:g} sqrt n), on x = 1 + N(0, 1); controls: stream 1 "
          f"lost, one step of it lost [{card}]")
    seg = rows // 2
    for dt in STREAM_DTYPES:
        x = xs[dt]
        isz = x.element_size()
        ro, rr = run_spec(manual.rowstat_spec, (x,), rcfgs[1], mode="ref")
        bp = plan_blocks(manual.rowstat_spec(x), rcfgs[1])

        def lost(t, n_rows):
            t = t.clone()
            t[seg:seg + n_rows] = 0
            return t
        limit = _dot_limit(x.float().abs().sum(1), rr, cols)
        sets = _copies(lambda: (rowstat_input(dt),), rows * cols * isz)
        plain = device_ms(lambda a: run_spec(manual.rowstat_spec, (a,),
                                             rcfgs[1], mode="ref"), sets)
        bms, by = bound_ms(rows * cols * (isz + 4) + rows * 4,
                           2.0 * rows * cols, dt)
        for la, cfg in rcfgs.items():
            o, r = routs[(dt, la)]
            err_o, ctl_o = _hold(f"t_rowstat {dt} la={la} o", o, ro, 0.0,
                                 {"lost stream": lost(ro, seg)})
            err_r, ctl_r = _hold(f"t_rowstat {dt} la={la} r", r, rr, limit,
                                 {"lost stream": lost(rr, seg),
                                  "lost step": lost(rr, bp.bm)})
            plan = manual.ring_plan("t_rowstat", x.dtype, bp, cfg, sms)
            print(ring_line(f"manual_ring_rowstat {dt} la={la}", plan, sms,
                            card))
            ms = device_ms(lambda a, _c=cfg: run_spec(
                manual.rowstat_spec, (a,), _c), sets)
            print(f"manual_ring_rowstat x [{rows}, {cols}] {dt} -> o f32, r "
                  f"[{rows}] f32, D=2, bm={bp.bm}, lookahead {la}, whole-row "
                  f"steps ({plan.smem} B of shared memory): max_abs_err o={err_o:g}"
                  f" r={err_r:g}; controls o {ctl_o}; r {ctl_r}; ms={ms:.5f} "
                  f"plain_ms={plain:.5f} bound_ms={bms:.6f} ({by}) "
                  f"library_ms=none (no one call gives both) "
                  f"{ms / bms:.2f}x bound [{card}]")
            if dt == "float32" and la == 3:
                results["manual_ring_rowstat"] = dict(
                    name="manual_ring_rowstat", route="cuda",
                    source="src/repro_torch/csrc/manual_ring.cu",
                    replaces="src/repro/codegen/emit.py:708",
                    launches=counts["manual_ring_rowstat"], ms=ms,
                    plain_ms=plain, bound_ms=bms, bound_by=by,
                    library_ms=None, max_abs_err=max(err_o, err_r),
                    shape=f"x [{rows}, {cols}] f32, D=2, bm=1, lookahead 3")
        del sets

    # adamw with bf16 p and g on the ring
    p, g, m, v = ains
    n = p.numel()
    ref = aops.adamw_update(p, g, m, v, mode="ref", **_HYPER)
    arows, acols = aops._blocking(n)
    aseg = arows // 2

    def lost_a(out, inp):
        t = out.clone().view(arows, acols)
        t[aseg:2 * aseg] = inp.view(arows, acols)[aseg:2 * aseg].to(t.dtype)
        return t.view(shape)
    sets = _copies(adamw_inputs, 12 * n)
    s7 = torch.stack(aops.scalars(torch.device("cuda"),
                                  *_HYPER.values())).unbind()
    plain = device_ms(lambda *a: aops.adamw_update(*a, *s7, mode="ref"), sets)
    step = torch.ones((), device="cuda")

    def library(p_, g_, m_, v_):
        torch._fused_adamw_([p_], [g_], [m_], [v_], [], [step],
                            lr=_HYPER["lr"], beta1=0.9, beta2=0.999,
                            weight_decay=_HYPER["wd"], eps=_HYPER["eps"],
                            amsgrad=False, maximize=False)
    try:
        lib_sets = [tuple(t.clone() for t in st) for st in sets]
        lib = device_ms(library, lib_sets)
        lib_line = f"{lib:.5f} (torch._fused_adamw_, bf16 p, f32 m, v)"
    except (RuntimeError, TypeError) as exc:
        lib, lib_line = None, (f"none (torch._fused_adamw_ refuses bf16 p "
                               f"with f32 m, v: {str(exc)[:80]})")
    bms, by = bound_ms(22.0 * n, ADAMW_FLOPS * n, "float32")
    aspec = aspecs.adamw_spec(torch.empty(arows, acols, device="meta"), None,
                              None, None)
    for la, cfg in acfgs.items():
        print(ring_line(f"manual_ring_adamw [{arows}, {acols}] bf16 p, g "
                        f"la={la}", manual.ring_plan(
                            "adamw_update", torch.bfloat16,
                            plan_blocks(aspec, cfg), cfg, sms), sms, card))
    for la, cfg in acfgs.items():
        err, ctl = 0.0, []
        for name, got, want_, inp in zip(("p'", "m'", "v'"), aouts[la], ref,
                                         (p, m, v)):
            e, line = _hold(f"adamw ring bf16 la={la} {name}", got, want_,
                            0.0, {"lost stream": lost_a(want_, inp)})
            err = max(err, e)
            ctl.append(f"{name} {line}")
        ms = device_ms(lambda *a, _c=cfg: aops.adamw_update(*a, *s7,
                                                             config=_c), sets)
        print(f"adamw ring_la{la} p, g [{shape[0]}, {shape[1]}] bf16, m, v "
              f"f32: max_abs_err={err:g}; controls {'; '.join(ctl)}; "
              f"ms={ms:.5f} plain_ms={plain:.5f} bound_ms={bms:.6f} ({by}, "
              f"22 bytes an element) library_ms={lib_line} "
              f"{ms / bms:.2f}x bound [{card}]")
    del sets, xs, routs, aouts, ains
    torch.cuda.empty_cache()


REGISTRY_FULL = (16384, 4096)        # square f32 matrices: 1 GiB, 64 MiB
REGISTRY_SOURCES = {
    "transpose": ("src/repro_torch/csrc/transpose.cu",
                  "src/repro/codegen/emit.py:410"),
    "rowstat": ("src/repro_torch/csrc/reduction.cu",
                "src/repro/codegen/emit.py:491"),
    "gemver_mxv2": ("src/repro_torch/csrc/reduction.cu",
                    "src/repro/codegen/emit.py:491"),
    "gemver_mxv1": ("src/repro_torch/csrc/stream_reduction.cu",
                    "src/repro/codegen/emit.py:564 (its merge folded into "
                    "the same launch)"),
    "gemver_mxv1_sum": ("src/repro_torch/csrc/stream_reduction.cu",
                        "src/repro/codegen/emit.py:564 (its merge and "
                        "total folded into the same launch)"),
}


def _leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


def phase_registry(card: str, results: dict) -> None:
    """(a) Every registry row at each of its six conformance points and
    once at its bench size: ``run(inputs, config, None)`` (the kernels)
    against ``run(..., "ref")`` (the plain versions) on the card, at the
    row's rtol / atol; the counts are set to 0 just before and read just
    after, and every kernel of the five new instances must have run.
    (b) The five new instances through their public ``*_gen`` ops at
    16384^2 and 4096^2 f32 (transpose and rowstat also in bf16 at both):
    each against its plain version (equality for transpose and the row
    max, the f32 dot limit otherwise) with a lost-stream control that must
    land outside the limit, and timed: kernel, plain version, bound and
    one library call."""
    import torch
    from repro_torch import registry
    from repro_torch.core.striding import StridingConfig
    from repro_torch.kernels import cuda
    from repro_torch.kernels.gen import kernel as genk  # noqa: F401 (counts)
    from repro_torch.kernels.mxv import kernel as mk  # noqa: F401 (counts)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")

    # (a) the whole registry
    worst: dict = {}                    # (family, row, bench?) → excess
    failures = []
    for k in cuda.KERNELS.values():
        k.launches = 0
    n_runs = 0
    for row in registry.all_specs():
        points = [(label, cfg, row.default_sizes)
                  for label, cfg in registry.CONFORMANCE_CONFIGS]
        points += [("aliased", StridingConfig(4, 1), row.aliased_sizes),
                   ("bench", None, row.bench_problem)]
        for label, cfg, sizes in points:
            inputs = row.make_inputs(dict(sizes), torch.float32, dev)
            got = _leaves(row.run(inputs, cfg, None))
            want = _leaves(row.run(inputs, cfg, "ref"))
            n_runs += 1
            if len(got) != len(want):
                raise AssertionError(f"registry {row.name} {label}: "
                                     f"{len(got)} outputs, {len(want)} plain")
            for g, w in zip(got, want):
                if g.shape != w.shape or g.device.type != "cuda":
                    raise AssertionError(f"registry {row.name} {label}: "
                                         f"{tuple(g.shape)} on {g.device}")
                excess = float(((g.float() - w.float()).abs()
                                - (row.atol + row.rtol * w.float().abs()))
                               .max())
                if not excess <= 0:
                    failures.append(
                        f"{row.name} {label} {dict(sizes)}: kernel vs plain "
                        f"over rtol={row.rtol} atol={row.atol} by "
                        f"{excess:g}")
                key = (row.family, row.name, label == "bench")
                worst[key] = max(worst.get(key, -math.inf), excess)
            del inputs, got, want
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in cuda.KERNELS.items() if k.launches}
    new = tuple(REGISTRY_SOURCES)
    missing = [n for n in new if not cuda.KERNELS[n].launches]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    for name in new:
        results[name] = dict(name=name, route="cuda",
                             source=REGISTRY_SOURCES[name][0],
                             replaces=REGISTRY_SOURCES[name][1],
                             launches=counts.get(name, 0))
    for fam in sorted({f for f, _, _ in worst}):
        line = []
        for bench in (False, True):
            rows = {n: e for (f, n, b), e in worst.items()
                    if f == fam and b == bench}
            name, e = max(rows.items(), key=lambda kv: kv[1])
            line.append(f"{e:.3g} ({name})")
        print(f"registry {fam}: {len(rows)} rows, worst excess of |kernel - "
              f"plain| over atol + rtol |plain| at the six points "
              f"{line[0]}, at the bench size {line[1]} (<= 0 passes) "
              f"[{card}]")
    print(f"registry: {n_runs} runs in {time.perf_counter() - t_phase:.1f}"
          f" s, main path launches {json.dumps(counts)} [{card}]")
    if failures:
        raise AssertionError("registry: " + "; ".join(failures))
    torch.cuda.empty_cache()

    # (b) the five new instances at full size
    cfg = StridingConfig(4, 2)          # the *_gen ops' default
    print(f"registry instances: tolerances: transpose and rowstat's max "
          f"|d| = 0; rowstat's sum |d| <= 2 c 2^-24 sum|x| + 2^-23 |ref|; "
          f"the matrix-vector steps the dot limit of linalg, scaled by "
          f"alpha (beta), plus the roundings of the adds; the total of "
          f"gemver_mxv1_sum {LAMBDA:g} 2^-24 sqrt(4 m sum_j t_j^2 + 2 n "
          f"(sum_j |s_j|)^2) + 2^-23 |total|, t_j = beta (|y|^T |A|)_j "
          f"(Hoeffding over independent mean-zero roundings, each within "
          f"2^-24 of the partial sum it rounds). "
          f"Controls: the plain output with stream k=1's segment lost "
          f"[{card}]")
    for n in REGISTRY_FULL:
        for dtype in ("float32", "bfloat16"):
            _registry_instances(card, results, n, getattr(torch, dtype), cfg)
            torch.cuda.empty_cache()
    print(f"registry: phase took {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")


def _registry_instances(card, results, n, dtype, cfg):
    """The five instances at [n, n] in ``dtype`` (see phase_registry)."""
    import torch
    from repro_torch.kernels.gen import kernel as genk
    from repro_torch.kernels.gen import (gemver_mxv1_gen, gemver_mxv1_sum_gen,
                                         gemver_mxv2_gen, rowstat_gen,
                                         transpose_gen)
    gen = torch.Generator(device="cuda").manual_seed(16 + n)
    f32 = dtype == torch.float32
    tname = "f32" if f32 else "bf16"
    size = dtype.itemsize
    seg = n // cfg.stride_unroll

    def mat():
        return torch.randn(n, n, generator=gen, device="cuda").to(dtype)

    def vec():
        return torch.randn(n, generator=gen, device="cuda")

    def drop(t, start, count, dim=0):
        t = t.clone()
        t.narrow(dim, start, count).zero_()
        return t

    def timed(name, fn, plain, library, make, nbytes, flops, err, line,
              shape):
        sets = _copies(make, nbytes)
        ms = device_ms(fn, sets)
        plain_ms = device_ms(plain, sets)
        lib_ms = device_ms(library, sets)
        bms, by = bound_ms(nbytes, flops, "float32" if f32 else "bfloat16")
        print(f"{name} {shape}: max_abs_err={err:g}; {line}; ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} bound_ms={bms:.6f} ({by}) "
              f"library_ms={lib_ms:.5f} ({len(sets)} input sets) [{card}]")
        if n == REGISTRY_FULL[0] and f32:
            results[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                 bound_by=by, library_ms=lib_ms,
                                 max_abs_err=err, shape=shape)
        del sets

    a = mat()
    shape = f"[{n}, {n}] {tname}"
    # transpose: equality, lost stream = stream 1's output columns zeroed
    y_k = transpose_gen(a, config=cfg)
    y_p = transpose_gen(a, config=cfg, mode="ref")
    err, line = _hold(f"transpose n={n}", y_k, y_p.contiguous(), 0.0,
                      {"lost stream": drop(y_p, seg, seg, dim=1)})
    timed("transpose", lambda x: transpose_gen(x, config=cfg),
          lambda x: transpose_gen(x, config=cfg, mode="ref"),
          lambda x: x.t().contiguous(), lambda: (mat(),) if n < 8192 else (a,),
          2 * n * n * size, 0.0, err, line,
          f"x {shape}, D={cfg.stride_unroll} (plain: a transposed view)")
    del y_k, y_p
    # rowstat: the max bit for bit, the sum within the sum limit
    g = genk.rowstat_geometry(n, n, size, cfg.stride_unroll,
                              torch.cuda.get_device_properties(0)
                              .multi_processor_count)
    print(f"rowstat x {shape} launch: {g.streams} streams a group, "
          f"{g.parts} parts a slot of {g.per_part} of a row's {g.units} "
          f"16-byte lane units, {g.blocks} blocks of {g.slots} row slots "
          f"[{card}]")
    mx_k, sm_k = rowstat_gen(a, config=cfg)
    mx_p, sm_p = rowstat_gen(a, config=cfg, mode="ref")
    err_m, line_m = _hold(f"rowstat max n={n}", mx_k, mx_p, 0.0,
                          {"lost stream": drop(mx_p, seg, seg)})
    err_s, line_s = _hold(f"rowstat sum n={n}", sm_k, sm_p,
                          _dot_limit(a.float().abs().sum(1), sm_p, n),
                          {"lost stream": drop(sm_p, seg, seg)})
    timed("rowstat", lambda x: rowstat_gen(x, config=cfg),
          lambda x: rowstat_gen(x, config=cfg, mode="ref"),
          lambda x: (x.amax(1), x.sum(1)),
          lambda: (mat(),) if n < 8192 else (a,),
          n * n * size + 2 * n * 4, 2.0 * n * n, max(err_m, err_s),
          f"max {line_m}; sum {line_s}",
          f"x {shape}, D={cfg.stride_unroll}, P={cfg.portion_unroll}")
    del mx_k, sm_k, mx_p, sm_p
    if not f32:
        del a
        return
    x, y, z = vec(), vec(), vec()
    aa = a.abs()
    col = BETA * (y.abs() @ aa)
    # gemver_mxv2: w = alpha A x
    w_k = gemver_mxv2_gen(a, x, ALPHA, config=cfg)
    w_p = gemver_mxv2_gen(a, x, ALPHA, config=cfg, mode="ref")
    err, line = _hold(f"gemver_mxv2 n={n}", w_k, w_p,
                      ALPHA * _dot_limit(aa @ x.abs(), w_p, n),
                      {"lost stream": drop(w_p, seg, seg)})
    timed("gemver_mxv2", lambda a_, x_: gemver_mxv2_gen(a_, x_, ALPHA,
                                                        config=cfg),
          lambda a_, x_: gemver_mxv2_gen(a_, x_, ALPHA, config=cfg,
                                         mode="ref"),
          lambda a_, x_: ALPHA * torch.mv(a_, x_),
          lambda: (mat(), vec()) if n < 8192 else (a, x),
          n * n * 4 + 2 * n * 4, 2.0 * n * n, err, line,
          f"A {shape}, D={cfg.stride_unroll}, P={cfg.portion_unroll}")
    del w_k, w_p
    # gemver_mxv1: x + beta A^T y, both passes
    lost_y = drop(y, seg, seg)
    lim1 = _dot_limit(col, col, n) + 4 * GAMMA * (x.abs() + col)
    x1_k = gemver_mxv1_gen(a, y, x, BETA, config=cfg)
    x1_p = gemver_mxv1_gen(a, y, x, BETA, config=cfg, mode="ref")
    err, line = _hold(f"gemver_mxv1 n={n}", x1_k, x1_p, lim1,
                      {"lost stream": gemver_mxv1_gen(a, lost_y, x, BETA,
                                                      config=cfg,
                                                      mode="ref")})
    timed("gemver_mxv1", lambda a_, y_, x_: gemver_mxv1_gen(a_, y_, x_, BETA,
                                                            config=cfg),
          lambda a_, y_, x_: gemver_mxv1_gen(a_, y_, x_, BETA, config=cfg,
                                             mode="ref"),
          lambda a_, y_, x_: x_ + BETA * torch.mv(a_.t(), y_),
          lambda: (mat(), vec(), vec()) if n < 8192 else (a, y, x),
          n * n * 4 + 4 * n * 4, 2.0 * n * n, err, line,
          f"A {shape}, D={cfg.stride_unroll}, one launch")
    del x1_k, x1_p
    # gemver_mxv1_sum: (x + s + z, total), full width, on A and y of
    # 1 + N(0, 1) entries (PolyBench fills gemver with positive values):
    # with zero-mean entries the total cancels to a random size, and a
    # lost stream can move it by less than its limit
    a.add_(1.0)
    y = y + 1.0
    lost_y = drop(y, seg, seg)
    col = BETA * (y.abs() @ a.abs())
    lim2 = _dot_limit(col, col, n) + 4 * GAMMA * (x.abs() + col + z.abs())
    (o_k, t_k) = gemver_mxv1_sum_gen(a, y, x, z, BETA, config=cfg)
    (o_p, t_p) = gemver_mxv1_sum_gen(a, y, x, z, BETA, config=cfg,
                                     mode="ref")
    lo_p, lt_p = gemver_mxv1_sum_gen(a, lost_y, x, z, BETA, config=cfg,
                                     mode="ref")
    err_o, line_o = _hold(f"gemver_mxv1_sum n={n}", o_k, o_p, lim2,
                          {"lost stream": lo_p})
    # per entry: the kernel's n fma and partial sums, the plain version's
    # n products and n adds, the scalings: at most 4 n roundings
    s_p = BETA * (y @ a)
    t_lim = _total_limit(col, 4 * n, s_p.abs().sum(), n, t_p).reshape(())
    err_t, line_t = _hold(f"gemver_mxv1_sum total n={n}", t_k, t_p, t_lim,
                          {"lost stream": lt_p})
    again = gemver_mxv1_sum_gen(a, y, x, z, BETA, config=cfg)[1]
    if not torch.equal(again, t_k):
        raise AssertionError("gemver_mxv1_sum: the total's bits changed "
                             "from one run to the next")

    def mxv1_sum_lib(a_, y_, x_, z_):
        s = BETA * torch.mv(a_.t(), y_)
        return x_ + s + z_, s.sum()
    timed("gemver_mxv1_sum",
          lambda a_, y_, x_, z_: gemver_mxv1_sum_gen(a_, y_, x_, z_, BETA,
                                                     config=cfg),
          lambda a_, y_, x_, z_: gemver_mxv1_sum_gen(a_, y_, x_, z_, BETA,
                                                     config=cfg, mode="ref"),
          mxv1_sum_lib,
          lambda: ((mat(), vec(), vec(), vec()) if n < 8192
                   else (a, y, x, z)),
          n * n * 4 + 4 * n * 4 + 4, 2.0 * n * n, max(err_o, err_t),
          f"x' {line_o}; total {line_t} (bits repeat)",
          f"A {shape}, D={cfg.stride_unroll}, full width, one launch; "
          f"checked on A, y of 1 + N(0, 1)")
    del a, aa, x, y, z, col, o_k, o_p, t_k, t_p, lo_p, lt_p


def phase_train(card: str) -> dict:
    """Yi-9B at full width, depth cut to 8 layers, trains through the
    launcher's path (``repro_torch.launch.train.setup``): f32 params,
    bf16 compute, seq 4096, batch 2, remat, AdamW(lr 3e-3, warmup 10,
    50 total steps), SyntheticTokens(seed 0).  Six steps, each with the
    counts set to 0 just before and read just after (33 rmsnorm, 75
    adamw_update every step); then a checkpoint round trip of the state,
    the in-model check of the kernels against mode="ref", and where a
    step's time goes.  Returns the launches over the six steps."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.launch import train as launch
    from repro_torch.train import trainstep
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        t_setup = time.perf_counter()
        run = launch.setup(TRAIN_ARGS + ["--ckpt-dir", ckpt])
        torch.cuda.synchronize()
        cfg, state = run.cfg, run.state
        named = dict(state["params"].named_parameters())
        n_params = sum(p.numel() for p in named.values())
        b, s = run.args.batch, run.args.seq
        print(f"train: {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}"
              f"/{cfg.n_kv_heads}x{cfg.head_dim} d_ff={cfg.d_ff} vocab="
              f"{cfg.vocab_size}, n_layers={cfg.n_layers} of 48 (cut: params,"
              f" grads, m, v of 48 layers are 141 GB), {n_params / 1e9:.3f}B "
              f"params in {len(named)} tensors, param {cfg.param_dtype} "
              f"compute {cfg.compute_dtype}, seq {s} batch {b}, state drawn "
              f"in {time.perf_counter() - t_setup:.1f} s [{card}]")
        want = {"rmsnorm": 4 * cfg.n_layers + 1, "adamw_update": len(named)}
        losses, total = [], {n: 0 for n in want}
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            batch = {"tokens": torch.from_numpy(run.data.batch(step)).cuda()}
            for k in cuda.KERNELS.values():
                k.launches = 0
            t0 = time.perf_counter()
            state, metrics = run.step_fn(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {n: k.launches for n, k in cuda.KERNELS.items()
                      if k.launches}
            if counts != want:
                raise AssertionError(f"train step {step}: launches {counts},"
                                     f" expected {want}")
            for n in want:
                total[n] += counts[n]
            m = {k: float(v) for k, v in metrics.items()}
            if not all(math.isfinite(x) for x in m.values()):
                raise AssertionError(f"train step {step}: non-finite {m}")
            losses.append(m["loss"])
            run.monitor.record(launch.HOST, wall)
            print(f"train step {step}: loss {m['loss']:.4f} nll "
                  f"{m['nll']:.4f} lr {m['lr']:.3e} grad_norm "
                  f"{m['grad_norm']:.4f} wall {wall * 1e3:.1f} ms "
                  f"({b * s / wall:.0f} tokens/s) launches "
                  f"{json.dumps(counts)} [{card}]")
        if not 11.0 <= losses[0] <= 12.0:
            raise AssertionError(f"train: step 0 loss {losses[0]} outside "
                                 "[11, 12] (expected about 11.47)")
        med = run.monitor.medians()[launch.HOST]
        print(f"train: {TRAIN_STEPS} steps, median step {med * 1e3:.1f} ms, "
              f"{b * s / med:.0f} tokens/s; launches over the run "
              f"{json.dumps(total)}; max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

        # checkpoint round trip of the trained state, bit-equal; the
        # restored host copy is the snapshot both in-model steps start from
        t0 = time.perf_counter()
        run.mgr.save(TRAIN_STEPS, trainstep.state_tree(state))
        run.mgr.wait()
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        step_no, snap = run.mgr.restore()
        t_restore = time.perf_counter() - t0
        tree = trainstep.state_tree(state)
        flat = [(k, t, snap["params"][k])
                for k, t in tree["params"].items()]
        flat += [(f"{w}/{k}", t, snap["opt_state"][w][k]) for w in ("m", "v")
                 for k, t in tree["opt_state"][w].items()]
        flat.append(("step", tree["opt_state"]["step"],
                     snap["opt_state"]["step"]))
        for key, t, a in flat:
            if not torch.equal(torch.from_numpy(np.asarray(a)).cuda(), t):
                raise AssertionError(f"checkpoint: {key} differs after "
                                     "restore")
        nbytes = sum(np.asarray(a).nbytes for _, _, a in flat)
        print(f"checkpoint: step {step_no}, {len(flat)} leaves, "
              f"{nbytes / 1e9:.2f} GB, save {t_save:.1f} s, restore "
              f"{t_restore:.1f} s, bit-equal [{card}]")
        del flat, tree
        shutil.rmtree(os.path.join(run.mgr.dir, f"step_{TRAIN_STEPS:09d}"))
        _in_model_train(card, run, state, snap)
        del snap
        _profile_train(card, run, state)
        return total
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _in_model_train(card, run, state, snap) -> None:
    """One step with the kernels and one with mode="ref" (plain rmsnorm
    and AdamW on the card) from the same state and batch.  Limits: the
    loss within 1e-3 and the grad norm within 1e-2 of the plain path's,
    relative (the kernels' one difference in the forward is rmsnorm's
    f32 row sum taken in another order, which can move a bf16 output one
    ulp); each parameter's update within 1e-2 of the plain update's
    norm, ||p_k - p_r|| <= 1e-2 ||p_r - p_0|| (an update is about lr per
    entry, so this scales with lr).  Control: the embedding's update with
    stream 1 of its AdamW blocking lost (rows left at p_0) must land
    above that limit."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.adamw import ops as aops
    from repro_torch.train import trainstep
    ref_step = trainstep.make_train_step(run.model, run.ocfg, mode="ref")
    batch = {"tokens": torch.from_numpy(
        run.data.batch(TRAIN_STEPS)).cuda()}
    for k in cuda.KERNELS.values():
        k.launches = 0
    state, mk = run.step_fn(state, batch)
    counts = {n: k.launches for n, k in cuda.KERNELS.items() if k.launches}
    pk = {k: p.detach().clone()
          for k, p in state["params"].named_parameters()}
    trainstep.load_state_tree(state, snap)
    for k in cuda.KERNELS.values():
        k.launches = 0
    state, mr = ref_step(state, batch)
    torch.cuda.synchronize()
    ref_counts = {n: k.launches for n, k in cuda.KERNELS.items()
                  if k.launches}
    if ref_counts:
        raise AssertionError(f"in-model train: the ref step launched "
                             f"{ref_counts}")
    lr = float(mr["lr"])
    dl = abs(float(mk["loss"]) - float(mr["loss"])) / abs(float(mr["loss"]))
    dg = abs(float(mk["grad_norm"]) - float(mr["grad_norm"])) / float(
        mr["grad_norm"])
    worst, worst_name, max_abs = 0.0, "", 0.0
    for k, p in state["params"].named_parameters():
        p0 = torch.from_numpy(np.asarray(snap["params"][k])).cuda()
        upd = float((p.detach() - p0).norm())
        ratio = float((pk[k] - p.detach()).norm()) / max(upd, 1e-30)
        max_abs = max(max_abs, float((pk[k] - p.detach()).abs().max()))
        if ratio > worst:
            worst, worst_name = ratio, k
        if k == "embed":
            rows, cols = aops._blocking(p.numel())
            seg = rows // 2
            ctl = pk[k].clone().view(rows, cols)
            ctl[seg:2 * seg] = p0.view(rows, cols)[seg:2 * seg]
            ctl_ratio = float((ctl.view(p.shape) - p.detach()).norm()) / upd
            del ctl
        del p0
    print(f"in-model train: kernels vs mode=\"ref\" from the same state "
          f"(step {TRAIN_STEPS}, lr {lr:.3e}): loss {float(mk['loss']):.6f} "
          f"vs {float(mr['loss']):.6f} (rel {dl:.2e}, limit 1e-3), grad_norm "
          f"{float(mk['grad_norm']):.6f} vs {float(mr['grad_norm']):.6f} "
          f"(rel {dg:.2e}, limit 1e-2); worst update ratio "
          f"||p_k - p_r|| / ||p_r - p_0|| {worst:.2e} ({worst_name}, limit "
          f"1e-2), max|p_k - p_r| {max_abs:.3e} = {max_abs / lr:.3f} lr; "
          f"control, embed with stream 1 lost: {ctl_ratio:.3f}; kernel step "
          f"launches {json.dumps(counts)} [{card}]")
    if dl > 1e-3 or dg > 1e-2 or worst > 1e-2:
        raise AssertionError("in-model train: kernels disagree with the "
                             "plain path beyond the limits")
    if ctl_ratio <= 1e-2:
        raise AssertionError("in-model train: a lost AdamW stream stays "
                             "inside the limit, so the check cannot see it")
    del pk


def _profile_train(card, run, state) -> None:
    """Where a training step's time goes: wall time (host clock,
    synchronized, unprofiled, from the six steps), device time by kernel
    and the busy share (torch.profiler over one step), AdamW's share
    against its bound, and the model FLOPs against the bf16 peak."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cfg = run.cfg
    b, s = run.args.batch, run.args.seq
    batch = {"tokens": torch.from_numpy(
        run.data.batch(TRAIN_STEPS + 1)).cuda()}
    t0 = time.perf_counter()
    run.step_fn(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run.step_fn(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev(e) > 0]
    total_ms = sum(dev(e) for e in kernels) / 1e3
    named = dict(state["params"].named_parameters())
    n_state = sum(p.numel() for p in named.values())
    adamw_bytes = 28 * n_state
    adamw_bound = adamw_bytes / HBM_BYTES_PER_S * 1e3
    # model FLOPs, no recompute counted: 6 N T for the matmul weights
    # (layers and head; the embedding is a gather) and 3x the causal
    # attention's two forward products, computed in full (12 L B S^2 Hq dh)
    n_mm = sum(p.numel() for k, p in named.items()
               if p.ndim == 2 and k != "embed")
    flops = (6 * n_mm * b * s
             + 12 * cfg.n_layers * b * s * s * cfg.n_heads * cfg.head_dim)
    peak_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    print(f"profile train: step wall {wall * 1e3:.1f} ms ({b * s / wall:.0f}"
          f" tokens/s); model FLOPs {flops / 1e12:.1f} T (6 N T, N = "
          f"{n_mm / 1e9:.3f}B matmul params, T = {b * s}, + attention), "
          f"{peak_ms:.1f} ms at the bf16 dense peak: {100 * peak_ms / (wall * 1e3):.1f}% "
          f"of peak; AdamW moves {adamw_bytes / 1e9:.1f} GB, bound "
          f"{adamw_bound:.1f} ms [{card}]")
    if total_ms <= 0:
        print(f"profile train: the profiler recorded no device kernels "
              f"[{card}]")
        return
    busy = total_ms / (wall * 1e3)
    adamw_ms = sum(dev(e) for e in kernels if "adamw" in e.key) / 1e3
    print(f"profile train: device kernels {total_ms:.1f} ms ({100 * busy:.1f}%"
          f" busy, {100 - 100 * busy:.1f}% idle against the unprofiled "
          f"wall); adamw_update kernel {adamw_ms:.2f} ms "
          f"({100 * adamw_ms / total_ms:.1f}% of device time, "
          f"{adamw_ms / adamw_bound:.2f}x its bound) [{card}]")
    for e in sorted(kernels, key=dev, reverse=True)[:15]:
        print(f"  {dev(e) / 1e3:9.3f} ms {100 * dev(e) / 1e3 / total_ms:5.1f}% "
              f"{e.count:6d} calls  {e.key[:90]}")


def phase_serve(card: str):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config("yi-9b")          # full width and depth
    print(f"serve: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"n_params={cfg.n_params() / 1e9:.2f}B {cfg.compute_dtype}")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    print(f"serve: weights drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    engine = ServingEngine(model, params, ServeConfig(
        slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
        max_new_tokens=SERVE_NEW))
    rng = np.random.default_rng(0)
    prompts = {uid: rng.integers(0, cfg.vocab_size, int(rng.integers(8, 65)))
               for uid in range(SERVE_REQUESTS)}
    for uid, toks in prompts.items():
        engine.submit(uid, toks)
    for k in cuda.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: k.launches for name, k in cuda.KERNELS.items()}
    st = engine.stats()
    steps = st["decode_steps"] + st["prefill_steps"]
    for uid in prompts:
        out = results.get(uid, [])
        if len(out) != SERVE_NEW or not all(0 <= t < cfg.vocab_size
                                            for t in out):
            raise AssertionError(f"serve: request {uid} returned {out}")
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * steps,
            "decode_attn": cfg.n_layers * steps,
            "decode_attn_merge": cfg.n_layers * steps}
    for name, n in want.items():
        if counts.get(name) != n:
            raise AssertionError(f"serve: {name} launched {counts.get(name)} "
                                 f"times, expected {n} over {steps} steps")
    print(f"serve: {len(results)} requests x {SERVE_NEW} tokens, "
          f"{st['decode_steps']} decode + {st['prefill_steps']} prefill steps "
          f"in {wall:.2f} s; mean_decode_step_s={st['mean_decode_step_s']:.6f} "
          f"mean_prefill_step_s={st['mean_prefill_step_s']:.6f} "
          f"tokens_generated={st['tokens_generated']} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB [{card}]")
    per_step = {k: v / steps for k, v in counts.items()}
    print(f"serve: kernel launches {json.dumps(counts)}, per step "
          f"{json.dumps(per_step)} [{card}]")
    return model, params, engine, counts


def phase_in_model(card: str, model, params, engine) -> None:
    """Two decode steps with the kernels and with ``mode="ref"`` on the
    same weights, tokens and a KV cache filled in every decode segment;
    row k's position lies in segment k, so segments 1-3 and the merge of
    non-empty segments run inside the model.

    The limit comes from a control: the plain path with every attention
    output moved one bf16 ulp (random sign) in every layer, which is
    more rounding than the kernels add.  Two faults of the kind a decode
    kernel can have are read too: segment 1's rows lost before the merge
    (must land above the limit, or the check is blind) and ``kv_len``
    one short (read, not required)."""
    import numpy as np
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.decode_attn import ops as dops
    cfg = model.cfg
    rng = np.random.default_rng(3)
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s = SERVE_SLOTS, SERVE_MAX_LEN
    d = common.resolve_config("decode_attn", None, s, dops._DEFAULT).stride_unroll
    seg = s // d
    pos = torch.as_tensor([int(rng.integers((k % d) * seg + 16,
                                            (k % d + 1) * seg - 2))
                           for k in range(b)], device="cuda")
    toks = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, 1)),
                            device="cuda") for _ in range(2)]
    cache0 = []
    for layer in engine.cache:        # the served rows' scale, every row
        cache0.append({n: (torch.randn(t.shape, generator=gen, device="cuda")
                           * float(t[:, :8].float().std())).to(t.dtype)
                       for n, t in layer.items()})
    plain = dops.decode_attn

    def lost_segment(q, kc, vc, kv_len=None, **kw):
        def cut(c):
            return torch.cat([c[:, :seg], c[:, 2 * seg:]], 1)
        return plain(q, cut(kc), cut(vc),
                     kv_len - (kv_len - seg).clamp(0, seg), **kw)

    def short_kv_len(q, kc, vc, kv_len=None, **kw):
        return plain(q, kc, vc, kv_len - 1, **kw)

    def one_ulp(q, kc, vc, kv_len=None, **kw):
        out = plain(q, kc, vc, kv_len, **kw).float()
        ulp = torch.ldexp(torch.ones_like(out), torch.frexp(out).exponent - 8)
        sign = torch.randint(0, 2, out.shape, generator=gen,
                             device="cuda") * 2 - 1
        return (out + sign * torch.where(out == 0, 0, ulp)).to(q.dtype)

    def run(mode=None, fault=None):
        cache = [{n: t.clone() for n, t in c.items()} for c in cache0]
        dops.decode_attn = fault or plain
        try:
            with torch.inference_mode():
                return [model.decode_step(params, toks[i], cache, pos + i,
                                          mode=mode)[0].float()
                        for i in range(2)]
        finally:
            dops.decode_attn = plain

    from repro_torch.kernels.decode_attn import kernel as dk
    ref = run("ref")
    dk.SPLIT.launches = dk.MERGE.launches = 0
    kernels = run()
    launches = (dk.SPLIT.launches, dk.MERGE.launches)
    if launches[0] != 2 * cfg.n_layers:
        raise AssertionError(f"in-model: the decode kernel launched "
                             f"{launches[0]} times, expected "
                             f"{2 * cfg.n_layers}")
    print(f"in-model: decode launches over the 2 kernel steps: split "
          f"{launches[0]}, merge {launches[1]} [{card}]")
    reads = {"kernels": kernels,
             "control: one ulp": run("ref", one_ulp),
             "fault: segment 1 lost": run("ref", lost_segment),
             "fault: kv_len - 1": run("ref", short_kv_len)}
    rel = {name: max(float((lg - lr).norm() / lr.norm())
                     for lg, lr in zip(logits, ref))
           for name, logits in reads.items()}
    agree = {name: sum(int((lg.argmax(-1) == lr.argmax(-1)).sum())
                       for lg, lr in zip(logits, ref))
             for name, logits in reads.items()}
    tol = 2 * rel["control: one ulp"]
    print(f"in-model: {cfg.n_layers} layers, B={b}, positions "
          f"{pos.tolist()} and +1 (segments of {seg} rows, D={d}); "
          f"max over 2 steps of ||logits - logits_ref|| / ||logits_ref||: "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f"; limit {tol:.3e} (2x the one-ulp control); argmax agrees "
          "with ref on " + ", ".join(f"{k} {v}/{2 * b}"
                                      for k, v in agree.items())
          + f" rows [{card}]")
    for step, (lk, lr) in enumerate(zip(reads["kernels"], ref)):
        if not bool(torch.isfinite(lk).all()):
            raise AssertionError(f"in-model step {step}: non-finite logits")
        top2 = lr.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        dmax = (lk - lr).abs().amax(-1)
        same = lk.argmax(-1) == lr.argmax(-1)
        clear = margin > 2 * dmax
        print(f"in-model step {step}: argmax agrees on {int(same.sum())}/{b}"
              f" rows; {int(clear.sum())} rows have a ref top-2 margin above"
              f" 2 max|d| and must agree [{card}]")
        if not bool(same[clear].all()):
            raise AssertionError(f"in-model step {step}: argmax differs on a "
                                 "row whose margin rounding cannot close")
    if rel["kernels"] > tol:
        raise AssertionError(f"in-model: kernel logits disagree with ref "
                             f"(rel {rel['kernels']:.3e} > {tol:.3e})")
    if rel["fault: segment 1 lost"] <= tol:
        raise AssertionError("in-model: a lost decode segment stays inside "
                             "the limit, so the check cannot see it")


def phase_profile(card: str, model, params, engine, steps: int = 3) -> None:
    """Where a full-width decode step's time goes: wall time per step
    (host clock, synchronized, unprofiled), device time per step and the
    kernels that take it (torch.profiler), and the device's busy share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    rng = np.random.default_rng(4)
    b = SERVE_SLOTS
    pos = torch.as_tensor(rng.integers(16, 64, b), device="cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, 1)),
                           device="cuda")

    def run(n):
        for _ in range(n):
            model.decode_step(params, toks, engine.cache, pos)
        torch.cuda.synchronize()

    from repro_torch.kernels.decode_attn import kernel as dk
    with torch.inference_mode():
        run(2)
        dk.SPLIT.launches = dk.MERGE.launches = 0
        t0 = time.perf_counter()
        run(steps)
        wall = (time.perf_counter() - t0) / steps
        launches = (dk.SPLIT.launches, dk.MERGE.launches)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(steps)
    events = prof.key_averages()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side kernel events only: the CPU ops that launched them
    # (aten::mm, ...) report the same time again
    kernels = [e for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev(e) > 0]
    total_us = sum(dev(e) for e in kernels) / steps
    if launches[0] != cfg.n_layers * steps:
        raise AssertionError(f"profile: the decode kernel launched "
                             f"{launches[0]} times, expected "
                             f"{cfg.n_layers * steps}")
    print(f"profile: decode launches over {steps} timed steps: split "
          f"{launches[0]}, merge {launches[1]} [{card}]")
    if total_us <= 0:
        print(f"profile: decode step wall {wall * 1e3:.3f} ms; the profiler "
              f"recorded no device kernels [{card}]")
        return
    busy = total_us / 1e3 / (wall * 1e3)
    print(f"profile: decode step wall {wall * 1e3:.3f} ms, device kernels "
          f"{total_us / 1e3:.3f} ms ({100 * busy:.1f}% busy, "
          f"{100 - 100 * busy:.1f}% idle) over {steps} steps [{card}]")
    attn = [e for e in kernels if "decode_kernel" in e.key
            or "decode_merge" in e.key]
    attn_us = sum(dev(e) for e in attn) / steps
    print(f"profile: decode attention (decode_kernel + decode_merge) "
          f"{attn_us / 1e3:.4f} ms of device time a step in "
          f"{sum(e.count for e in attn) // steps} launches, "
          f"{100 * attn_us / total_us:.1f}% of the step's kernels; "
          f"positions in [16, 64) of a {SERVE_MAX_LEN}-row cache [{card}]")
    rms = [e for e in kernels if "rmsnorm_ms" in e.key]
    rms_us = sum(dev(e) for e in rms) / steps
    print(f"profile: rmsnorm {rms_us / 1e3:.4f} ms of device time a step in "
          f"{sum(e.count for e in rms) // steps} launches, "
          f"{100 * rms_us / total_us:.1f}% of the step's kernels [{card}]")
    for e in sorted(kernels, key=dev, reverse=True)[:12]:
        print(f"  {dev(e) / steps / 1e3:9.4f} ms/step "
              f"{100 * dev(e) / steps / total_us:5.1f}% "
              f"{e.count // steps:5d} calls/step  {e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import repro_torch ({exc}); run from the "
              "repository root", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {kind} x{count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi name, power.limit: {card}")

    phase_build(card)
    results: dict = {}
    check_rmsnorm(card, results)
    check_decode(card, results)
    phase_linalg(card, results)
    phase_stream(card, results)
    phase_stencil(card, results)
    check_adamw(card, results)
    check_k4_features(card, results)
    phase_registry(card, results)
    print(f"kernels checked in {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")

    model, params, engine, counts = phase_serve(card)
    phase_in_model(card, model, params, engine)
    phase_profile(card, model, params, engine)
    del model, params, engine          # free the serve weights and cache
    torch.cuda.empty_cache()
    train_counts = phase_train(card)
    # the K1 adamw kernel's launches are those of the training run; the
    # ring's, those of check_adamw's main path (training runs K1)
    results["adamw_update"]["launches"] = train_counts["adamw_update"]

    for name, entry in results.items():
        entry.setdefault("launches", counts[name])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in results.values()]}))
    print(f"total {time.perf_counter() - t_start:.1f} s [{card}]")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
