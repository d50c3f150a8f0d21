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
                the main path's shapes: rmsnorm at the decode rows (1, 4),
                the train rows (8192) and the prefill rows (16128) of
                4096, the families phase's rows (4096 of 2048, 16384 of
                2560 and of 5120, and 4 of each), the whisper phase's
                rows of 1024 (6000, 16, 4), 4 f32 rows of 12288 (a
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
                two runs' bits; chatglm3-6b's g=16; Phi-2's dh=80,
                Phi-3-mini's dh=96 and InternVL2-2B's g=2 at kv_len 17-64
                and uniform (B=4, S=4096), and Whisper-medium's g=1,
                dh=64 at kv_len 5-36 and uniform (B=4, S=448), against the
                plain version, SDPA and the bound
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
                f32) through its per-tensor op: the K1 kernel and the K4
                ring's adamw body at lookahead 1, 3, 4 (each ring's
                geometry); then the K1 kernel over the one-card train
                step's 39 leaves of Yi-9B in one launch
                (adamw_update_many, in place, the clip scale fused);
                equality with the plain version, lost-stream and
                lost-half controls, times against the bound and
                torch._fused_adamw_ (on the same lists)
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
  3h. resolve — config resolution on the card: with the tune cache at a
                temporary file, tune() mxv bf16 4096^2, decode attention at
                the serve shape (B=4, S=4096, Hkv=4, dh=128, Hq=32, bf16),
                stream_copy f32 [8192, 4096] and adamw_update [4096, 1024]
                (a "tune:" line per trial); re-tune (every result from the
                cache, no kernel launched); each op with config=None must
                resolve source="tuned" at the tuned config and hold its
                output against the plain version at the row's rtol / atol
                (rtol 2^-7 for a bf16 output: one rounding of its own);
                with the tuned config quarantined, resolution must skip it.
                Then every registry row at its default sizes with
                config=None and at the stream model's top-ranked and
                second-ranked configs, each against its plain version at
                the config the row resolved, at the row's rtol / atol
  3i. guard  — the static verifier, guarded dispatch and the JSONL sink:
                (a) tools/torch_speclint.py's sweep of every registry row
                with a traversal (default, aliased and bench sizes, f32
                and bf16, the conformance points and the planner's
                candidates) must find no error, each of the five fixtures
                must be flagged with its rule, and RES001's budget must
                equal the card's shared_memory_per_block_optin; the card's
                own failure messages (CUDA errors 1, 700, 701, 716, 719, a
                1 TiB allocation, the ring launcher's opt-in refusal) and
                the guard's class for each; (b) the registry phase, run
                under a MemoryCollector, must show no kernel.fallback and
                no error-severity analysis.violation; then the host us of
                a warm mxv_gen call with the gate and guard and with both
                bypassed, in turns; (c) with lower:mxv_gen:1 armed and a
                fresh tune cache, mxv_gen at 4096^2 f32 must land on one
                alt_config fallback within the dot limit of the plain
                version, quarantine the failed config, and the next call
                resolve quarantine_alt and launch the row-dot once, with
                loopir.evaluate made to raise throughout; (d) with
                lower:mxv_gen armed, the call must raise InjectedFault
                after three attempts; (e) (c) and (d) ran through a
                JsonlSink with sink_io:2 armed: the file's records by name
                must be the MemoryCollector's less the two dropped
  4. serve    — Yi-9B at full width (random weights from a seeded
                torch.Generator) serves 8 requests x 16 tokens through the
                continuous-batching engine; the launch counts, reset just
                before the run, must show every step went through both
                kernels; the (kernel, D, P, block_rows, source) each op
                resolved to with no config given
  5. in-model — two decode steps with the kernels and with mode="ref" on
                the same weights, tokens and a cache filled in every decode
                segment; logits must agree within 2x a one-ulp rounding
                control, a lost segment must fall outside it, and argmax
                must agree wherever rounding cannot close the top-2 margin
  6. profile  — where a full-width decode step's time goes (host wall
                time, device busy share, decode attention's device time
                and launches, top kernels by device time)
  6b. prefill — single-pass prefill on the serve phase's weights
                (``launch.steps.build_prefill_step``): (a) prefill_32k
                cut to B=4, S=4032 at max_len 4096 (97 rmsnorm launches,
                no decode launch), 8 decode steps from its cache (97
                rmsnorm, 48 decode_attn, 48 merge a step), and a
                64-token prompt's prefill against one teacher-forced
                decode step a token (the engine's path): last logits
                within 2x a one-ulp control, the greedy tokens; (b) the
                kernels against mode="ref": last logits and the worst
                cache row of every layer within 2x the control of every
                rmsnorm output one bf16 ulp off, with the last 64 rows
                of one norm's output lost landing above; (c) prefill_32k
                cut to B=1 (S=32768): the attention chunk and peak
                memory; (d) wall and device time, tokens/s, count_flops beside
                model_flops, roofline_terms(n_chips=1) and the share of
                the bound reached, and (a)'s time by kernel
  6c. sharded — sequence-sharded serving on the serve phase's weights:
                (a) the static split at Yi-9B's heads, B=4 x S=4096 at
                2, 4 and 8 shards and B=8 x S=32768 at 4, kv_len uniform
                and 17-64, against the unsharded kernel and mode="ref"
                (each slice read in place), K split + K merge launches a
                call, its time, each slice's and merge_partials' alone;
                (b) Yi-9B at full width and depth, the serve phase's first
                4 requests at ServeConfig(shards=4) on one card: launches
                a step (97 rmsnorm, 192 decode_attn, 192 merge), greedy
                tokens against shards=1, a teacher-forced step's logits
                within 2x a one-ulp control with one shard's lse dropped
                above it, step time and busy share of both; (c) 4 ranks
                as processes on this card over gloo, each holding its
                [B, S/4] slice: (c1) the collective op against the
                unsharded kernel, (c2) the engine over serving_ctx(4) at
                full width and 2 of 48 layers: every rank's tokens equal
                rank 0's and the one-process static split's, agreement
                with shards=1 printed
  6d. families — with the serve model freed, the MoE, SSM and VLM
                families at full width on random bf16 weights:
                Qwen3-MoE-30B-A3B (12 of 48 layers, prefill B=2 x 1024 at
                max_len 2048), Mamba2-2.7B (16 of 64 layers, B=2 x 4096)
                and InternVL2-2B (all 24 layers, 256 prefix
                embeds + 768 tokens, B=4, max_len 1040), each through
                launch.steps.build_prefill_step and 8 greedy decode steps
                from its cache: launches a prefill and a decode step,
                wall time, time between events, tokens/s, count_flops and
                its bound, the decode step's byte floor (a MoE layer's
                chosen experts only), peak memory, a torch.profiler
                breakdown of a prefill and of two decode steps; then
                against mode="ref": last logits and the worst cache or
                state row within 2x a one-ulp control, a lost-rows fault
                above it, 4 teacher-forced decode steps (greedy tokens,
                logits within 2x the step's control); Mamba2's serving
                invariant at B=1 on 4 of its 64 layers (prefill 1024 +
                one decode step against the full forward over 1025
                tokens, which runs the SSD in chunks of 1); (d) Jamba
                (one 8-layer period) and Arctic
                (dense residual) at reduced() dims, not a full-width
                path: prefill + 4 decode steps, launches, against
                mode="ref"
  6e. whisper — Whisper-medium at full width and depth on random bf16
                weights: B=4 clips of 1500 frames, the 4-token
                start-of-transcript prompt, max_len 448: the encoder
                alone, a prefill (122 rmsnorm launches) and 32 greedy
                decode steps (73 rmsnorm, 24 decode_attn, 24 merge a
                step), timed and profiled, against the prefill's compute
                bound and the step's byte floor; then against mode="ref"
                (logits, the worst self-cache and cross K/V rows within
                2x the one-ulp control, 64 lost rows of the encoder's
                output norm above it), 4 teacher-forced steps, and the
                serving invariant at B=1 (64 tokens + one step)
  6f. train-families — Whisper-medium (B=2 x 448 on 1500 frames),
                Mamba2-2.7B (8 of 64 layers, B=2 x 4096), InternVL2-2B
                (12 of 24 layers, B=2 x (256 + 4096)) and Qwen3-MoE-30B-A3B
                (2 of 48 layers, B=2 x 4096)
                at full width through launch.steps.build_train_step:
                three steps each (launches, wall, tokens/s, loss, grad
                norm, the third profiled: busy share, peak memory), then
                step 0 again from the same seed with mode="ref" and with
                a one-ulp control (every norm output of a call moved one
                way): loss, grad norm and sampled updates within 2x it
  7. train    — with the serve model freed: Yi-9B at full width, 4 of 48
                layers, f32 params and bf16 compute, trains 6 steps of
                seq 4096 x batch 2 through the launcher's path; every
                step must launch rmsnorm 17 times and adamw_update once
                (its 39 f32 leaves in one launch), step 0's loss lie in
                [11, 12]; then a bit-equal
                checkpoint round trip of the state, one step with the
                kernels against one with mode="ref" from the same state
                (with a lost-stream control), and where a step's time
                goes (torch.profiler); the configs step 0's ops resolved
                to
  7b. train_sharded — training across ranks, every rank a gloo process
                on this card: (a) Yi-9B at full width, 2 of 48 layers,
                ZeRO-3 over data=2, 3 steps of 2 x 4096 (9 rmsnorm, 1
                adamw_update launches a rank a step), each step's loss
                and grad norm and the params after 2 steps within 2x a
                one-ulp control (the one-process step with every norm
                output moved one ulp) of the one-process step; (c) the
                checkpoint (a) saved after 2 steps restored by
                remesh_state onto one rank and run one step; (d) in
                (a)'s two processes, Yi-9B tensor-parallel over model=2
                (Megatron heads and FFN, vocab-parallel embedding, head
                and loss, the layer boundaries on 2048 rows a rank): 3
                steps held against the same one-process step and
                control, 9 rmsnorm and 1 adamw_update launches a rank a
                step, the wire bytes equal to the ring model of the
                layout; (e) in the same processes, Qwen3-MoE-30B-A3B
                expert-parallel over model=2 (full width, 2 of 48
                layers, 2 x 4096: 64 experts a rank, capacity buffers
                [128, 320, 2048] exchanged by all_to_all), 2 steps held
                against the one-process step under the same capacity
                rule and its one-ulp control, launches and wire the
                same way; (f) StarCoder2-7B over model=8 (full width, 2
                of 32 layers, 1 x 1024, 8 gloo ranks, f32 compute), its
                36 heads on the sequence-sharded attention (128 query
                rows a rank), 3 steps held the same way; (b) InternVL2-2B at full
                width, 2 layers, the int8
                error-feedback compressed step at pod=2 x data=2: every
                synced gradient element within the two hops' rounding of
                the exact pod mean, step 0's loss equal to the
                uncompressed sharded step's, step 0's grad norm and step
                1's loss and grad norm within twice a one-quantum
                control's distance from it, the int8 wire bytes counted
                against the shards' and wire_bytes; adamw_update at
                Yi-9B's shard shapes (data=2, 4) against its plain
                version, timed, and adamw_update_many over (a)'s rank's
                21 leaves in one launch, timed against the bound and
                torch._fused_adamw_ on the same lists
  8. report   — a JSON line of kernels, the card's name and power limit, and
                as the last line {"ok": true, "device": {...}}

Phases 4-7b print their seconds ("phase <name>: N s").

Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))



def _hw():
    """The card's constants (``repro_torch.roofline.hw.H100_HW``), loaded
    from this checkout's file by path: a tool that imports this script
    to time another checkout keeps that checkout's ``repro_torch``.
    None where the file is missing (a copy of this script alone)."""
    import importlib.util
    path = os.path.join(ROOT, "src", "repro_torch", "roofline", "hw.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("_chip_smoke_hw", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod       # dataclasses resolve it by name
    spec.loader.exec_module(mod)
    return mod.H100_HW


_H100 = _hw()
# H100 SXM device memory; dense peaks by operand type (f32 outside the
# tensor cores; bf16 and f16 on the tensor cores, products exact in their
# f32 sums)
HBM_BYTES_PER_S = _H100.hbm_bw if _H100 else None
PEAK_FLOPS = dict(_H100.peak_flops) if _H100 else {}

SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW, SERVE_REQUESTS = 4, 4096, 16, 8
# prefill_32k cut to the serve phase's cache: B=4 prompts of 4032 tokens
PREFILL_B, PREFILL_S = 4, 4032
# the whisper phase: B=4 clips of 1500 frames, the decoder prompt of
# Whisper's start-of-transcript sequence (<|startoftranscript|> <|en|>
# <|transcribe|> <|notimestamps|>), its 448-position text context, and
# greedy decode steps
WHISPER_B, WHISPER_FRAMES = 4, 1500
WHISPER_PROMPT = (50258, 50259, 50359, 50363)
WHISPER_MAX_LEN, WHISPER_DECODE = 448, 32


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
                 (PREFILL_B * PREFILL_S, 4096, "bfloat16"),
                 (SERVE_SLOTS, 12288, "float32"), (8, 1001, "bfloat16"),
                 (8, 1001, "float32"), (3, 4098, "bfloat16"),
                 (3, 4098, "float32"),
                 # the families phase's rows: Qwen3-MoE's and InternVL2's
                 # 2048 (a prefill of 4 x 1024 positions), Mamba2's block
                 # norms at 2560 and gated norm at d_inner 5120 (4 x 4096),
                 # and the decode rows of each
                 (4096, 2048, "bfloat16"), (16384, 2560, "bfloat16"),
                 (16384, 5120, "bfloat16"), (SERVE_SLOTS, 2048, "bfloat16"),
                 (SERVE_SLOTS, 2560, "bfloat16"),
                 (SERVE_SLOTS, 5120, "bfloat16"),
                 # the whisper phase's rows of 1024: the encoder's 4 x 1500
                 # frames, the decoder prompt's 4 x 4 tokens, a decode step
                 (WHISPER_B * WHISPER_FRAMES, 1024, "bfloat16"),
                 (WHISPER_B * len(WHISPER_PROMPT), 1024, "bfloat16"),
                 (WHISPER_B, 1024, "bfloat16"))
RMSNORM_SWEEP_CLUSTERS = (1, 2, 4, 8)     # at the decode rows
RMSNORM_SWEEP_ITEMS = (1, 2, 4, 16)       # items a block at 8192 rows


def check_rmsnorm(card: str, results: dict) -> None:
    """rmsnorm at the serve path's decode rows (1 and 4 of Yi-9B's 4096,
    bf16), the train step's 8192 rows (bf16, and f32), the prefill
    phase's 16128 rows (bf16) and 4 f32 rows of 12288: each launch's
    geometry, the kernel against its plain version (o within one ulp of
    its dtype, r within 1e-5) with a control that
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
        cfg = common.resolve_for("rmsnorm", x, None, t, rops._DEFAULT)
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
# (model, Hkv, Hq, dh, S, the profile kind's kv_len range): head dims of
# public models other than 2^k x 16, InternVL2-2B's group g = 2 (the
# families phase's), and Whisper-medium's self-attention (g = 1, dh 64)
# at its 448-position text context, kv_len that of the whisper phase's
# decode steps (prompt 4 + 32 steps)
DECODE_HEAD_DIMS = (("phi-2", 32, 32, 80, SERVE_MAX_LEN, (17, 64)),
                    ("phi-3-mini", 32, 32, 96, SERVE_MAX_LEN, (17, 64)),
                    ("internvl2-2b", 8, 16, 128, SERVE_MAX_LEN, (17, 64)),
                    ("whisper-medium", 16, 16, 64, WHISPER_MAX_LEN,
                     (len(WHISPER_PROMPT) + 1,
                      len(WHISPER_PROMPT) + WHISPER_DECODE)))


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
        cfg = common.effective_config(dops._DEFAULT, s, dops._DEFAULT)
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
    cfg = common.effective_config(dops._DEFAULT, s, dops._DEFAULT)
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
    # phase's kv_len 17-64 and kv_len uniform on [1, S], B=4, S=4096;
    # InternVL2-2B's g = 2 there, and Whisper-medium's g = 1, dh = 64 at
    # S = 448, kv_len 5-36 and uniform
    for model, hkv_d, hq_d, dh_d, s, prof in DECODE_HEAD_DIMS:
        build_d = dspecs.decode_spec(hkv_d, dh_d, masked=True)
        cfg = common.effective_config(dops._DEFAULT, s, dops._DEFAULT)
        for kind in ("profile", "uniform"):
            lo, hi = (prof[0], prof[1] + 1) if kind == "profile" else (
                1, s + 1)
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
            print(f"decode_attn dh={dh_d} g={hq_d // hkv_d} ({model}) B={b} "
                  f"S={s} Hkv={hkv_d} "
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
    # the kernels at the ops' static default, whose geometry and controls
    # this phase prints (with none given, the ops plan theirs: see the
    # resolve, serve and train phases)
    mxv, mxv_t, bicg, gemver, gemver_outer = (
        functools.partial(f, config=MXV_DEFAULT)
        for f in (mxv, mxv_t, bicg, gemver, gemver_outer))
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
    from repro_torch.kernels.mxv.ops import _DEFAULT as MXV_DEFAULT
    # at the ops' static default (see phase_linalg)
    mxv, gemver_outer = (functools.partial(f, config=MXV_DEFAULT)
                         for f in (mxv, gemver_outer))
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
    # the kernels at the ops' static default (see phase_linalg)
    stream_copy, stream_read, stream_init = (
        functools.partial(f, config=_DEFAULT)
        for f in (stream_copy, stream_read, stream_init))
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
    # each K1 launch's geometry on the flat walk: blocks, blocks an SM,
    # waves, registers
    bp_k1 = plan_blocks(ss.copy_spec(inputs["float32"]["x"]), _DEFAULT)
    for dt_name in STREAM_DTYPES:
        dt = getattr(torch, dt_name)
        g = sk.k1_geometry(bp_k1, torch.empty((), dtype=dt).element_size())
        for name in ("stream_copy", "stream_triad", "stream_init"):
            per_sm = sk.k1_occupancy(name, dt, g.threads)
            inst = (name if name == "stream_copy"
                    else f"{name}<{_CTYPES[dt_name]}>")
            print(f"{name} {dt_name} launch: D={d}, P={g.units} (bm "
                  f"{bp_k1.bm} unused), {g.blocks} blocks of {g.threads} "
                  f"threads ({g.steps} steps of {g.units} x "
                  f"{cuda.WALK_UNIT} 16-byte vectors of {g.vec} elements of "
                  f"each of {d} segments of {g.segv} vectors), {per_sm} "
                  f"blocks an SM, {g.blocks / (per_sm * sms):.2f} waves; "
                  f"ptxas {inst} [registers, spill bytes]: {_regs(inst)} "
                  f"[{card}]")

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
    # doitgen at its static default (see phase_linalg); the stencils'
    # wrappers pass no Traffic, so theirs resolve to it
    doitgen = functools.partial(doitgen, config=D_DEFAULT)
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
TRAIN_LAYERS = 4
TRAIN_ARGS = ["--arch", "yi-9b", "--no-reduced", "--layers",
              str(TRAIN_LAYERS), "--seq", "4096", "--batch", "2", "--steps", "50",
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
            key = {"ring_la3": "manual_ring_adamw"}.get(c)
            if key and size == "embed":
                results[key] = dict(
                    name=key, route="cuda",
                    source="src/repro_torch/csrc/manual_ring.cu",
                    replaces="src/repro/codegen/emit.py:708",
                    launches=counts[key], ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib,
                    max_abs_err=errs[c],
                    shape=f"p, g, m, v [{shape[0]}, {shape[1]}] f32 "
                          f"(D=2, P=2, lookahead {cfg.lookahead})")
    del inputs, outs
    torch.cuda.empty_cache()
    _adamw_list(card, "adamw list", _yi9b_leaves(TRAIN_LAYERS), gen,
                results)


def _yi9b_leaves(layers: int, data: int = 1) -> dict:
    """``{name: shape}`` of Yi-9B's trainable leaves at full width and
    ``layers`` layers as rank 0 of ZeRO-3 over ``data`` ranks holds them
    (its shard where the sharding rules cut a leaf over data)."""
    from repro_torch.models.lm import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.layout import shard_of

    class Stub:
        axis_names = ("data", "model")

        def __init__(self, d):
            self.shape = {"data": d, "model": 1}
    cfg = _ts_cfg("yi-9b", layers)
    meta = dict(build_model(cfg).init(device="meta",
                                      trainable=True).named_parameters())
    specs = rules.param_specs(meta, cfg, Stub(data))
    return {k: shard_of(tuple(p.shape), specs[k], Stub(data),
                        {"data": 0, "model": 0}).local_shape
            for k, p in meta.items()}


def _adamw_list(card: str, tag: str, leaves: dict, gen,
                results: dict | None = None) -> None:
    """``adamw_update_many`` over the f32 leaves ``leaves`` (p, g, m, v
    drawn on the card) as the optimizer runs it: each leaf's weight decay
    by the JAX rule (``optimizer.decays``; the bench wd or 0), the clip
    scale 0.5 fused, D=2, P=2.  One launch a table of leaves (counted,
    the counts set to 0 just before).  p, m and v against the plain
    version on copies (|d| = 0); controls: the plain p' of the largest
    leaf with its second half left at p, and with the clip scale left
    out, must differ.  Times: the kernel, the plain version, the
    per-tensor op over the same leaves after a separate g * scale pass
    (how the optimizer ran each leaf before the list launch),
    torch._fused_adamw_ over the same lists (the library yardstick: one
    weight decay, no clip) and the bound (28 bytes an element).  Its
    ``results`` entry is the main path's ``adamw_update`` row."""
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.adamw import _HYPER
    from repro_torch.kernels.adamw import kernel as akernel
    from repro_torch.kernels.adamw import ops as aops
    from repro_torch.train import optimizer as topt
    names = list(leaves)
    ps, gs, ms = ([torch.randn(*leaves[k], generator=gen, device="cuda")
                   for k in names] for _ in range(3))
    vs = [torch.rand(*leaves[k], generator=gen, device="cuda")
          for k in names]
    n = sum(p.numel() for p in ps)
    wds = [_HYPER["wd"] if topt.decays(k, p) else 0.0
           for k, p in zip(names, ps)]
    s7 = torch.stack(aops.scalars(torch.device("cuda"), *_HYPER.values()))
    scale = torch.tensor(0.5, device="cuda")
    big = max(range(len(ps)), key=lambda i: ps[i].numel())
    x_big = [t[big].clone() for t in (ps, ms, vs)]
    ref = [[t.clone() for t in x] for x in (ps, ms, vs)]
    for k in cuda.KERNELS.values():
        k.launches = 0
    aops.adamw_update_many(ps, gs, ms, vs, wds, s7, gscale=scale)
    torch.cuda.synchronize()
    counts = {k: v.launches for k, v in cuda.KERNELS.items() if v.launches}
    tables = -(-len(ps) // akernel.TABLE_MAX)
    if counts != {"adamw_update": tables}:
        raise AssertionError(f"{tag}: launches {counts}, expected "
                             f"{tables} adamw_update")
    aops.adamw_update_many(ref[0], gs, ref[1], ref[2], wds, s7,
                           gscale=scale, mode="ref")
    unscaled = x_big[0].clone()
    aops.adamw_update_many([unscaled], [gs[big]], x_big[1:2], x_big[2:],
                           [wds[big]], s7, mode="ref")
    err = max(float((a - b).abs().max()) for a, b in
              zip(ps + ms + vs, ref[0] + ref[1] + ref[2]))
    half = ref[0][big].clone().view(-1)
    half[half.numel() // 2:] = x_big[0].view(-1)[half.numel() // 2:]
    ctl = {"half of the largest leaf lost": half.view(ps[big].shape),
           "clip scale left out": unscaled}
    seen = {c: float((ps[big] - t).abs().max()) for c, t in ctl.items()}
    print(f"{tag}: {len(ps)} f32 leaves, {n / 1e9:.3f}B elements, "
          f"{tables} launch(es) {json.dumps(counts)}; p, m, v against the "
          f"plain version max_abs_err={err:g} (tolerance 0); controls "
          f"(|d| of p' of {names[big]} {list(ps[big].shape)}) "
          f"{json.dumps(seen)} [{card}]")
    if err != 0 or min(seen.values()) == 0:
        raise AssertionError(f"{tag}: kernel against plain {err}, "
                             f"controls {seen}")
    del ref, half, unscaled, ctl, x_big
    torch.cuda.empty_cache()
    args = (ps, gs, ms, vs)
    ms_k = eager_ms(lambda *a: aops.adamw_update_many(*a, wds, s7,
                                                      gscale=scale), args)
    t0 = time.perf_counter()
    for _ in range(3):
        aops.adamw_update_many(*args, wds, s7, gscale=scale)
    host = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    plain = eager_ms(lambda *a: aops.adamw_update_many(
        *a, wds, s7, gscale=scale, mode="ref"), args, reps=1)
    one = dict(zip(_HYPER, s7.unbind()))

    def per_tensor(ps, gs, ms, vs):
        for p, g, m, v, wd in zip(ps, gs, ms, vs, wds):
            aops.adamw_update(p, g.float() * scale, m, v,
                              **dict(one, wd=wd))
    loop = eager_ms(per_tensor, args)
    steps = [torch.ones((), device="cuda") for _ in ps]
    lib = eager_ms(lambda *a: torch._fused_adamw_(
        *a, [], steps, lr=_HYPER["lr"], beta1=0.9, beta2=0.999,
        weight_decay=_HYPER["wd"], eps=_HYPER["eps"], amsgrad=False,
        maximize=False), args)
    bms, by = bound_ms(28 * n, ADAMW_FLOPS * n, "float32")
    print(f"{tag}: ms={ms_k:.5f} plain_ms={plain:.5f} bound_ms={bms:.6f} "
          f"({by}, {100 * bms / ms_k:.1f}% of it reached) library_ms="
          f"{lib:.5f} (torch._fused_adamw_ over the same lists); the "
          f"per-tensor op with a separate g * scale pass over the same "
          f"leaves {loop:.5f} ms; host dispatch of the list call "
          f"{host * 1e3:.3f} ms; {n * 28 / ms_k / 1e6:.0f} GB/s [{card}]")
    if results is not None:
        results["adamw_update"] = dict(
            name="adamw_update", route="cuda",
            source="src/repro_torch/csrc/adamw.cu",
            replaces="src/repro/codegen/emit.py:410", ms=ms_k,
            plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
            max_abs_err=err,
            shape=f"{len(ps)} leaves of Yi-9B ({TRAIN_LAYERS} layers) f32, "
                  f"{n} elements in one launch, clip scale fused (D=2, "
                  f"P=2)")
    del ps, gs, ms, vs, args
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

RESOLVE_TUNE = (("mxv", {"m": 4096, "n": 4096}, "bfloat16"),
                ("decode_attn", {"b": SERVE_SLOTS, "s": SERVE_MAX_LEN,
                                 "hq": 32, "hkv": 4, "dh": 128}, "bfloat16"),
                ("stream_copy", {"rows": 8192, "cols": 4096}, "float32"),
                ("adamw_update", {"rows": 4096, "cols": 1024}, "float32"))


def _resolved(events) -> list:
    """Sorted distinct (kernel, D, P, block_rows, source) of a run's
    ``kernel.resolve`` events."""
    return sorted({(e.attrs["kernel"], e.attrs["d"], e.attrs["p"],
                    e.attrs["block_rows"], e.attrs["source"])
                   for e in events})


def _row_tolerance(row, dtype: str) -> tuple[float, float]:
    """A registry row's (rtol, atol), stated for f32; a 16-bit output
    may differ from the plain version's by one rounding of its own, so
    its rtol widens to 2^-7 (one bf16 ulp relative)."""
    if dtype in ("bfloat16", "float16"):
        return max(row.rtol, 2.0 ** -7), row.atol
    return row.rtol, row.atol


def _tol_excess(got, want, rtol, atol) -> float:
    """Worst |got - want| over atol + rtol |want| across the outputs."""
    worst = -math.inf
    for g, w in zip(_leaves(got), _leaves(want)):
        if g.shape != w.shape:
            return math.inf
        worst = max(worst, float(((g.float() - w.float()).abs()
                                  - (atol + rtol * w.float().abs())).max()))
    return worst


def _no_fallback(col, what: str) -> None:
    """Fail when ``col`` (a MemoryCollector) holds a ``kernel.fallback``:
    a config asked for by name, or the one resolution chose, failed and
    another config served the call."""
    evs = col.named("kernel.fallback")
    if evs:
        raise AssertionError(f"{what}: the config failed and another "
                             f"served the call: {[e.attrs for e in evs]}")


def phase_resolve(card: str) -> None:
    """Config resolution on the card (see the module doc, 3h): tune,
    re-tune from the cache, resolve the tuned config, skip it once
    quarantined; then every registry row at its top two planned
    configs.  The tune cache is a temporary file, dropped at the end."""
    import torch
    from repro_torch import obs, registry
    from repro_torch.core.planner import rank_configs
    from repro_torch.core.striding import StridingConfig
    from repro_torch.kernels import common, cuda
    from repro_torch.registry import autotune, tunecache
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(prefix="repro_torch_tune_")
    prev = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(tmp, "tune.json")
    tunecache.reset_default_cache()
    common.reset_plan_memo()
    try:
        cache = tunecache.default_cache()
        tuned = {}
        for name, sizes, dt in RESOLVE_TUNE:
            t0 = time.perf_counter()
            res = registry.tune(name, sizes, getattr(torch, dt), device=dev)
            if res.from_cache or not res.trials:
                raise AssertionError(f"resolve: tune {name} measured "
                                     f"nothing ({res})")
            for c, sec in res.trials:
                print(f"tune: {name} {dt} {sizes} D={c.stride_unroll} "
                      f"P={c.portion_unroll} block_rows={c.block_rows}: "
                      f"{sec * 1e3:.5f} ms"
                      + (" (best)" if c == res.config else "")
                      + f" [{card}]")
            print(f"tune: {name} {dt} {sizes}: {len(res.trials)} trials in "
                  f"{time.perf_counter() - t0:.1f} s, best D="
                  f"{res.config.stride_unroll} P={res.config.portion_unroll}"
                  f" block_rows={res.config.block_rows}, key {res.key} "
                  f"[{card}]")
            tuned[name] = res
        before = {n: k.launches for n, k in cuda.KERNELS.items()}
        for name, sizes, dt in RESOLVE_TUNE:
            res = registry.tune(name, sizes, getattr(torch, dt), device=dev)
            if not res.from_cache or res.config != tuned[name].config:
                raise AssertionError(f"resolve: re-tune of {name} was not "
                                     f"a cache hit of the tuned config "
                                     f"({res})")
        after = {n: k.launches for n, k in cuda.KERNELS.items()}
        if after != before:
            raise AssertionError(f"resolve: the re-tune launched kernels "
                                 f"{ {n: after[n] - before[n] for n in after if after[n] != before[n]} }")
        print(f"resolve: re-tune of {len(RESOLVE_TUNE)} rows all from the "
              f"cache, no kernel launched [{card}]")
        for name, sizes, dt in RESOLVE_TUNE:
            row, want_cfg = registry.get(name), tuned[name].config
            inputs = row.make_inputs(dict(sizes), getattr(torch, dt), dev)
            with obs.collect() as col:
                got = row.run(inputs, None, None)
            _no_fallback(col, f"resolve: {name} at its tuned config")
            ev = col.named("kernel.resolve")[0].attrs
            cfg = (ev["d"], ev["p"], ev["block_rows"])
            if ev["source"] != "tuned" or cfg != (
                    want_cfg.stride_unroll, want_cfg.portion_unroll,
                    want_cfg.block_rows):
                raise AssertionError(f"resolve: {name} resolved {ev}, not "
                                     f"the tuned {want_cfg}")
            excess = _tol_excess(got, row.run(inputs, want_cfg, "ref"),
                                 *_row_tolerance(row, dt))
            if not excess <= 0:
                raise AssertionError(f"resolve: {name} at its tuned config "
                                     f"is over rtol / atol by {excess:g}")
            key = tunecache.cache_key(name, autotune._shape(row, sizes),
                                      getattr(torch, dt), dev, "cuda")
            cache.quarantine(key, want_cfg, "smoke")
            with obs.collect() as col:
                row.run(inputs, None, None)
            _no_fallback(col, f"resolve: {name} past its quarantined "
                         "config")
            ev2 = col.named("kernel.resolve")[0].attrs
            if (ev2["source"] == "tuned" or (ev2["d"], ev2["p"],
                                             ev2["block_rows"]) == cfg):
                raise AssertionError(f"resolve: {name} resolved its "
                                     f"quarantined config again ({ev2})")
            print(f"resolve: {name} {dt} config=None -> source=tuned D="
                  f"{cfg[0]} P={cfg[1]} block_rows={cfg[2]}, worst excess "
                  f"over rtol / atol {excess:.3g}; quarantined -> source="
                  f"{ev2['source']} D={ev2['d']} P={ev2['p']} block_rows="
                  f"{ev2['block_rows']} [{card}]")
            del inputs, got
        torch.cuda.empty_cache()

        # every row with config=None and at its two top-ranked configs,
        # small shapes
        failures, n_runs = [], 0
        for row in registry.all_specs():
            sizes = dict(row.default_sizes)
            trav = (row.traversal(sizes, torch.float32)
                    if row.traversal else None)
            ranked = [c for c, _, _ in rank_configs(
                row.traffic(sizes, torch.float32), spec=trav)][:2]
            inputs = row.make_inputs(sizes, torch.float32, dev)
            line = []
            for label, cfg in [("none", None), *zip(("top", "second"),
                                                    ranked)]:
                with obs.collect() as col:
                    out = row.run(inputs, cfg, None)
                _no_fallback(col, f"resolve: {row.name} {label}")
                ev = col.named("kernel.resolve")[0].attrs
                ran = StridingConfig(ev["d"], ev["p"],
                                     block_rows=ev["block_rows"])
                excess = _tol_excess(out, row.run(inputs, ran, "ref"),
                                     *_row_tolerance(row, "float32"))
                n_runs += 1
                line.append(f"{label} D={ran.stride_unroll} "
                            f"P={ran.portion_unroll} bm={ran.block_rows} "
                            f"({ev['source']}) excess {excess:.3g}")
                if not excess <= 0:
                    failures.append(f"{row.name} {label} {ran}: {excess:g}")
                del out
            print(f"resolve: {row.name} {sizes}: " + "; ".join(line)
                  + f" [{card}]")
            del inputs
        if failures:
            raise AssertionError("resolve: planned configs disagree with "
                                 "the plain versions: " + "; ".join(failures))
        print(f"resolve: {n_runs} planned-config runs agree; phase took "
              f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    finally:
        if prev is None:
            os.environ.pop("REPRO_TORCH_TUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_TUNE_CACHE"] = prev
        tunecache.reset_default_cache()
        common.reset_plan_memo()
        shutil.rmtree(tmp, ignore_errors=True)


GUARD_N = 4096                 # mxv_gen's bench size, f32: parts (c)-(e)
GUARD_CALLS = 200              # warm calls a turn of the gate's host time


class _Tee:
    """A collector that records into a MemoryCollector and a JsonlSink
    (part (e): the sink's file against the memory's events)."""

    def __init__(self, mem, sink):
        self.mem, self.sink = mem, sink

    def record(self, ev) -> None:
        self.mem.record(ev)
        self.sink.record(ev)

    def close(self) -> None:
        self.sink.close()


def _bypass_gate():
    """Context manager: ``make_kernel_op`` ops run with the static gate
    and the guard replaced by direct calls (the host cost they add)."""
    import contextlib
    from repro_torch.codegen import emit
    from repro_torch.kernels import common

    @contextlib.contextmanager
    def bypass():
        gate, guard = emit.gate, common.guarded_run
        emit.gate = lambda *a, **k: None
        common.guarded_run = (lambda kernel, run, cfg, mode, **kw:
                              run(cfg, mode))
        try:
            yield
        finally:
            emit.gate, common.guarded_run = gate, guard
    return bypass()


def _host_us(call, n: int = GUARD_CALLS) -> float:
    """Median host microseconds of one ``call()`` over ``n`` calls: the
    enqueue, which the card keeps up with (an op whose kernel takes less
    device time than its call takes on the host)."""
    import torch
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    ts.sort()
    return ts[len(ts) // 2] * 1e6


def phase_guard(card: str, registry_events) -> None:
    """The static verifier, guarded dispatch and the JSONL sink on the
    card (see the module doc, 3i).  ``registry_events`` is the
    MemoryCollector phase_registry ran under."""
    import importlib.util
    import torch
    from repro_torch import obs
    from repro_torch.analysis import checker, fixtures
    from repro_torch.codegen import loopir
    from repro_torch.codegen.transforms import plan_blocks
    from repro_torch.kernels import common, cuda, manual
    from repro_torch.kernels import gen as tgen
    from repro_torch.kernels.mxv import kernel as mk
    from repro_torch.registry import tunecache
    from repro_torch.runtime import faults
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)

    # (a) the checker over every registry point, the fixtures, the budget
    spec = importlib.util.spec_from_file_location(
        "torch_speclint", os.path.join(ROOT, "tools", "torch_speclint.py"))
    speclint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(speclint)
    report = speclint.sweep()
    print(f"guard (a): checker over {len(report['kernels'])} registry rows "
          f"x default, aliased and bench sizes x f32, bf16: "
          f"{report['configs']} configs (the conformance points and the "
          f"planner's candidates), {report['findings']} findings, "
          f"{report['errors']} errors [{card}]")
    if report["errors"]:
        raise AssertionError("guard: the checker rejects a registry point")
    for name in ("race", "redsplit", "halo", "smem", "reassoc"):
        fx = speclint.run_fixture(name)
        if not fx["flagged"]:
            raise AssertionError(f"guard: fixture {name} not flagged")
        print(f"guard (a): fixture {name}: {fx['expected_rule']} flagged "
              f"({', '.join(sorted({f['rule'] for f in fx['findings']}))})"
              f" [{card}]")
    optin = props.shared_memory_per_block_optin
    print(f"guard (a): RES001 budget {checker.SMEM_BUDGET} B, the card's "
          f"shared_memory_per_block_optin {optin} B [{card}]")
    if checker.SMEM_BUDGET != optin:
        raise AssertionError("guard: RES001's budget is not the card's "
                             "opt-in")
    fx = fixtures.build("smem")
    try:
        manual.ring_plan(fx.spec.name, torch.float32,
                         plan_blocks(fx.spec, fx.config), fx.config,
                         props.multi_processor_count, optin,
                         props.shared_memory_per_multiprocessor)
        raise AssertionError("guard: the ring launcher takes the smem "
                             "fixture")
    except ValueError as exc:
        ring_msg = str(exc)
    print(f"guard (a): the ring's launcher refuses the smem fixture: "
          f"{ring_msg} [{card}]")

    # the card's own failure messages and their classes
    lib = cuda.library("reduction")
    msgs = {code: lib.repro_cuda_error_string(code).decode()
            for code in (1, 700, 701, 716, 719)}
    try:
        torch.empty(1 << 40, dtype=torch.uint8, device=dev)
        raise AssertionError("guard: a 1 TiB allocation succeeded")
    except torch.OutOfMemoryError as exc:
        oom = exc
    torch.cuda.empty_cache()
    cases = [(f"launch {c}", cuda.LaunchError(
        f"rowdot: launch failed with CUDA error {c} ({m})", c))
        for c, m in msgs.items()]
    cases += [("torch OOM", oom), ("ring opt-in", ValueError(ring_msg))]
    want = {"launch 1": ("backend", False), "launch 700": ("backend", True),
            "launch 701": ("resource", False),
            "launch 716": ("backend", True), "launch 719": ("backend", True),
            "torch OOM": ("resource", True),
            "ring opt-in": ("resource", False)}
    for label, exc in cases:
        got = (common.classify_failure(exc), common.unrecoverable(exc))
        text = str(exc).splitlines()[0]
        print(f"guard (a): {label}: {text!r} -> class {got[0]}, "
              f"unrecoverable {got[1]} [{card}]")
        if got != want[label]:
            raise AssertionError(f"guard: {label} classified {got}, "
                                 f"expected {want[label]}")

    # (b) no fallback on the main path
    fallbacks = registry_events.counter_value("kernel.fallback.count")
    errors = [e for e in registry_events.named("analysis.violation")
              if e.attrs["severity"] == "error"]
    print(f"guard (b): registry phase: {len(registry_events.events)} "
          f"events, {len(registry_events.named('analysis.pass'))} "
          f"analysis.pass, {len(errors)} error violations, "
          f"kernel.fallback.count {fallbacks:g} [{card}]")
    if fallbacks or errors or not registry_events.named("analysis.pass"):
        raise AssertionError("guard: the registry phase fell back or the "
                             "checker rejected a main-path launch")

    n = GUARD_N
    gen = torch.Generator(device=dev).manual_seed(25)
    a = torch.randn(n, n, generator=gen, device=dev)
    x = torch.randn(n, generator=gen, device=dev)
    want_y = tgen.mxv_gen(a, x, mode="ref")
    limit = _dot_limit(a.abs() @ x.abs(), want_y, n)

    # the gate's host cost on a warm call, in turns after one untimed
    host = {"gate": [], "bypassed": []}
    _host_us(lambda: tgen.mxv_gen(a, x))
    for which in ("gate", "bypassed", "bypassed", "gate"):
        if which == "gate":
            host[which].append(_host_us(lambda: tgen.mxv_gen(a, x)))
        else:
            with _bypass_gate():
                host[which].append(_host_us(lambda: tgen.mxv_gen(a, x)))
    print(f"guard: host us of one warm mxv_gen call [{n}, {n}] f32, median "
          f"of {GUARD_CALLS} calls a turn: with the gate and guard "
          f"{host['gate'][0]:.2f}, {host['gate'][1]:.2f}; bypassed "
          f"{host['bypassed'][0]:.2f}, {host['bypassed'][1]:.2f} [{card}]")

    tmp = tempfile.mkdtemp(prefix="repro_torch_guard_")
    prev = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(tmp, "tune.json")
    tunecache.reset_default_cache()
    common.reset_plan_memo()
    evaluate = loopir.evaluate

    def plain(*args, **kw):
        raise AssertionError("guard: a tier ran the plain version")
    mem = obs.MemoryCollector()
    sink = obs.JsonlSink(os.path.join(tmp, "obs.jsonl"))
    loopir.evaluate = plain
    obs.install(_Tee(mem, sink))
    try:
        # (c) one fallback
        cache = tunecache.default_cache()
        qkey = tunecache.cache_key("mxv_gen", a.shape, a.dtype, dev, "cuda")
        before = mk.ROWDOT.launches
        start = len(mem.events)
        with faults.inject("sink_io::2,lower:mxv_gen:1"):
            got = tgen.mxv_gen(a, x)
        torch.cuda.synchronize()
        evs = [e for e in mem.events[start:] if e.name == "kernel.fallback"]
        excess = _excess(got, want_y, limit)
        if len(evs) != 1 or evs[0].attrs["tier"] != "alt_config":
            raise AssertionError(f"guard (c): fallback events {evs}")
        ev = evs[0].attrs
        q = cache.quarantined(qkey)
        failed = (ev["failed_d"], ev["failed_p"], ev["failed_block_rows"])
        if [(r["d"], r["p"], r["block_rows"]) for r in q.values()] != [
                failed] or not excess <= 0:
            raise AssertionError(f"guard (c): quarantine {q}, excess "
                                 f"{excess:g}")
        print(f"guard (c): lower:mxv_gen:1 at [{n}, {n}] f32: one "
              f"kernel.fallback, tier {ev['tier']}, failure {ev['failure']}"
              f", D={failed[0]} P={failed[1]} block_rows={failed[2]} -> "
              f"D={ev['d']} P={ev['p']}; quarantined {list(q)}; excess over "
              f"the dot limit {excess:.3g}; row-dot launches "
              f"{mk.ROWDOT.launches - before} [{card}]")
        start, before = len(mem.events), mk.ROWDOT.launches
        again = tgen.mxv_gen(a, x)
        torch.cuda.synchronize()
        res = [e.attrs for e in mem.events[start:]
               if e.name == "kernel.resolve"]
        if (len(res) != 1 or res[0]["source"] != "quarantine_alt"
                or mk.ROWDOT.launches != before + 1
                or not _excess(again, want_y, limit) <= 0):
            raise AssertionError(f"guard (c): next call resolved {res}, "
                                 f"{mk.ROWDOT.launches - before} launches")
        print(f"guard (c): next call, nothing armed: source "
              f"{res[0]['source']} D={res[0]['d']} P={res[0]['p']}, "
              f"row-dot launches +{mk.ROWDOT.launches - before} [{card}]")

        # (d) no tier left
        start, before = len(mem.events), mk.ROWDOT.launches
        try:
            with faults.inject("lower:mxv_gen") as plan:
                tgen.mxv_gen(a, x)
            raise AssertionError("guard (d): the call did not raise")
        except faults.InjectedFault:
            pass
        fired = plan.rules[0].fired
        if fired != 3 or mk.ROWDOT.launches != before:
            raise AssertionError(f"guard (d): {fired} attempts, "
                                 f"{mk.ROWDOT.launches - before} launches")
        print(f"guard (d): lower:mxv_gen armed: InjectedFault after {fired}"
              f" attempts (the config and two alt configs), "
              f"{len(cache.quarantined(qkey))} configs quarantined, no "
              f"launch [{card}]")
    finally:
        obs.uninstall()
        loopir.evaluate = evaluate
        if prev is None:
            os.environ.pop("REPRO_TORCH_TUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_TUNE_CACHE"] = prev
        tunecache.reset_default_cache()
        common.reset_plan_memo()

    # (e) the sink against the memory, less the two dropped records
    from collections import Counter
    recs = obs.read_jsonl(os.path.join(tmp, "obs.jsonl"))
    dropped = [mem.events[i - 1] for i, e in enumerate(mem.events)
               if e.name == "fault.injected" and e.attrs["site"] == "sink_io"]
    expect = Counter(e.name for e in mem.events)
    expect.subtract(Counter(e.name for e in dropped))
    got_names = Counter(r["name"] for r in recs)
    print(f"guard (e): sink {len(recs)} records ({obs.read_jsonl.skipped} "
          f"torn), memory {len(mem.events)}, dropped {sink.dropped} "
          f"({', '.join(e.name for e in dropped)}); by name "
          f"{json.dumps(dict(sorted(got_names.items())))} [{card}]")
    if (sink.dropped != 2 or len(dropped) != 2
            or +expect != got_names or obs.read_jsonl.skipped):
        raise AssertionError(f"guard (e): the sink's {dict(got_names)} is "
                             f"not the memory's {dict(+expect)}")
    shutil.rmtree(tmp, ignore_errors=True)
    del a, x, want_y, got, again
    torch.cuda.empty_cache()
    print(f"guard: phase took {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")


def phase_train(card: str) -> dict:
    """Yi-9B at full width, depth cut to 4 layers, trains through the
    launcher's path (``repro_torch.launch.train.setup``): f32 params,
    bf16 compute, seq 4096, batch 2, remat, AdamW(lr 3e-3, warmup 10,
    50 total steps), SyntheticTokens(seed 0).  Six steps, each with the
    counts set to 0 just before and read just after (17 rmsnorm, 1
    adamw_update every step: the 39 f32 leaves in one launch); then a
    checkpoint round trip of the state,
    the in-model check of the kernels against mode="ref", and where a
    step's time goes.  Returns the launches over the six steps."""
    import numpy as np
    import torch
    from repro_torch import obs
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
        # one AdamW launch a step for each parameter dtype (f32: one)
        want = {"rmsnorm": 4 * cfg.n_layers + 1,
                "adamw_update": len({p.dtype for p in named.values()})}
        losses, total = [], {n: 0 for n in want}
        torch.cuda.reset_peak_memory_stats()
        for step in range(TRAIN_STEPS):
            batch = {"tokens": torch.from_numpy(run.data.batch(step)).cuda()}
            for k in cuda.KERNELS.values():
                k.launches = 0
            t0 = time.perf_counter()
            if step == 0:
                with obs.collect() as col:
                    state, metrics = run.step_fn(state, batch)
                print(f"train: configs step 0 resolved with none given "
                      f"(kernel, D, P, block_rows, source): "
                      f"{json.dumps(_resolved(col.named('kernel.resolve')))}"
                      f" [{card}]")
            else:
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
        batch = {"tokens": torch.from_numpy(
            run.data.batch(TRAIN_STEPS)).cuda()}
        _in_model_train(card, "in-model train", run.model, run.ocfg,
                        run.step_fn, state, snap, batch)
        del snap
        _profile_train(card, run, state)
        return total
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _host_tree(state) -> dict:
    """A host copy of the train state, as ``trainstep.state_tree`` gives
    it (a snapshot ``trainstep.load_state_tree`` restores)."""
    from repro_torch.train import trainstep
    tree = trainstep.state_tree(state)
    ost = tree["opt_state"]
    def host(t):
        return t.to("cpu", copy=True)
    return {"params": {k: host(t) for k, t in tree["params"].items()},
            "opt_state": {w: {k: host(t) for k, t in ost[w].items()}
                          for w in ("m", "v")} | {"step": host(ost["step"])}}


def _ulps(got, want) -> float:
    """max |got - want| in ulps of ``want``'s dtype at each element."""
    import torch
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent
                      - _MANTISSA[str(want.dtype).removeprefix("torch.")])
    return float(((got.float() - w).abs() / ulp).max())


@contextlib.contextmanager
def _paired(fault_call: int, embed):
    """Within the block every rmsnorm and adamw_update_many call runs its
    kernel (the main path; the counts are its launches) and then its plain
    version on the same inputs, which launches nothing, and passes the
    kernel's outputs on.  The AdamW update is in place: its inputs p, m,
    v are copied first (on the card where twice their bytes are free,
    else to the host) and the plain version runs leaf by leaf on copies
    of them.  Yields the readings: ``norm``, each rmsnorm call's output
    distance from the plain one in ulps and its inverse rms's relative
    distance; ``adamw``, each tensor's ||x_k - x_r|| / ||x_r - x_0|| for
    x = p, m, v, the worst of the three.  Controls, read the same way on a
    corrupted copy of one kernel output: rmsnorm call ``fault_call`` with
    its last FAMILY_FAULT_ROWS rows lost, and the update of ``embed``
    with the second half of its rows (of the [rows, 512] blocking) lost
    (left at p_0)."""
    import torch
    from unittest import mock
    from repro_torch.kernels.adamw import ops as aops
    from repro_torch.kernels.rmsnorm import ops as trops
    norm_fn, adamw_fn = trops.rmsnorm, aops.adamw_update_many
    got = {"norm": [], "inv": [], "adamw": [], "norm_fault": None,
           "adamw_fault": None}

    def norm(x, w, eps=1e-6, config=None, mode=None, with_inv_rms=False):
        out, inv = norm_fn(x, w, eps=eps, config=config, mode=mode,
                           with_inv_rms=True)
        ro, ri = norm_fn(x, w, eps=eps, mode="ref", with_inv_rms=True)
        if len(got["norm"]) == fault_call:
            lost = out.clone()
            lost.view(-1, lost.shape[-1])[-FAMILY_FAULT_ROWS:] = 0
            got["norm_fault"] = _ulps(lost, ro)
        got["norm"].append(_ulps(out, ro))
        got["inv"].append(float(((inv - ri).abs() / ri.abs()).max()))
        return (out, inv) if with_inv_rms else out

    def update(ps, gs, ms, vs, wds, scalars, gscale=None, mode=None,
               **kw):
        nbytes = sum(t.numel() * t.element_size()
                     for t in ps + ms + vs)
        keep = ("cuda" if torch.cuda.mem_get_info()[0] > 2 * nbytes
                else "cpu")
        x0 = [[t.to(keep, copy=True) for t in x] for x in zip(ps, ms, vs)]
        adamw_fn(ps, gs, ms, vs, wds, scalars, gscale=gscale, mode=mode,
                 **kw)

        def ratio(k, r, x0):
            return float((k.float() - r.float()).norm()
                         / (r.float() - x0.float()).norm().clamp_min(1e-30))
        for i, out in enumerate(zip(ps, ms, vs)):
            a = [t.to(out[0].device) for t in x0[i]]
            ref = [t.clone() for t in a]
            adamw_fn(ref[:1], gs[i:i + 1], ref[1:2], ref[2:],
                     None if wds is None else wds[i:i + 1], scalars,
                     gscale=gscale, mode="ref")
            got["adamw"].append(max(ratio(k, r, x) for k, r, x
                                    in zip(out, ref, a)))
            p = out[0]
            if p.data_ptr() == embed.data_ptr():
                rows, cols = aops._blocking(p.numel())
                seg = rows // 2
                lost = p.clone().view(rows, cols)
                lost[seg:2 * seg] = a[0].view(rows, cols)[seg:2 * seg]
                got["adamw_fault"] = ratio(lost.view(p.shape), ref[0], a[0])
            x0[i] = None
    with mock.patch.object(trops, "rmsnorm", norm), \
            mock.patch.object(aops, "adamw_update_many", update):
        yield got


def _in_model_train(card, tag, model, ocfg, step_fn, state, snap,
                    batch) -> None:
    """The next step of the main path (``step_fn``, the kernels) from
    ``state`` with every kernel call held against its plain version on
    the same inputs (``_paired``): each rmsnorm output within 1 ulp and
    its inverse rms within 1e-5 relative (the kernel sums a row's
    squares in f32 in another order), each tensor's AdamW p, m and v
    within 1e-2 of the plain step's change, ||x_k - x_r|| <= 1e-2
    ||x_r - x_0||, at every shape the model has.  The controls, lost
    norm rows of the middle decoder layer's norm1 and half the
    embedding's AdamW update lost, must land above those limits.  Then one step with
    mode="ref" (plain rmsnorm and AdamW on the card) from the same state
    ``snap`` (a later step's: m and v warm) and batch: the loss within
    1e-3 and the grad norm within 1e-2 of the kernels' step, relative.
    A MoE's plain step replays the kernels' step's routing
    (``_Routing``).  The two whole steps' parameters are not compared:
    in a bf16 forward any one-ulp difference, even in 0.0003% of the
    norm outputs, reaches every token (``tools/torch_norm_shift.py``),
    and AdamW's update of an entry whose gradient is near 0 swings."""
    from repro_torch.models import blocks
    from repro_torch.models.lm import norm_calls
    from repro_torch.train import trainstep
    params = state["params"]
    mid = len(params.blocks) // 2
    fault_call = (norm_calls(params) - 1
                  - blocks.norm_calls(params.blocks[mid:]))
    routing, moved = _Routing(), {}
    with routing.record(), _paired(fault_call, params.embed) as got:
        (state, mk), counts = _launches(lambda: step_fn(state, batch))
    trainstep.load_state_tree(state, snap)
    ref_step = trainstep.make_train_step(model, ocfg, mode="ref")
    with routing.replay(moved, "ref"):
        (state, mr), ref_counts = _launches(lambda: ref_step(state, batch))
    if ref_counts:
        raise AssertionError(f"{tag}: the plain step launched {ref_counts}")
    dl = abs(float(mk["loss"]) - float(mr["loss"])) / abs(float(mr["loss"]))
    dg = abs(float(mk["grad_norm"]) - float(mr["grad_norm"])) / float(
        mr["grad_norm"])
    worst = {"norm": max(got["norm"]), "inv": max(got["inv"]),
             "adamw": max(got["adamw"])}
    print(f"{tag}: step {int(snap['opt_state']['step'])}, each kernel call "
          f"against its plain version on the same inputs: rmsnorm over "
          f"{len(got['norm'])} calls within {worst['norm']:.0f} ulp (limit "
          f"1), inverse rms {worst['inv']:.2e} (limit 1e-5); adamw_update "
          f"over {len(got['adamw'])} tensors, worst ||x_k - x_r|| / ||x_r "
          f"- x_0|| of p, m, v {worst['adamw']:.2e} (limit 1e-2); controls: "
          f"{FAMILY_FAULT_ROWS} rows of layer {mid}'s norm1 lost (call "
          f"{fault_call}) {got['norm_fault']:.0f} ulp, embed with half "
          f"its AdamW update lost {got['adamw_fault']:.3f}.  Against the "
          f"plain "
          f"step from the same state: loss {float(mk['loss']):.6f} vs "
          f"{float(mr['loss']):.6f} (rel {dl:.2e}, limit 1e-3), grad_norm "
          f"{float(mk['grad_norm']):.6f} vs {float(mr['grad_norm']):.6f} "
          f"(rel {dg:.2e}, limit 1e-2)"
          + (f"; the plain step routed as the kernels' step, tokens x MoE "
             f"layer calls whose own top-k differed: {_moved_line(moved)}"
             if any(n for _, n in moved.values()) else "")
          + f"; kernel step launches {json.dumps(counts)} [{card}]")
    if (worst["norm"] > 1 or worst["inv"] > 1e-5 or worst["adamw"] > 1e-2
            or dl > 1e-3 or dg > 1e-2):
        raise AssertionError(f"{tag}: kernels disagree with the plain path "
                             "beyond the limits")
    if got["norm_fault"] <= 1 or got["adamw_fault"] <= 1e-2:
        raise AssertionError(f"{tag}: a control stays inside its limit, so "
                             "the check cannot see it")


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
    from repro_torch import obs
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
    with obs.collect() as col:
        results = engine.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: k.launches for name, k in cuda.KERNELS.items()}
    print(f"serve: configs resolved with none given (kernel, D, P, "
          f"block_rows, source): "
          f"{json.dumps(_resolved(col.named('kernel.resolve')))} [{card}]")
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
    return model, params, engine, counts, results


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
    from repro_torch.kernels.decode_attn import ops as dops
    cfg = model.cfg
    rng = np.random.default_rng(3)
    gen = torch.Generator(device="cuda").manual_seed(3)
    b, s = SERVE_SLOTS, SERVE_MAX_LEN
    # the D decode attention resolves in the model (its planned config)
    d = dops.resolve(torch.empty(b, s, cfg.n_kv_heads, cfg.head_dim,
                                 dtype=torch.bfloat16,
                                 device="cuda")).stride_unroll
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


PREFILL_DECODE = 8                  # decode steps from the prefilled cache
PREFILL_SHORT = 64                  # tokens of the prompt held against decode
PREFILL_FAULT_LAYER = 24            # the planted fault's layer (its norm1)
PREFILL_FAULT_ROWS = 64             # rows of the norm output left unwritten
_MANTISSA = {"bfloat16": 8, "float16": 11, "float32": 24}


def _one_ulp(f, dtype):
    """One ulp of ``dtype`` at each element of the f32 tensor ``f``."""
    import torch
    return torch.ldexp(torch.ones_like(f), torch.frexp(f).exponent
                       - _MANTISSA[str(dtype).removeprefix("torch.")])


def _ulp_moved(t, gen):
    """``t`` with every nonzero element moved one ulp of its dtype, the
    sign drawn at random from ``gen``: one more rounding than the kernels
    add."""
    import torch
    f = t.float()
    sign = torch.randint(0, 2, f.shape, generator=gen,
                         device=f.device) * 2 - 1
    return (f + sign * torch.where(f == 0, 0, _one_ulp(f, t.dtype))
            ).to(t.dtype)


def _ulp_moved_by_low_bit(t):
    """``t`` with every nonzero element moved one ulp of its dtype, up or
    down by the low bit of its own bit pattern: the same move each time
    the same value is moved, as activation checkpointing's recompute of
    a MoE needs (its routing, and so its shapes, follow the values)."""
    import torch
    f = t.float()
    bits = t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    sign = (bits & 1) * 2 - 1
    return (f + sign * torch.where(f == 0, 0, _one_ulp(f, t.dtype))
            ).to(t.dtype)


def _moved_norm(plain, move):
    """rmsnorm (``plain``, called in its plain version) with its output
    passed through ``move``."""
    def norm(x, w, eps=1e-6, config=None, mode=None, with_inv_rms=False):
        out, inv = plain(x, w, eps=eps, config=config, mode=mode,
                         with_inv_rms=True)
        out = move(out)
        return (out, inv) if with_inv_rms else out
    return norm


def _ulp_norm(plain, gen):
    """rmsnorm (``plain``) with every output moved one ulp of its dtype,
    each sign drawn from ``gen``: the one-ulp control."""
    return _moved_norm(plain, lambda t: _ulp_moved(t, gen))


def _lost_rows_norm(plain, call: int, rows: int):
    """rmsnorm (``plain``) whose ``call``-th call (from 0) leaves the last
    ``rows`` rows of its output unwritten (zero): the planted fault."""
    calls = [0]

    def norm(x, w, eps=1e-6, config=None, mode=None, with_inv_rms=False):
        out, inv = plain(x, w, eps=eps, config=config, mode=mode,
                         with_inv_rms=True)
        if calls[0] == call:
            out = out.clone()
            out.view(-1, out.shape[-1])[-rows:] = 0
        calls[0] += 1
        return (out, inv) if with_inv_rms else out
    return norm


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def _cache_rel(got, want, s: int) -> float:
    """The worst cache row's ||K - K_ref|| / ||K_ref|| (or V's): a row is
    one (layer, batch row, position) of the first ``s`` positions, all
    its heads, so a few lost rows stand out of the rounding.  A Mamba-2
    layer's rows are its conv window and its SSM state of one (layer,
    batch row)."""
    worst = 0.0
    for g, w in zip(got, want):
        if "k" in g:
            pairs = [(g[n][:, :s].flatten(2), w[n][:, :s].flatten(2))
                     for n in ("k", "v")]
        else:
            pairs = [(g[n].flatten(1), w[n].flatten(1))
                     for n in ("conv", "ssm")]
        for a, b in pairs:
            a, b = a.float(), b.float()
            rel = (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)
            worst = max(worst, float(rel.max()))
    return worst


def _launches(fn):
    """``fn()`` with every kernel count set to 0 just before and read
    just after (the nonzero ones), the device synchronized."""
    import torch
    from repro_torch.kernels import cuda
    for k in cuda.KERNELS.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: k.launches for n, k in cuda.KERNELS.items()
                 if k.launches}


def _timed(fn):
    """(``fn()``, host wall s, CUDA-event device ms) of one call."""
    import torch
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, time.perf_counter() - w0, t0.elapsed_time(t1)


def _margin_check(what, got, want, card) -> int:
    """Greedy next tokens: how many rows agree, and a fault where a row
    disagrees whose reference top-2 margin is above 2 max|d|, which
    rounding cannot close."""
    got, want = got.float(), want.float()
    top2 = want.topk(2, dim=-1).values
    clear = top2[:, 0] - top2[:, 1] > 2 * (got - want).abs().amax(-1)
    same = got.argmax(-1) == want.argmax(-1)
    print(f"{what}: greedy next token agrees on {int(same.sum())}/"
          f"{same.numel()} rows; {int(clear.sum())} rows have a top-2 "
          f"margin above 2 max|d| and must agree [{card}]")
    if not bool(same[clear].all()):
        raise AssertionError(f"{what}: the greedy token differs on a row "
                             "whose margin rounding cannot close")
    return int(same.sum())


def phase_prefill(card: str, model, params) -> None:
    """Single-pass prefill on the serve phase's Yi-9B weights (full width,
    all 48 layers, bf16), through ``launch.steps.build_prefill_step``:

    (a) prefill_32k cut to B=4, S=4032 at the serve phase's max_len
        4096 (97 rmsnorm launches and no decode launch a call), then 16
        greedy decode steps from the prefilled cache (97 rmsnorm, 48
        decode_attn and 48 merge launches a step); a 64-token prompt's
        prefill held against the engine's path (one teacher-forced
        decode step a token): last logits within 2x a control's distance
        (the plain prefill with every rmsnorm and attention output moved
        one bf16 ulp, the two paths rounding attention differently), and
        the greedy tokens;
    (b) the kernels against mode="ref" at (a)'s shape: last logits and
        the worst row of every layer's cache within 2x the control of the
        plain path with every rmsnorm output moved one bf16 ulp; a fault
        (the last 64 rows of layer 24's norm1 output left unwritten) must
        land above;
    (c) prefill_32k cut to B=1 (S=32768, its own max_len), prefill only:
        the attention chunk and peak memory;
    (d) wall and device time, tokens/s, count_flops beside model_flops,
        roofline_terms(n_chips=1) and the share of the bound reached,
        and where (a)'s time goes (torch.profiler)."""
    import dataclasses
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch.configs import get_shape
    from repro_torch.kernels.rmsnorm import ops as trops
    from repro_torch.launch import steps
    from repro_torch.models import attention as tatt
    from repro_torch.roofline import analysis
    cfg = model.cfg
    n_l = cfg.n_layers
    per_prefill = {"rmsnorm": 2 * n_l + 1}
    per_step = {"rmsnorm": 2 * n_l + 1, "decode_attn": n_l,
                "decode_attn_merge": n_l}
    gen = torch.Generator(device="cuda").manual_seed(6)

    # (a) prefill, then decode
    shape = dataclasses.replace(get_shape("prefill_32k"),
                                global_batch=PREFILL_B, seq_len=PREFILL_S)
    prefill, (_, batch) = steps.build_prefill_step(cfg, shape, "cuda",
                                                   params=params)
    tokens = PREFILL_B * PREFILL_S

    def run_a(mode=None):
        return prefill(params, batch, max_len=SERVE_MAX_LEN, mode=mode)

    run_a()                                   # warm: cuBLAS plans, caches
    ((logits, cache), wall, a_ms), counts = _launches(
        lambda: _timed(run_a))
    if counts != per_prefill:
        raise AssertionError(f"prefill (a): launches {counts}, expected "
                             f"{per_prefill}")
    if not bool(torch.isfinite(logits).all()) or logits.shape != (
            PREFILL_B, cfg.vocab_size):
        raise AssertionError(f"prefill (a): logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    print(f"prefill (a): B={PREFILL_B} S={PREFILL_S} max_len "
          f"{SERVE_MAX_LEN}, launches {json.dumps(counts)}; wall "
          f"{wall:.4f} s, device {a_ms:.2f} ms, {tokens / wall:.0f} "
          f"tokens/s (wall), {tokens / a_ms * 1e3:.0f} (device); q "
          f"chunk {tatt._pick_q_chunk(PREFILL_B, cfg.n_heads, PREFILL_S,
                                      PREFILL_S)} [{card}]")

    def decode_from(cache, tok):
        out = []
        with torch.inference_mode():
            for i in range(PREFILL_DECODE):
                lg, cache = model.decode_step(params, tok, cache,
                                              PREFILL_S + i)
                tok = lg.argmax(-1, keepdim=True)
                out.append(lg)
        return out

    (steps_out, wall, dev_ms), counts = _launches(
        lambda: _timed(lambda: decode_from(cache, logits.argmax(
            -1, keepdim=True))))
    want = {k: v * PREFILL_DECODE for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"prefill (a) decode: launches {counts}, "
                             f"expected {want}")
    if not all(bool(torch.isfinite(lg).all()) for lg in steps_out):
        raise AssertionError("prefill (a) decode: non-finite logits")
    print(f"prefill (a): {PREFILL_DECODE} greedy decode steps from the "
          f"prefilled cache (positions {PREFILL_S}-"
          f"{PREFILL_S + PREFILL_DECODE - 1}): launches "
          f"{json.dumps(counts)}, {wall / PREFILL_DECODE * 1e3:.2f} ms a "
          f"step wall, {dev_ms / PREFILL_DECODE:.2f} ms between events "
          f"[{card}]")
    del steps_out

    rng = np.random.default_rng(5)
    short = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (PREFILL_B, PREFILL_SHORT)), device="cuda")}

    def teacher_forced():
        """The engine's path: a decode step a prompt token, each row at
        its own position (a [B] vector, as the engine steps its slots)."""
        tc = model.init_cache(PREFILL_B, SERVE_MAX_LEN, device="cuda")
        with torch.inference_mode():
            for t in range(PREFILL_SHORT):
                lg, tc = model.decode_step(
                    params, short["tokens"][:, t:t + 1], tc,
                    torch.full((PREFILL_B,), t, device="cuda"))
        return lg, tc

    def one_ulp_attn(*a, **kw):
        return _ulp_moved(plain_sdpa(*a, **kw), gen)

    plain_norm, plain_sdpa = trops.rmsnorm, tatt._sdpa
    one_ulp_norm = _ulp_norm(plain_norm, gen)
    lp, cp = model.prefill(params, short, max_len=SERVE_MAX_LEN)
    lt, ct = teacher_forced()
    lr_ = model.prefill(params, short, max_len=PREFILL_SHORT, mode="ref")[0]
    with mock.patch.object(trops, "rmsnorm", one_ulp_norm), \
            mock.patch.object(tatt, "_sdpa", one_ulp_attn):
        lc = model.prefill(params, short, max_len=PREFILL_SHORT,
                           mode="ref")[0]
    rel, ctl = _rel(lp, lt), _rel(lc, lr_)
    limit = 2 * ctl
    print(f"prefill (a) vs the engine's path, B={PREFILL_B} x "
          f"{PREFILL_SHORT} tokens: ||logits - logits_tf|| / ||logits_tf||"
          f" {rel:.3e}, limit {limit:.3e} (2x the control {ctl:.3e}: the "
          f"plain prefill with every rmsnorm and attention output one bf16 "
          f"ulp off); worst cache row {_cache_rel(cp, ct, PREFILL_SHORT):.3e}"
          f" [{card}]")
    _margin_check("prefill (a) vs the engine's path", lp, lt, card)
    if rel > limit:
        raise AssertionError(f"prefill (a): prefill and the engine's path "
                             f"disagree ({rel:.3e} > {limit:.3e})")
    del cp, ct

    # (b) in-model: the kernels against mode="ref" at (a)'s shape
    ref_logits, ref_cache = run_a("ref")
    lost_rows = _lost_rows_norm(plain_norm, 2 * PREFILL_FAULT_LAYER,
                                PREFILL_FAULT_ROWS)
    lost = (f"fault: {PREFILL_FAULT_ROWS} rows of layer "
            f"{PREFILL_FAULT_LAYER}'s norm1 lost")
    reads = {"kernels": (logits, cache)}
    for name, fault in (("control: one ulp", one_ulp_norm),
                        (lost, lost_rows)):
        with mock.patch.object(trops, "rmsnorm", fault):
            reads[name] = run_a("ref")
    rel = {k: (_rel(lg, ref_logits), _cache_rel(c, ref_cache, PREFILL_S))
           for k, (lg, c) in reads.items()}
    ctl = rel["control: one ulp"]
    lim = (2 * ctl[0], 2 * ctl[1])
    print(f"prefill (b) in-model, B={PREFILL_B} S={PREFILL_S}, "
          f"||logits - logits_ref|| / ||logits_ref|| and the worst cache "
          f"row's ||c - c_ref|| / ||c_ref||: "
          + ", ".join(f"{k} {a:.3e}, {c:.3e}" for k, (a, c) in rel.items())
          + f"; limits {lim[0]:.3e}, {lim[1]:.3e} (2x the one-ulp control)"
          f" [{card}]")
    _margin_check("prefill (b) kernels vs ref", logits, ref_logits, card)
    k_rel, f_rel = rel["kernels"], rel[lost]
    if k_rel[0] > lim[0] or k_rel[1] > lim[1]:
        raise AssertionError(f"prefill (b): the kernels disagree with ref "
                             f"({k_rel} > {lim})")
    if f_rel[1] <= lim[1]:
        raise AssertionError("prefill (b): lost norm rows stay inside the "
                             "limit, so the check cannot see them")
    del reads, ref_cache, ref_logits

    # (d) for (a): FLOPs, roofline terms, where the time goes
    flops = analysis.count_flops(run_a)
    _roofline_line("prefill (d) (a)", cfg, shape, flops,
                   analysis.roofline_terms(cfg, shape, 1, flops), a_ms, card)
    _profile_prefill(card, run_a)
    del logits, cache
    torch.cuda.empty_cache()

    # (c) the long prompt, prefill only, at its own max_len
    long = dataclasses.replace(get_shape("prefill_32k"), global_batch=1)
    prefill_l, (_, batch_l) = steps.build_prefill_step(cfg, long,
                                                       "cuda", params=params)
    s = long.seq_len
    qc = tatt._pick_q_chunk(1, cfg.n_heads, s, s)
    tpu_qc = min(2 ** 33 // (cfg.n_heads * s), s)   # the JAX package's
    out = {}
    torch.cuda.reset_peak_memory_stats()
    (flops, wall, dev_ms), counts = _launches(lambda: _timed(
        lambda: analysis.count_flops(
            lambda: out.update(r=prefill_l(params, batch_l)))))
    peak = torch.cuda.max_memory_allocated()
    lg, lc = out.pop("r")
    if counts != per_prefill or not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"prefill (c): launches {counts} (expected "
                             f"{per_prefill}) or non-finite logits")
    print(f"prefill (c): B=1 S={s} max_len {lc[0]['k'].shape[1]}, q chunk "
          f"{qc} ({s // qc} chunks, {4 * cfg.n_heads * qc * s / 1e9:.2f} GB "
          f"of f32 scores each; the budget {tatt.SCORE_BUDGET_BYTES / 1e9:.1f}"
          f" GB; at the JAX package's 2**33 elements {tpu_qc}, "
          f"{4 * cfg.n_heads * tpu_qc * s / 1e9:.1f} GB), "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; launches "
          f"{json.dumps(counts)}; wall {wall:.3f} s, device "
          f"{dev_ms:.1f} ms, {s / wall:.0f} tokens/s (wall; FLOPs counted "
          f"in the same run) [{card}]")
    _roofline_line("prefill (d) (c)", cfg, long, flops,
                   analysis.roofline_terms(cfg, long, 1, flops), dev_ms, card)
    del lg, lc, out
    torch.cuda.empty_cache()


def _roofline_line(what, cfg, shape, flops, terms, dev_ms, card) -> None:
    from repro_torch.roofline import analysis
    bound = max(terms["compute_s"], terms["memory_s"])
    mflops = analysis.model_flops(cfg, shape)
    print(f"{what}: count_flops {flops['flops']:.6e} (aten.mm "
          f"{flops['by_op'].get('aten.mm', 0):.4e}, aten.bmm "
          f"{flops['by_op'].get('aten.bmm', 0):.4e}), model_flops "
          f"{mflops:.6e} (causal half of attention); roofline_terms "
          f"n_chips=1: compute_s {terms['compute_s']:.4f}, memory_s "
          f"{terms['memory_s']:.4f}, dominant {terms['dominant']}, "
          f"roofline_fraction {terms['roofline_fraction']:.3f}; device "
          f"{dev_ms / 1e3:.4f} s, {100 * bound / (dev_ms / 1e3):.1f}% of the "
          f"bound reached, {flops['flops'] / (dev_ms / 1e3) / 1e12:.1f} "
          f"TFLOP/s counted [{card}]")


def _profile_prefill(card, run, what: str = "prefill") -> None:
    """Where one call's time goes (a prefill, or a few decode steps):
    device time by kernel and the busy share (torch.profiler over one
    call against its unprofiled wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    (_, wall, _) = _timed(run)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev(e) > 0]
    total_ms = sum(dev(e) for e in kernels) / 1e3
    if total_ms <= 0:
        print(f"profile {what}: wall {wall * 1e3:.1f} ms; the profiler "
              f"recorded no device kernels [{card}]")
        return
    rms = [e for e in kernels if "rmsnorm_ms" in e.key]
    rms_ms = sum(dev(e) for e in rms) / 1e3
    print(f"profile {what}: wall {wall * 1e3:.1f} ms, device kernels "
          f"{total_ms:.1f} ms ({100 * total_ms / (wall * 1e3):.1f}% busy); "
          f"rmsnorm {rms_ms:.3f} ms in {sum(e.count for e in rms)} launches "
          f"({rms_ms / max(sum(e.count for e in rms), 1) * 1e3:.1f} us "
          f"each) [{card}]")
    for e in sorted(kernels, key=dev, reverse=True)[:12]:
        print(f"  {dev(e) / 1e3:9.3f} ms {100 * dev(e) / 1e3 / total_ms:5.1f}% "
              f"{e.count:6d} calls  {e.key[:90]}")


# the families phase: (arch, B, prompt tokens S, max_len); a VLM's prefix
# embeds come before the S tokens, so its cache holds Np + S rows
# (arch, layers kept or None for all, B, S, max_len): full width; depth
# cut for the script's time limit (the fault layer is n_layers // 2)
FAMILY_CELLS = (("qwen3-moe-30b-a3b", 12, 2, 1024, 2048),
                ("mamba2-2.7b", 16, 2, 4096, 4096),
                ("internvl2-2b", None, 4, 768, 1040))
FAMILY_DECODE = 8                   # greedy decode steps from the prefill
FAMILY_GREEDY = 4                   # teacher-forced steps kernels vs ref
FAMILY_FAULT_ROWS = 64              # rows of one norm output left unwritten
# (d): compositions at reduced() dims, not a full-width path
FAMILY_REDUCED = ("jamba-1.5-large-398b", "arctic-480b")
FAMILY_REDUCED_SHAPE = (2, 64, 80)  # B, S, max_len
MAMBA_INVARIANT_S = 1024            # B=1: prefill S, then decode token S+1
MAMBA_INVARIANT_LAYERS = 4          # of Mamba2-2.7B's 64 (time, not memory)
WHISPER_INVARIANT_S = 64            # B=1: prefill S, then decode token S+1


class _Routing:
    """The MoE router's picks of one run (``record``), replayed into the
    plain runs it is compared with (``replay``).  Every rounding
    difference between two runs can move a router near-tie (two experts'
    probabilities an ulp apart) to the other expert, an O(1) change to
    that token and, through attention, to its row's later tokens: on the
    card the one-ulp control moved the worst cache row of Qwen3-MoE by
    0.51.  Replayed, each plain run routes as the kernels' run did (gates
    from its own probabilities), so the comparison reads the kernels'
    rounding, not the router's discontinuity; ``replay`` counts the
    tokens whose own top-k set differs from the replayed one."""

    def __init__(self):
        self.picks = []

    def record(self):
        from unittest import mock
        from repro_torch.models import moe
        route = moe._route

        def routed(xt, w, e):
            out = route(xt, w, e)
            self.picks.append(out[2])
            return out
        return mock.patch.object(moe, "_route", routed)

    def replay(self, moved: dict, key: str):
        from unittest import mock
        from repro_torch.models import moe
        route, picks = moe._route, iter(self.picks)
        moved.setdefault(key, [0, 0])

        def replayed(xt, w, e):
            probs, _, own = route(xt, w, e)
            idx = next(picks)
            moved[key][0] += int((own.sort(-1).values != idx.sort(-1)
                                  .values).any(-1).sum())
            moved[key][1] += idx.shape[0]
            gates = probs.gather(-1, idx)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            return probs, gates.to(xt.dtype), idx
        return mock.patch.object(moe, "_route", replayed)


def _moved_line(moved: dict) -> str:
    return "; ".join(f"{k} {a} of {n}" for k, (a, n) in moved.items())


def _family_launches(cfg) -> tuple[dict, dict]:
    """The kernel launches of one prefill call and of one decode step:
    rmsnorm for each layer's norm1, norm2 (a layer with an FFN) and
    Mamba-2's gated norm, and the final norm; decode_attn and its merge
    once per attention layer in a decode step."""
    from repro_torch.models import blocks
    descs = blocks.stack_descriptors(cfg)
    rms = 1 + sum(1 + (d.ffn != "none") + (d.mixer == "mamba")
                  for d in descs)
    n_attn = sum(d.mixer == "attn" for d in descs)
    step = {"rmsnorm": rms}
    if n_attn:
        step.update(decode_attn=n_attn, decode_attn_merge=n_attn)
    return {"rmsnorm": rms}, step


def _decode_floor_bytes(model, params, cache, b, pos, experts) -> float:
    """Bytes a decode step at ``pos`` must move: every weight it reads
    once (the embedding's B rows where the head is its own; of a MoE
    layer's experts, those its tokens chose: ``experts``, distinct experts
    per MoE layer), the KV rows [0, pos] read and row pos written, a
    Mamba-2 state read and written."""
    cfg = model.cfg
    total = 0.0
    for name, p in params.named_parameters():
        nb = p.numel() * p.element_size()
        if name == "embed" and not cfg.tie_embeddings:
            nb = b * p.shape[1] * p.element_size()
        if ".moe.w_" in name:
            continue
        total += nb
    moe_layers = [layer.moe for layer in params.blocks
                  if layer.desc.ffn == "moe"]
    for m, n in zip(moe_layers, experts):
        per = sum(getattr(m, w)[0].numel() * getattr(m, w).element_size()
                  for w in ("w_in", "w_gate", "w_out"))
        total += n * per
    for c in cache:
        if "k" in c:
            row = c["k"][0, 0].numel() * c["k"].element_size()
            total += 2 * b * (pos + 2) * row        # read [0, pos], write pos
        else:
            total += 2 * sum(t.numel() * t.element_size()
                             for t in c.values())
    return total


def _family_cell(card: str, arch: str, layers, b: int, s: int,
                 max_len: int) -> None:
    """One model family at full width on random bf16 weights (seeded
    ``torch.Generator``), on its first ``layers`` layers (all with None):
    a prefill of B x (Np + S) through ``launch.steps.build_prefill_step``
    and :data:`FAMILY_DECODE` greedy decode steps from its cache,
    counted, timed and profiled; then the kernels against
    mode="ref": last logits and the worst cache or state row within 2x
    the one-ulp control (every rmsnorm output one bf16 ulp off, in the
    plain path), a planted fault (the last 64 rows of the middle layer's
    norm1 output lost) above it, and 4 teacher-forced decode steps whose
    greedy tokens must agree wherever rounding cannot close the top-2
    margin; for Mamba-2, the serving invariant at B=1."""
    import dataclasses
    from unittest import mock
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.kernels.rmsnorm import ops as trops
    from repro_torch.launch import steps
    from repro_torch.models import blocks
    from repro_torch.models import moe as tmoe
    from repro_torch.models.lm import build_model
    from repro_torch.roofline import analysis
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg)
    per_prefill, per_step = _family_launches(cfg)
    npre = cfg.n_prefix_embeds
    tag = f"families {cfg.name}"
    print(f"{tag}: {cfg.family}, n_layers={cfg.n_layers} d_model="
          f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x"
          f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size}"
          + (f" experts {cfg.moe.n_experts} top-{cfg.moe.top_k} d_ff_expert "
             f"{cfg.moe.d_ff_expert}" if cfg.moe else "")
          + (f" ssm d_inner {cfg.ssm.d_inner(cfg.d_model)} heads "
             f"{cfg.ssm.n_heads(cfg.d_model)}x{cfg.ssm.head_dim} d_state "
             f"{cfg.ssm.d_state} chunk {cfg.ssm.chunk}" if cfg.ssm else "")
          + (f" prefix embeds {npre}" if npre else "")
          + f", n_params={cfg.n_params() / 1e9:.2f}B bf16 [{card}]")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"{tag}: weights {wbytes / 1e9:.2f} GB drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    shape = dataclasses.replace(get_shape("prefill_32k"), global_batch=b,
                                seq_len=s)
    prefill, (_, batch) = steps.build_prefill_step(cfg, shape, "cuda",
                                                   params=params)
    pos0 = npre + s

    def run(mode=None):
        return prefill(params, batch, max_len=max_len, mode=mode)

    flops = analysis.count_flops(run)          # also the warm-up call
    routing = _Routing()
    with routing.record():
        ((logits, cache), wall, ev_ms), counts = _launches(
            lambda: _timed(run))
    if counts != per_prefill:
        raise AssertionError(f"{tag} prefill: launches {counts}, expected "
                             f"{per_prefill}")
    if logits.shape != (b, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} prefill: logits {tuple(logits.shape)}"
                             " not finite or of the wrong shape")
    bound_s = flops["flops"] / PEAK_FLOPS["bfloat16"]
    print(f"{tag} prefill: B={b} x ({npre} + {s}) positions, max_len "
          f"{max_len}: launches {json.dumps(counts)}; wall {wall:.4f} s, "
          f"{ev_ms:.2f} ms between events, {b * pos0 / wall:.0f} positions/s"
          f"; count_flops {flops['flops']:.4e} (aten.mm "
          f"{flops['by_op'].get('aten.mm', 0):.4e}, aten.bmm "
          f"{flops['by_op'].get('aten.bmm', 0):.4e}), their bf16 bound "
          f"{bound_s * 1e3:.2f} ms ({100 * bound_s / wall:.1f}% of it "
          f"reached); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    _profile_prefill(card, run, f"{tag} prefill")

    # FAMILY_DECODE greedy decode steps from (a clone of) the prefill's cache
    experts = []
    route = tmoe._route

    def routed(xt, w, e):
        out = route(xt, w, e)
        experts.append(out[2])
        return out

    def decode(c, tok, n, mode=None):
        outs = []
        with torch.inference_mode():
            for i in range(n):
                lg, c = model.decode_step(params, tok, c, pos0 + i,
                                          mode=mode)
                tok = lg.argmax(-1, keepdim=True)
                outs.append(lg)
        return outs, c

    main = [{k: v.clone() for k, v in c.items()} for c in cache]
    first = logits.argmax(-1, keepdim=True)
    with mock.patch.object(tmoe, "_route", routed):
        ((outs, main), wall, ev_ms), counts = _launches(
            lambda: _timed(lambda: decode(main, first, FAMILY_DECODE)))
    want = {k: v * FAMILY_DECODE for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"{tag} decode: launches {counts}, expected "
                             f"{want}")
    if not all(bool(torch.isfinite(lg).all()) for lg in outs):
        raise AssertionError(f"{tag} decode: non-finite logits")
    n_moe = sum(1 for layer in params.blocks if layer.desc.ffn == "moe")
    chosen = [int(t.unique().numel()) for t in experts]
    step0 = chosen[:n_moe]
    floor = _decode_floor_bytes(model, params, cache, b, pos0, step0)
    print(f"{tag} decode: {FAMILY_DECODE} greedy steps at positions "
          f"{pos0}-{pos0 + FAMILY_DECODE - 1}, B={b}: launches "
          f"{json.dumps(counts)} ({json.dumps(per_step)} a step); "
          f"{wall / FAMILY_DECODE * 1e3:.2f} ms a step wall, "
          f"{ev_ms / FAMILY_DECODE:.2f} ms between events, "
          f"{b * FAMILY_DECODE / wall:.1f} tokens/s; floor "
          f"{floor / 1e9:.2f} GB a step, {floor / HBM_BYTES_PER_S * 1e3:.2f}"
          f" ms at the memory rate"
          + (f"; distinct experts a MoE layer (step 0) mean "
             f"{sum(step0) / len(step0):.1f} of {cfg.moe.n_experts}, all "
             f"{FAMILY_DECODE} steps mean {sum(chosen) / len(chosen):.1f}"
             if n_moe else "")
          + f"; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del outs
    _profile_prefill(card, lambda: decode(main, first, 2),
                     f"{tag} decode (2 steps)")
    del main

    # the kernels against mode="ref": prefill logits and cache rows
    gen = torch.Generator(device="cuda").manual_seed(7)
    plain_norm = trops.rmsnorm
    fault_layer = cfg.n_layers // 2
    # rmsnorm calls before layer L's norm1: norm1, the gated norm and
    # norm2 of each layer before it
    fault_call = sum(1 + (d.ffn != "none") + (d.mixer == "mamba")
                     for d in blocks.stack_descriptors(cfg)[:fault_layer])
    lost = (f"fault: {FAMILY_FAULT_ROWS} rows of layer {fault_layer}'s "
            f"norm1 lost")
    moved = {}
    with routing.replay(moved, "ref"):
        ref_logits, ref_cache = run("ref")
    ulp = _ulp_norm(plain_norm, gen)
    with mock.patch.object(trops, "rmsnorm", ulp), \
            routing.replay(moved, "control"):
        ctl_logits, ctl_cache = run("ref")
    with mock.patch.object(trops, "rmsnorm", _lost_rows_norm(
            plain_norm, fault_call, FAMILY_FAULT_ROWS)), \
            routing.replay(moved, "fault"):
        f_logits, f_cache = run("ref")
    rel = {"kernels": (_rel(logits, ref_logits),
                       _cache_rel(cache, ref_cache, pos0)),
           "control: one ulp": (_rel(ctl_logits, ref_logits),
                                _cache_rel(ctl_cache, ref_cache, pos0)),
           lost: (_rel(f_logits, ref_logits),
                  _cache_rel(f_cache, ref_cache, pos0))}
    del f_logits, f_cache
    ctl = rel["control: one ulp"]
    lim = (2 * ctl[0], 2 * ctl[1])
    print(f"{tag} vs ref, prefill: ||logits - logits_ref|| / "
          f"||logits_ref|| and the worst cache or state row's "
          f"||c - c_ref|| / ||c_ref||: "
          + ", ".join(f"{k} {a:.3e}, {c:.3e}" for k, (a, c) in rel.items())
          + f"; limits {lim[0]:.3e}, {lim[1]:.3e} (2x the one-ulp control)"
          + (f"; the plain runs routed as the kernels' run, tokens x MoE "
             f"layers whose own top-{cfg.moe.top_k} differed: "
             f"{_moved_line(moved)}" if cfg.moe else "")
          + f" [{card}]")
    _margin_check(f"{tag} vs ref, prefill", logits, ref_logits, card)
    k_rel = rel["kernels"]
    if k_rel[0] > lim[0] or k_rel[1] > lim[1]:
        raise AssertionError(f"{tag}: the kernels disagree with ref "
                             f"({k_rel} > {lim})")
    if rel[lost][1] <= lim[1]:
        raise AssertionError(f"{tag}: the lost norm rows stay inside the "
                             "limit, so the check cannot see them")

    # 4 teacher-forced steps (the kernels' greedy tokens fed to all three)
    tok = logits.argmax(-1, keepdim=True)
    agree, worst, limit = 0, 0.0, 0.0
    moved = {}
    with torch.inference_mode():
        for i in range(FAMILY_GREEDY):
            p = pos0 + i
            step = _Routing()
            with step.record():
                lk, cache = model.decode_step(params, tok, cache, p)
            with step.replay(moved, "ref"):
                lr, ref_cache = model.decode_step(params, tok, ref_cache, p,
                                                  mode="ref")
            with mock.patch.object(trops, "rmsnorm", ulp), \
                    step.replay(moved, "control"):
                lc, ctl_cache = model.decode_step(params, tok, ctl_cache, p,
                                                  mode="ref")
            worst = max(worst, _rel(lk, lr))
            limit = max(limit, 2 * _rel(lc, lr))
            agree += _margin_check(f"{tag} vs ref, decode step {i}", lk, lr,
                                   card)
            tok = lk.argmax(-1, keepdim=True)
    print(f"{tag} vs ref, {FAMILY_GREEDY} teacher-forced decode steps: "
          f"greedy tokens agree {agree}/{FAMILY_GREEDY * b}; worst "
          f"||logits - logits_ref|| / ||logits_ref|| {worst:.3e}, limit "
          f"{limit:.3e} (2x the step's one-ulp control)"
          + (f"; routed as the kernels' steps, own top-k differing: "
             f"{_moved_line(moved)}" if cfg.moe else "") + f" [{card}]")
    if worst > limit:
        raise AssertionError(f"{tag}: decode steps disagree with ref "
                             f"({worst:.3e} > {limit:.3e})")
    del logits, cache, ref_logits, ref_cache, ctl_logits, ctl_cache
    torch.cuda.empty_cache()
    if cfg.ssm is not None and not cfg.attn_period:
        _mamba_invariant(card, tag, model, params, gen)


def _mamba_invariant(card, tag, model, params, gen) -> None:
    """The serving invariant (tests/test_serve_consistency.py) at full
    width, B=1, on the first ``MAMBA_INVARIANT_LAYERS`` layers of the
    weights (the same tensors, no copy) and their final norm and head:
    prefill of S tokens, then one decode step of token S+1, against
    ``logits`` of all S+1 tokens, which runs the SSD in chunks of 1 (the
    chunk rule at an odd length, 61 s at all 64 layers).  Limit: 2x the
    one-ulp control of the prefill's last logits."""
    import dataclasses
    import numpy as np
    import torch
    from unittest import mock
    from repro_torch.kernels.rmsnorm import ops as trops
    from repro_torch.models import mamba2
    from repro_torch.models.lm import LMParams, build_model
    n = MAMBA_INVARIANT_LAYERS
    tag = f"{tag} ({n} of {model.cfg.n_layers} layers)"
    model = build_model(dataclasses.replace(model.cfg, n_layers=n))
    params = LMParams(params.embed, params.blocks[:n], params.final_norm,
                      params.head)
    cfg = model.cfg
    s = MAMBA_INVARIANT_S
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, s + 1)), device="cuda")
    lp, cache = model.prefill(params, {"tokens": toks[:, :s]}, max_len=s)
    with torch.inference_mode():
        ld, _ = model.decode_step(params, toks[:, s:], cache, s)
    with torch.no_grad():
        full, wall, _ = _timed(lambda: model.logits(params, {"tokens": toks}))
    lr = model.prefill(params, {"tokens": toks[:, :s]}, max_len=s,
                       mode="ref")[0]
    with mock.patch.object(trops, "rmsnorm", _ulp_norm(trops.rmsnorm, gen)):
        lc = model.prefill(params, {"tokens": toks[:, :s]}, max_len=s,
                           mode="ref")[0]
    ctl = _rel(lc, lr)
    rel_p, rel_d = _rel(lp, full[:, s - 1]), _rel(ld, full[:, s])
    print(f"{tag} invariant, B=1: prefill {s} tokens (chunk "
          f"{mamba2.chunk_size(cfg, s)}) vs logits of all {s + 1} (chunk "
          f"{mamba2.chunk_size(cfg, s + 1)}, {wall:.2f} s wall) at position "
          f"{s - 1}: {rel_p:.3e}; one decode step vs position {s}: "
          f"{rel_d:.3e}; limit {2 * ctl:.3e} (2x the one-ulp control of the "
          f"prefill's logits, {ctl:.3e}) [{card}]")
    _margin_check(f"{tag} invariant, decode vs full", ld, full[:, s], card)
    if max(rel_p, rel_d) > 2 * ctl:
        raise AssertionError(f"{tag}: prefill + decode disagree with the "
                             f"full forward ({rel_p:.3e}, {rel_d:.3e} > "
                             f"{2 * ctl:.3e})")


def _family_reduced(card: str, arch: str) -> None:
    """(d) A composition at ``reduced()`` dims on the card (not a
    full-width path): prefill and 4 decode steps with the kernels,
    counted, and the same under mode="ref" (logits within 2x the one-ulp
    control)."""
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.rmsnorm import ops as trops
    from repro_torch.models.lm import build_model
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    b, s, max_len = FAMILY_REDUCED_SHAPE
    batch = {"tokens": torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (b, s)), device="cuda")}
    per_prefill, per_step = _family_launches(cfg)
    gen = torch.Generator(device="cuda").manual_seed(9)
    ulp = _ulp_norm(trops.rmsnorm, gen)

    toks = []

    def run(mode=None, norm=None):
        """Prefill and 4 decode steps: the kernels' run picks the greedy
        tokens, the others are fed the same ones."""
        with mock.patch.object(trops, "rmsnorm", norm or trops.rmsnorm):
            lg, c = model.prefill(params, batch, max_len=max_len, mode=mode)
            out = [lg]
            with torch.inference_mode():
                for i in range(4):
                    if len(toks) == i:
                        toks.append(out[-1].argmax(-1, keepdim=True))
                    lg, c = model.decode_step(params, toks[i], c, s + i,
                                              mode=mode)
                    out.append(lg)
        return out

    model.prefill(params, batch, max_len=max_len)        # warm
    routing, moved = _Routing(), {}
    with routing.record():
        outs, counts = _launches(run)
    want = {k: per_prefill.get(k, 0) + 4 * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"families (d) {arch}: launches {counts}, "
                             f"expected {want}")
    with routing.replay(moved, "ref"):
        refs = run("ref")
    with routing.replay(moved, "control"):
        ctls = run("ref", ulp)
    rels = [_rel(a, r) for a, r in zip(outs, refs)]
    lims = [2 * _rel(c, r) for c, r in zip(ctls, refs)]
    d = cfg.moe
    print(f"families (d) {arch} at reduced() dims (n_layers {cfg.n_layers}, "
          f"d_model {cfg.d_model}"
          + (f", experts {d.n_experts} top-{d.top_k}" if d else "")
          + (", dense residual" if d and d.dense_residual else "")
          + f"; not a full-width path): B={b} S={s}, prefill + 4 decode "
          f"steps, launches {json.dumps(counts)}; vs ref ||logits - "
          f"logits_ref|| / ||logits_ref|| "
          f"{', '.join(f'{r:.2e}' for r in rels)}, limits "
          f"{', '.join(f'{x:.2e}' for x in lims)}"
          + (f"; routed as the kernels' run, own top-k differing: "
             f"{_moved_line(moved)}" if d else "") + f" [{card}]")
    if any(r > x for r, x in zip(rels, lims)) or not all(
            bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError(f"families (d) {arch}: kernels disagree with "
                             "ref or logits not finite")


def phase_families(card: str) -> None:
    """The MoE, SSM and VLM families at full width and depth (cells
    (a)-(c)), then the hybrid and dense-residual compositions at reduced
    dims (d); each phase's seconds printed."""
    import gc
    import torch
    for arch, layers, b, s, max_len in FAMILY_CELLS:
        t0 = time.perf_counter()
        _family_cell(card, arch, layers, b, s, max_len)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"families {arch}: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    for arch in FAMILY_REDUCED:
        _family_reduced(card, arch)
    print(f"families (d): {time.perf_counter() - t0:.1f} s [{card}]")


def _whisper_floor_bytes(params, cache, b: int, pos: int) -> float:
    """Bytes a decode step at ``pos`` must move: every decoder weight it
    reads once (of the cross layers wq and wo: their K and V are
    cached), the final norm, the head and the embedding's B rows; the
    cross K/V read whole; the self K/V rows [0, pos] read and row pos
    written."""
    total = b * params.embed.shape[1] * params.embed.element_size()
    for name, t in params.named_parameters():
        if name.startswith(("enc_", "embed")) or name.endswith(
                (".cross.wk", ".cross.wv")):
            continue
        total += t.numel() * t.element_size()
    for c in cache["cross"]:
        total += sum(t.numel() * t.element_size() for t in c.values())
    for c in cache["self"]:
        row = c["k"][0, 0].numel() * c["k"].element_size()
        total += 2 * b * (pos + 2) * row
    return total


def phase_whisper(card: str) -> None:
    """Whisper-medium (arXiv:2212.04356) at full width and depth on random
    bf16 weights (seeded ``torch.Generator``): 24 encoder and 24 decoder
    layers, d_model 1024, 16 heads of 64, d_ff 4096 gelu, vocabulary
    51865.  B=4 clips of 1500 frames x 1024 (the audio_stub frontend's
    output, f32 normal from seeded numpy), the 4-token start-of-transcript
    prompt, max_len 448, through ``EncDecLM.prefill`` and 32 greedy
    ``decode_step`` calls: the encoder alone, the prefill (49 + 73
    rmsnorm launches, no decode launch) and a step (73 rmsnorm, 24
    decode_attn and 24 merge launches), counted, timed and profiled, the
    prefill against its compute bound and a step against its byte floor.
    Then the kernels against mode="ref": the prefill's logits, the worst
    self-cache row and the worst cross K/V row within 2x the one-ulp
    control (every rmsnorm output one bf16 ulp off, in the plain path),
    and each encoder layer's worst row within 2x the control's at that
    layer, a planted fault (the last 64 rows of the middle encoder
    layer's norm2 lost) above a layer's limit; 4 teacher-forced steps;
    and the serving invariant at B=1 (a prefill of 64 tokens plus one
    decode step against ``logits`` over 65)."""
    import dataclasses
    from unittest import mock
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.kernels.rmsnorm import ops as trops
    from repro_torch.models import blocks
    from repro_torch.models.lm import build_model, norm_calls
    from repro_torch.roofline import analysis
    cfg = get_config("whisper-medium")
    model = build_model(cfg)
    b, p = WHISPER_B, len(WHISPER_PROMPT)
    n_dec = cfg.n_layers
    tag = "whisper"
    print(f"{tag}: {cfg.name} {cfg.n_enc_layers} encoder + {n_dec} decoder "
          f"layers, d_model={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads}x{cfg.head_dim} d_ff={cfg.d_ff} {cfg.act} "
          f"vocab={cfg.vocab_size}, n_params={cfg.n_params() / 1e9:.3f}B "
          f"bf16 [{card}]")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for t in params.parameters())
    print(f"{tag}: weights {wbytes / 1e9:.3f} GB drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    per_prefill = {"rmsnorm": norm_calls(params)}
    per_step = {"rmsnorm": blocks.norm_calls(params.blocks) + 1,
                "decode_attn": n_dec,
                "decode_attn_merge": n_dec}
    rng = np.random.default_rng(10)
    frames = torch.from_numpy(rng.standard_normal(
        (b, WHISPER_FRAMES, cfg.d_model), dtype=np.float32)).cuda()
    batch = {"tokens": torch.tensor([WHISPER_PROMPT] * b, device="cuda"),
             "frames": frames}

    def run(mode=None):
        return model.prefill(params, batch, max_len=WHISPER_MAX_LEN,
                             mode=mode)

    def encode():
        with torch.no_grad():
            return model.encode(params, frames, remat=False)

    encode()                                            # warm
    (_, wall, ev_ms), counts = _launches(lambda: _timed(encode))
    print(f"{tag} encode: B={b} x {WHISPER_FRAMES} frames, launches "
          f"{json.dumps(counts)}; wall {wall * 1e3:.2f} ms, "
          f"{ev_ms:.2f} ms between events, {b * WHISPER_FRAMES / wall:.0f} "
          f"frames/s [{card}]")
    flops = analysis.count_flops(run)           # also the warm-up call
    ((logits, cache), wall, ev_ms), counts = _launches(lambda: _timed(run))
    if counts != per_prefill:
        raise AssertionError(f"{tag} prefill: launches {counts}, expected "
                             f"{per_prefill}")
    if logits.shape != (b, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} prefill: logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    shape = dataclasses.replace(get_shape("prefill_32k"), global_batch=b,
                                seq_len=p)
    terms = analysis.roofline_terms(cfg, shape, 1, flops)
    print(f"{tag} prefill: B={b} x ({WHISPER_FRAMES} frames + {p} tokens), "
          f"max_len {WHISPER_MAX_LEN}: launches {json.dumps(counts)}; wall "
          f"{wall * 1e3:.2f} ms, {ev_ms:.2f} ms between events, "
          f"{b * WHISPER_FRAMES / wall:.0f} frames/s; count_flops "
          f"{flops['flops']:.4e} (aten.mm "
          f"{flops['by_op'].get('aten.mm', 0):.4e}, aten.bmm "
          f"{flops['by_op'].get('aten.bmm', 0):.4e}); roofline_terms "
          f"n_chips=1: compute_s {terms['compute_s']:.5f}, memory_s "
          f"{terms['memory_s']:.5f}, dominant {terms['dominant']}: "
          f"{100 * terms['compute_s'] / (ev_ms / 1e3):.1f}% of the compute "
          f"bound reached; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    _profile_prefill(card, run, f"{tag} prefill")

    def decode(c, tok, n, mode=None):
        outs = []
        with torch.inference_mode():
            for i in range(n):
                lg, c = model.decode_step(params, tok, c, p + i, mode=mode)
                tok = lg.argmax(-1, keepdim=True)
                outs.append(lg)
        return outs, c

    main = {"self": [{k: v.clone() for k, v in c.items()}
                     for c in cache["self"]], "cross": cache["cross"]}
    first = logits.argmax(-1, keepdim=True)
    torch.cuda.reset_peak_memory_stats()
    ((outs, main), wall, ev_ms), counts = _launches(
        lambda: _timed(lambda: decode(main, first, WHISPER_DECODE)))
    want = {k: v * WHISPER_DECODE for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"{tag} decode: launches {counts}, expected "
                             f"{want}")
    if not all(bool(torch.isfinite(lg).all()) for lg in outs):
        raise AssertionError(f"{tag} decode: non-finite logits")
    mid = p + WHISPER_DECODE // 2
    floor = _whisper_floor_bytes(params, main, b, mid)
    cross_b = sum(t.numel() * t.element_size() for c in main["cross"]
                  for t in c.values())
    step_ms = ev_ms / WHISPER_DECODE
    floor_ms = floor / HBM_BYTES_PER_S * 1e3
    print(f"{tag} decode: {WHISPER_DECODE} greedy steps at positions {p}-"
          f"{p + WHISPER_DECODE - 1}, B={b}: launches {json.dumps(counts)} "
          f"({json.dumps(per_step)} a step); "
          f"{wall / WHISPER_DECODE * 1e3:.3f} ms a step wall, {step_ms:.3f} "
          f"ms between events, {b * WHISPER_DECODE / wall:.1f} tokens/s; "
          f"byte floor at position {mid} {floor / 1e9:.3f} GB (cross K/V "
          f"{cross_b / 1e9:.3f} GB), {floor_ms:.3f} ms at the memory rate, "
          f"{step_ms / floor_ms:.1f}x it; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del outs
    _profile_prefill(card, lambda: decode(main, first, 2),
                     f"{tag} decode (2 steps)")
    del main

    # the kernels against mode="ref": prefill logits, cache rows, and each
    # encoder layer's output (the prefill's encoder runs _layer_forward
    # once a layer, its decoder _layer_prefill)
    gen = torch.Generator(device="cuda").manual_seed(11)
    plain_norm = trops.rmsnorm
    ulp = _ulp_norm(plain_norm, gen)
    # the planted faults: lost rows of the middle encoder layer's norm2
    # (its FFN's input), which the layer check must see, and of its norm1
    # (the attention's input), read and printed only: on random weights
    # the attention adds little to a row, and losing its input moves the
    # row less than the one-ulp control's 24 layers of rounding do
    fault_layer = cfg.n_enc_layers // 2
    lost = (f"fault: {FAMILY_FAULT_ROWS} rows of encoder layer "
            f"{fault_layer}'s norm2 lost")
    lost1 = (f"fault (read only): {FAMILY_FAULT_ROWS} rows of its norm1 "
             "lost")

    def kept(mode=None, norm=None):
        outs, fwd = [], blocks._layer_forward

        def layer(*a, **kw):
            x, aux = fwd(*a, **kw)
            outs.append(x)
            return x, aux
        with mock.patch.object(blocks, "_layer_forward", layer), (
                mock.patch.object(trops, "rmsnorm", norm) if norm
                else contextlib.nullcontext()):
            return run(mode), outs
    _, k_layers = kept()
    (ref_logits, ref_cache), r_layers = kept("ref")
    (ctl_logits, ctl_cache), c_layers = kept("ref", ulp)
    (f_logits, f_cache), f_layers = kept("ref", _lost_rows_norm(
        plain_norm, 2 * fault_layer + 1, FAMILY_FAULT_ROWS))
    (f1_logits, f1_cache), f1_layers = kept("ref", _lost_rows_norm(
        plain_norm, 2 * fault_layer, FAMILY_FAULT_ROWS))

    def rels(lg, c):
        return (_rel(lg, ref_logits),
                _cache_rel(c["self"], ref_cache["self"], p),
                _cache_rel(c["cross"], ref_cache["cross"], WHISPER_FRAMES))

    def by_layer(outs):
        """each encoder layer's worst row ||x - x_ref|| / ||x_ref|| (a row:
        one frame of one clip)"""
        return [float(((a.float() - r.float()).norm(dim=-1)
                       / r.float().norm(dim=-1).clamp_min(1e-30)).max())
                for a, r in zip(outs, r_layers)]
    rel = {"kernels": rels(logits, cache),
           "control: one ulp": rels(ctl_logits, ctl_cache),
           lost: rels(f_logits, f_cache),
           lost1: rels(f1_logits, f1_cache)}
    layer_rel = {"kernels": by_layer(k_layers),
                 "control: one ulp": by_layer(c_layers),
                 lost: by_layer(f_layers), lost1: by_layer(f1_layers)}
    del f_logits, f_cache, f1_logits, f1_cache
    del k_layers, r_layers, c_layers, f_layers, f1_layers
    lim = tuple(2 * c for c in rel["control: one ulp"])
    layer_lim = [2 * c for c in layer_rel["control: one ulp"]]
    print(f"{tag} vs ref, prefill: ||logits - logits_ref|| / ||logits_ref||"
          f", the worst self-cache row's and the worst cross K/V row's "
          f"||c - c_ref|| / ||c_ref||: "
          + ", ".join(f"{k} {a:.3e}, {s_:.3e}, {x:.3e}"
                      for k, (a, s_, x) in rel.items())
          + f"; limits {lim[0]:.3e}, {lim[1]:.3e}, {lim[2]:.3e} (2x the "
          f"one-ulp control) [{card}]")
    print(f"{tag} vs ref, prefill: each encoder layer's worst row "
          f"||x - x_ref|| / ||x_ref||, layers 0-{cfg.n_enc_layers - 1}: "
          + "; ".join(f"{k} " + " ".join(f"{v:.2e}" for v in vals)
                      for k, vals in layer_rel.items())
          + "; limits (2x the one-ulp control) "
          + " ".join(f"{v:.2e}" for v in layer_lim) + f" [{card}]")
    _margin_check(f"{tag} vs ref, prefill", logits, ref_logits, card)
    if any(k > x for k, x in zip(rel["kernels"], lim)) or any(
            k > x for k, x in zip(layer_rel["kernels"], layer_lim)):
        raise AssertionError(f"{tag}: the kernels disagree with ref "
                             f"({rel['kernels']} > {lim}, or an encoder "
                             "layer's worst row above its limit)")
    if not any(f > x for f, x in zip(layer_rel[lost], layer_lim)):
        raise AssertionError(f"{tag}: the lost encoder rows stay inside "
                             "every layer's limit, so the check cannot see "
                             "them")

    # 4 teacher-forced steps (the kernels' greedy tokens fed to all three)
    tok = logits.argmax(-1, keepdim=True)
    agree, worst, limit = 0, 0.0, 0.0
    with torch.inference_mode():
        for i in range(FAMILY_GREEDY):
            lk, cache = model.decode_step(params, tok, cache, p + i)
            lr, ref_cache = model.decode_step(params, tok, ref_cache, p + i,
                                              mode="ref")
            with mock.patch.object(trops, "rmsnorm", ulp):
                lc, ctl_cache = model.decode_step(params, tok, ctl_cache,
                                                  p + i, mode="ref")
            worst = max(worst, _rel(lk, lr))
            limit = max(limit, 2 * _rel(lc, lr))
            agree += _margin_check(f"{tag} vs ref, decode step {i}", lk, lr,
                                   card)
            tok = lk.argmax(-1, keepdim=True)
    print(f"{tag} vs ref, {FAMILY_GREEDY} teacher-forced decode steps: "
          f"greedy tokens agree {agree}/{FAMILY_GREEDY * b}; worst "
          f"||logits - logits_ref|| / ||logits_ref|| {worst:.3e}, limit "
          f"{limit:.3e} (2x the step's one-ulp control) [{card}]")
    if worst > limit:
        raise AssertionError(f"{tag}: decode steps disagree with ref "
                             f"({worst:.3e} > {limit:.3e})")
    del logits, cache, ref_logits, ref_cache, ctl_logits, ctl_cache
    torch.cuda.empty_cache()

    # the serving invariant at B=1: prefill S tokens, one decode step
    s = WHISPER_INVARIANT_S
    toks = torch.as_tensor(np.concatenate([WHISPER_PROMPT, rng.integers(
        0, cfg.vocab_size, s + 1 - p)])[None], device="cuda")
    one = {"tokens": toks[:, :s], "frames": frames[:1]}
    lp, c1 = model.prefill(params, one, max_len=WHISPER_MAX_LEN)
    with torch.inference_mode():
        ld, _ = model.decode_step(params, toks[:, s:], c1, s)
    with torch.no_grad():
        full = model.logits(params, {"tokens": toks, "frames": frames[:1]})
    lr = model.prefill(params, one, max_len=s, mode="ref")[0]
    with mock.patch.object(trops, "rmsnorm", ulp):
        lc = model.prefill(params, one, max_len=s, mode="ref")[0]
    ctl = _rel(lc, lr)
    rel_p, rel_d = _rel(lp, full[:, s - 1]), _rel(ld, full[:, s])
    print(f"{tag} invariant, B=1: prefill of {s} tokens vs logits of all "
          f"{s + 1} at position {s - 1}: {rel_p:.3e}; one decode step vs "
          f"position {s}: {rel_d:.3e}; limit {2 * ctl:.3e} (2x the one-ulp "
          f"control of the prefill's logits, {ctl:.3e}) [{card}]")
    _margin_check(f"{tag} invariant, decode vs full", ld, full[:, s], card)
    if max(rel_p, rel_d) > 2 * ctl:
        raise AssertionError(f"{tag}: prefill + decode disagree with the "
                             f"full forward ({rel_p:.3e}, {rel_d:.3e} > "
                             f"{2 * ctl:.3e})")
    del params, c1, frames, batch
    torch.cuda.empty_cache()


# train-families: (arch, layers kept or None for all, B, S); full width,
# depth cut where the f32 state (p, g, m, v: 16 B a parameter) does not
# fit the card, and for the script's time limit: Mamba-2's to 8 of 64
# layers (8-10 s a step at 64), InternVL2-2B's to 12 of 24 and
# Qwen3-MoE's to 2 of 48 (its 4 of 48 took 69 s)
TRAIN_FAMILY_CELLS = (("whisper-medium", None, 2, WHISPER_MAX_LEN),
                      ("mamba2-2.7b", 8, 2, 4096),
                      ("internvl2-2b", 12, 2, 4096),
                      ("qwen3-moe-30b-a3b", 2, 2, 4096))
TRAIN_FAMILY_STEPS = 3


def _train_family(card: str, arch: str, layers, b: int, s: int) -> None:
    """One family trains through ``launch.steps.build_train_step`` (AdamW
    at its defaults, the state from seed 0, the builder's seeded batch,
    remat): three steps, each counted (rmsnorm twice per layer norm, as
    remat recomputes the layer, plus the final norm and enc_norm once;
    one adamw_update launch per parameter dtype) and timed, the third
    profiled.  Then the state after those steps (m and v warm) is copied
    to the host, and ``_in_model_train`` holds the next step of the
    kernels against mode="ref" from it."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import steps
    from repro_torch.models.lm import build_model, norm_calls
    from repro_torch.train import optimizer as opt
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=b,
                                seq_len=s)
    tag = f"train-families {arch}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step_fn, (state, batch) = steps.build_train_step(cfg, shape, "cuda")
    torch.cuda.synchronize()
    named = dict(state["params"].named_parameters())
    n_params = sum(t.numel() for t in named.values())
    tokens = b * (s + cfg.n_prefix_embeds) + (
        b * cfg.enc_seq if cfg.encdec else 0)
    print(f"{tag}: n_layers={cfg.n_layers}"
          + (f" + {cfg.n_enc_layers} encoder" if cfg.encdec else "")
          + f" d_model={cfg.d_model}, {n_params / 1e9:.3f}B params in "
          f"{len(named)} tensors, f32 state {16 * n_params / 1e9:.1f} GB "
          f"(p, g, m, v), compute {cfg.compute_dtype}; batch "
          + ", ".join(f"{k} {list(v.shape)}" for k, v in batch.items())
          + f"; built in {time.perf_counter() - t0:.1f} s [{card}]")
    # remat runs each layer's norms twice; the final norm and enc_norm once
    want = {"rmsnorm": 2 * norm_calls(state["params"]) - 1 - cfg.encdec,
            "adamw_update": len({p.dtype for p in named.values()})}
    del named
    walls = []
    # device activity only: a Mamba2 step is some 150k kernels, and host
    # op events would multiply the profile's processing time
    prof = profile(activities=[ProfilerActivity.CUDA])
    for i in range(TRAIN_FAMILY_STEPS):
        last = i == TRAIN_FAMILY_STEPS - 1
        with prof if last else contextlib.nullcontext():
            ((state, m), wall, _), counts = _launches(
                lambda: _timed(lambda: step_fn(state, batch)))
        if counts != want:
            raise AssertionError(f"{tag} step {i}: launches {counts}, "
                                 f"expected {want}")
        m = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(x) for x in m.values()):
            raise AssertionError(f"{tag} step {i}: non-finite {m}")
        walls.append(wall)
        print(f"{tag} step {i}: loss {m['loss']:.4f} nll {m['nll']:.4f} aux "
              f"{m['aux']:.4f} grad_norm {m['grad_norm']:.4f} lr "
              f"{m['lr']:.3e}; wall {wall:.3f} s, {tokens / wall:.0f} "
              f"tokens/s{' (profiled)' if last else ''}; launches "
              f"{json.dumps(counts)} [{card}]")
    peak = torch.cuda.max_memory_allocated()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev(e) > 0]
    dev_ms = sum(dev(e) for e in kernels) / 1e3
    rms_ms = sum(dev(e) for e in kernels if "rmsnorm" in e.key) / 1e3
    adamw_ms = sum(dev(e) for e in kernels if "adamw" in e.key) / 1e3
    print(f"{tag}: {TRAIN_FAMILY_STEPS} steps, step 1 wall {walls[1]:.3f} s "
          f"({tokens / walls[1]:.0f} tokens/s, tokens = B x (S + prefix) "
          f"+ B x frames); step {TRAIN_FAMILY_STEPS - 1} profiled: device "
          f"kernels {dev_ms:.1f} ms, {100 * dev_ms / (walls[1] * 1e3):.1f}% "
          f"busy against step 1's unprofiled wall; rmsnorm kernel "
          f"{rms_ms:.2f} ms, adamw_update kernel {adamw_ms:.2f} ms (its "
          f"bound {28 * n_params / HBM_BYTES_PER_S * 1e3:.2f} ms); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB [{card}]")
    for e in sorted(kernels, key=dev, reverse=True)[:8]:
        print(f"  {dev(e) / 1e3:9.3f} ms {100 * dev(e) / 1e3 / dev_ms:5.1f}% "
              f"{e.count:6d} calls  {e.key[:90]}")
    del prof, kernels
    t0 = time.perf_counter()
    snap = _host_tree(state)
    print(f"{tag}: state after step {TRAIN_FAMILY_STEPS - 1} copied to the "
          f"host in {time.perf_counter() - t0:.1f} s [{card}]")
    _in_model_train(card, f"{tag} vs ref", build_model(cfg),
                    opt.AdamWConfig(), step_fn, state, snap, batch)
    del snap, state, step_fn
    torch.cuda.empty_cache()


def phase_train_families(card: str) -> None:
    """Training of the non-dense families at full width (the cells of
    ``TRAIN_FAMILY_CELLS``), each cell's seconds printed."""
    import gc
    import torch
    for arch, layers, b, s in TRAIN_FAMILY_CELLS:
        t0 = time.perf_counter()
        _train_family(card, arch, layers, b, s)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"train-families {arch}: {time.perf_counter() - t0:.1f} s "
              f"[{card}]")


SHARDS = (2, 4, 8)                  # the sharded phase's static splits
SHARD_LAYERS = 2                    # (c2)'s depth: four ranks share a card
SHARD_ENGINE_REQUESTS = 4           # (b)'s requests: the serve phase's first
SHARD_REQUESTS = 4                  # (c2)'s requests: the serve phase's first
# a sharded bf16 output against another path's: |d| <= atol + rtol *
# (|ref| + the largest |partial out| of the shards).  Each shard's out is
# rounded to bf16 before the merge (half an ulp of |o_k|, carried through
# the weighted mean), then the merged out and the other path's out round
# once each (half an ulp of |out| each): 2^-8 (max|o_k| + 2 |out|) in
# all, under 2^-7 (|ref| + max|o_k|); atol covers f32 reassociation
SHARD_TOL = (2.0 ** -7, 1e-4)


def _partial_scale(q, kc, vc, kv_len, k):
    """The largest |out| of the ``k`` shards' partial outputs, each
    element (the plain version)."""
    import torch
    from repro_torch.kernels.decode_attn import ops as dops
    sp = kc.shape[1] // k
    return torch.stack([dops.decode_attn(
        q, kc[:, j * sp:(j + 1) * sp], vc[:, j * sp:(j + 1) * sp],
        (kv_len - j * sp).clamp(0, sp), mode="ref").float().abs()
        for j in range(k)]).amax(0)


def _held(what, got, want, scale, lse=None, want_lse=None) -> float:
    """Max |d| of a sharded bf16 decode output against another path's,
    within :data:`SHARD_TOL` of ``|want| + scale`` (``scale`` from
    :func:`_partial_scale`), and of its lse within 1e-4; raises
    outside."""
    import torch
    rtol, atol = SHARD_TOL
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: shape or finiteness")
    if not bool((d <= atol + rtol * (w.abs() + scale)).all()):
        raise AssertionError(f"{what}: out disagrees (max |d|={d.max():g})")
    if lse is not None:
        dl = (lse - want_lse).abs()
        if not bool((dl <= 1e-4 + 1e-4 * want_lse.abs()).all()):
            raise AssertionError(f"{what}: lse disagrees (max "
                                 f"|d|={dl.max():g})")
    return float(d.max())


def _sharded_op(card: str) -> None:
    """(a) The static split at Yi-9B's heads, B=4 x S=4096 at 2, 4 and 8
    shards (and B=8 x S=32768 at 4), kv_len uniform and 17-64: against
    the unsharded kernel and mode="ref", its launches, its time and each
    slice's beside the unsharded call's, and merge_partials alone."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.decode_attn import sharded as dsh
    hkv, dh, hq = 4, 128, 32
    rng = np.random.default_rng(29)
    gen = torch.Generator(device="cuda").manual_seed(29)
    print(f"sharded (a): tolerance out |d| <= {SHARD_TOL[1]:g} + "
          f"{SHARD_TOL[0]:g}*(|ref| + max_k |o_k|) (each shard's out o_k "
          "rounds to bf16 before the merge), lse 1e-4; timed in CUDA "
          f"graphs, every output held [{card}]")
    cases = [(SERVE_SLOTS, SERVE_MAX_LEN, k) for k in SHARDS] + [(8, 32768, 4)]
    for b, s, k in cases:
        sp = s // k

        def make():
            q, kc, vc = (torch.randn(*shape, generator=gen, device="cuda")
                         .bfloat16() for shape in ((b, hq, dh),
                                                   (b, s, hkv, dh),
                                                   (b, s, hkv, dh)))
            return q, kc, vc
        sets0 = _copies(make, 2 * b * s * hkv * dh * 2)
        for kind in ("uniform", "17-64"):
            lo, hi = (1, s + 1) if kind == "uniform" else (17, 65)
            kv_len = torch.as_tensor(rng.integers(lo, hi, b), device="cuda")
            sets = [(q, kc, vc, kv_len) for q, kc, vc in sets0]
            q, kc, vc, _ = sets[0]
            for kern in cuda.KERNELS.values():
                kern.launches = 0
            out, lse = dsh.decode_attn_sharded(q, kc, vc, kv_len, shards=k,
                                               with_lse=True)  # main path
            torch.cuda.synchronize()
            counts = {n: cuda.KERNELS[n].launches
                      for n in ("decode_attn", "decode_attn_merge")}
            if counts != {"decode_attn": k, "decode_attn_merge": k}:
                raise AssertionError(f"sharded B={b} S={s} K={k}: launches "
                                     f"{counts}, expected {k} each")
            one, one_lse = dops.decode_attn(q, kc, vc, kv_len, with_lse=True)
            ref, ref_lse = dsh.decode_attn_sharded(q, kc, vc, kv_len,
                                                   shards=k, mode="ref",
                                                   with_lse=True)
            what = f"sharded B={b} S={s} K={k} kv_len {kind}"
            scale = _partial_scale(q, kc, vc, kv_len, k)
            e1 = _held(f"{what} vs unsharded", out, one, scale, lse, one_lse)
            e2 = _held(f"{what} vs ref", out, ref, scale, lse, ref_lse)
            ms = device_ms(lambda *a: dsh.decode_attn_sharded(
                *a[:3], a[3], shards=k), sets, hold=True)
            ms1 = device_ms(lambda *a: dops.decode_attn(*a), sets, hold=True)
            plain = device_ms(lambda *a: dsh.decode_attn_sharded(
                *a[:3], a[3], shards=k, mode="ref"), sets[:1], reps=4,
                hold=True)
            slices = []
            for j in range(k):
                local = (kv_len - j * sp).clamp(0, sp)
                slices.append(device_ms(lambda *a: dops.decode_attn(
                    a[0], a[1][:, j * sp:(j + 1) * sp],
                    a[2][:, j * sp:(j + 1) * sp], local, with_lse=True),
                    sets, hold=True))
            parts = [dops.decode_attn(q, kc[:, j * sp:(j + 1) * sp],
                                      vc[:, j * sp:(j + 1) * sp],
                                      (kv_len - j * sp).clamp(0, sp),
                                      with_lse=True) for j in range(k)]
            p_sets = [(torch.stack([o for o, _ in parts]),
                       torch.stack([ls for _, ls in parts]))]
            ms_m = device_ms(dsh.merge_partials, p_sets, hold=True)
            rows = int(kv_len.sum())
            nbytes = (2 * rows * hkv * dh * 2 + b * hq * dh * 2 * 2
                      + b * hq * 4)
            bms, by = bound_ms(nbytes, 4.0 * rows * hq * dh, "bfloat16")
            print(f"{what} (Yi-9B heads {hq}/{hkv}x{dh} bf16, slices "
                  f"[{b}, {sp}] read in place, batch pitch {s}): "
                  f"max_abs_err vs unsharded {e1:g}, vs ref {e2:g}; "
                  f"ms={ms:.5f} (K split + K merge + merge_partials) "
                  f"unsharded_ms={ms1:.5f} plain_ms={plain:.5f} "
                  f"bound_ms={bms:.6f} ({by}, sum(kv_len)={rows}) "
                  f"{ms / bms:.2f}x bound; each slice's ms "
                  f"{[round(t, 5) for t in slices]}; merge_partials alone "
                  f"ms={ms_m:.5f}; launches {json.dumps(counts)} [{card}]")
            del sets, parts, p_sets
        del sets0
        torch.cuda.empty_cache()


def _busy(card, what, step, steps: int = 3) -> tuple[float, float]:
    """(wall ms, device-kernel ms) of one ``step()`` over ``steps`` calls
    after two warm ones (torch.profiler for the device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    dev_ms = sum(dev(e) for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")
                 and dev(e) > 0) / steps / 1e3
    print(f"sharded {what}: decode step wall {wall:.3f} ms, device kernels "
          f"{dev_ms:.3f} ms ({100 * dev_ms / wall:.1f}% busy) over {steps} "
          f"steps [{card}]")
    return wall, dev_ms


def _sharded_engine(card: str, model, params, engine, served) -> None:
    """(b) The serve phase's Yi-9B (full width and depth) and its first
    :data:`SHARD_ENGINE_REQUESTS` requests at ServeConfig(shards=4)
    through the static split on one card: the
    launches a step, the greedy tokens against the shards=1 run, a
    teacher-forced step's logits within 2x a one-ulp control with a lost
    shard above it, and the decode-step time and busy share of both."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.decode_attn import sharded as dsh
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg, k = model.cfg, 4
    eng = ServingEngine(model, params, ServeConfig(
        slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, max_new_tokens=SERVE_NEW,
        shards=k))
    rng = np.random.default_rng(0)            # the serve phase's prompts
    for uid in range(SHARD_ENGINE_REQUESTS):
        eng.submit(uid, rng.integers(0, cfg.vocab_size,
                                     int(rng.integers(8, 65))))
    for kern in cuda.KERNELS.values():
        kern.launches = 0
    results = eng.run()
    torch.cuda.synchronize()
    counts = {n: kern.launches for n, kern in cuda.KERNELS.items()
              if kern.launches}
    st = eng.stats()
    steps = st["decode_steps"] + st["prefill_steps"]
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * steps,
            "decode_attn": k * cfg.n_layers * steps,
            "decode_attn_merge": k * cfg.n_layers * steps}
    if counts != want:
        raise AssertionError(f"sharded (b): launches {counts}, expected "
                             f"{want} over {steps} steps")
    same = sum(int(a == b) for uid in results
               for a, b in zip(results[uid], served[uid]))
    total = sum(len(served[uid]) for uid in results)
    print(f"sharded (b): {cfg.name} {cfg.n_layers} layers, shards={k} "
          f"(static split on one card), {len(results)} requests: launches "
          f"a step {json.dumps({n: c / steps for n, c in counts.items()})}; "
          f"greedy tokens agree with shards=1 on {same}/{total}; "
          f"mean_decode_step_s {st['mean_decode_step_s']:.6f} (shards=1: "
          f"{engine.stats()['mean_decode_step_s']:.6f}) [{card}]")
    del eng

    # one teacher-forced step from a cache filled at the served rows'
    # scale, row r's position in shard r: shards=4 against shards=1
    gen = torch.Generator(device="cuda").manual_seed(29)
    b, s = SERVE_SLOTS, SERVE_MAX_LEN
    sp = s // k
    pos = torch.as_tensor([r * sp + int(rng.integers(16, sp - 2))
                           for r in range(b)], device="cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, 1)),
                           device="cuda")
    cache0 = [{n: (torch.randn(t.shape, generator=gen, device="cuda")
                   * float(t[:, :8].float().std())).to(t.dtype)
               for n, t in layer.items()} for layer in engine.cache]
    plain_op, plain_merge = dops.decode_attn, dsh.merge_partials

    def one_ulp(q, kc, vc, kv_len=None, **kw):
        return _ulp_moved(plain_op(q, kc, vc, kv_len, **kw), gen)

    def lost_shard(outs, lses):              # shard 1's lse dropped
        keep = [j for j in range(outs.shape[0]) if j != 1]
        return plain_merge(outs[keep], lses[keep])

    def run(shards, op=None, merge=None):
        cache = [{n: t.clone() for n, t in c.items()} for c in cache0]
        dops.decode_attn, dsh.merge_partials = op or plain_op, \
            merge or plain_merge
        try:
            with torch.inference_mode():
                return model.decode_step(params, toks, cache, pos,
                                         shards=shards)[0].float()
        finally:
            dops.decode_attn, dsh.merge_partials = plain_op, plain_merge

    want_l = run(1)
    reads = {"shards=4": run(k), "control: one ulp": run(1, op=one_ulp),
             "fault: shard 1's lse dropped": run(k, merge=lost_shard)}
    rel = {n: float((lg - want_l).norm() / want_l.norm())
           for n, lg in reads.items()}
    tol = 2 * rel["control: one ulp"]
    print(f"sharded (b): teacher-forced step at positions {pos.tolist()} "
          f"(row r in shard r), ||logits - logits(shards=1)|| / ||.||: "
          + ", ".join(f"{n} {v:.3e}" for n, v in rel.items())
          + f"; limit {tol:.3e} (2x the one-ulp control) [{card}]")
    _margin_check("sharded (b) teacher-forced", reads["shards=4"], want_l,
                  card)
    if not bool(torch.isfinite(reads["shards=4"]).all()):
        raise AssertionError("sharded (b): non-finite logits")
    if rel["shards=4"] > tol:
        raise AssertionError(f"sharded (b): shards=4 logits outside the "
                             f"limit ({rel['shards=4']:.3e} > {tol:.3e})")
    if rel["fault: shard 1's lse dropped"] <= tol:
        raise AssertionError("sharded (b): a dropped shard stays inside the "
                             "limit, so the check cannot see it")
    cache = [{n: t.clone() for n, t in c.items()} for c in cache0]
    for shards in (1, k):
        _busy(card, f"(b) shards={shards}", lambda: model.decode_step(
            params, toks, cache, pos, shards=shards))
    del cache, cache0
    torch.cuda.empty_cache()


def _collective_rank(rank: int, world: int, prompts: dict) -> dict:
    """(c) One rank of ``world`` on this card over gloo (``_gloo_spawn``):
    the collective op on the rank's slice at the serve shape, then the
    engine over ``serving_ctx(world)`` with Yi-9B at full width and
    :data:`SHARD_LAYERS` layers."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.kernels.decode_attn import kernel as dk
    from repro_torch.kernels.decode_attn import sharded as dsh
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServingEngine, serving_ctx
    ctx = serving_ctx(world)
    b, s, hkv, dh, hq = SERVE_SLOTS, SERVE_MAX_LEN, 4, 128, 32
    sp = s // world
    gen = torch.Generator(device="cuda").manual_seed(7)   # every rank alike
    q, kc, vc = (torch.randn(*shape, generator=gen, device="cuda")
                 .bfloat16() for shape in ((b, hq, dh), (b, s, hkv, dh),
                                           (b, s, hkv, dh)))
    lo = ctx.tp_rank * sp
    kl, vl = kc[:, lo:lo + sp].clone(), vc[:, lo:lo + sp].clone()
    del kc, vc
    res = {"op": []}
    for kv in ([3000, 4096, 1, 2048], [17, 64, 40, 33]):
        kv_len = torch.tensor(kv, device="cuda")
        n0 = dk.SPLIT.launches
        got = dsh.decode_attn_collective(q, kl, vl, kv_len, ctx=ctx)
        torch.cuda.synchronize()
        res["op"].append((kv, got.cpu(), dk.SPLIT.launches - n0))
    cfg = dataclasses.replace(get_config("yi-9b"), n_layers=SHARD_LAYERS)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    eng = ServingEngine(model, params, ServeConfig(
        slots=b, max_len=s, max_new_tokens=SERVE_NEW, shards=world),
        ctx=ctx)
    for uid, p in prompts.items():
        eng.submit(uid, p)
    for kern in cuda.KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    res["tokens"] = eng.run()
    torch.cuda.synchronize()
    res["wall"] = time.perf_counter() - t0
    res["stats"] = eng.stats()
    res["launches"] = {n: kern.launches
                       for n, kern in cuda.KERNELS.items()
                       if kern.launches}
    res["cache"] = tuple(eng.cache[0]["k"].shape)
    res["memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


GLOO_CONTEXT_GIB = 1.0         # a gloo rank's CUDA context, outside its cap


def _gloo_rank(rank: int, world: int, store: str, fn, job, out: str,
               cap) -> None:
    """One gloo rank of this card (spawned by ``_gloo_spawn``):
    ``fn(rank, world, job)``, its result saved to ``out + rank``; its
    allocator held to ``cap`` of the card's memory."""
    import torch
    import torch.distributed as dist
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"         # loopback only
    torch.set_num_threads(2)                        # 4 ranks, 8 cores
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
        torch.cuda.set_per_process_memory_fraction(cap, 0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        torch.save(fn(rank, world, job), f"{out}{rank}")
    finally:
        dist.destroy_process_group()


def _gloo_spawn(fn, world: int, job) -> list:
    """``world`` ranks as processes (spawn), all on cuda:0 (NCCL refuses
    two ranks on one device) over gloo with a FileStore in a temporary
    directory, each running ``fn(rank, world, job)``: their results, in
    rank order.  A rank that fails fails the call.  The ranks share the
    card: each rank's allocator is held to an equal share of what is free
    now, less :data:`GLOO_CONTEXT_GIB` a rank (past its share it frees
    its cached blocks before it asks for more), and grows its segments in
    place, so that no rank's cache starves another."""
    import torch
    import torch.multiprocessing as mp
    cap = None
    if torch.cuda.is_available():
        free, total = torch.cuda.mem_get_info()
        cap = (free / 2 ** 30 - world * GLOO_CONTEXT_GIB) / world / (
            total / 2 ** 30)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        mp.start_processes(_gloo_rank, args=(
            world, os.path.join(tmp, "store"), fn, job,
            os.path.join(tmp, "rank"), cap), nprocs=world,
            start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}"), weights_only=False)
                for r in range(world)]
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        shutil.rmtree(tmp, ignore_errors=True)


def _sharded_collective(card: str) -> None:
    """(c) The collective merge on the card: 4 ranks as processes (spawn),
    all on cuda:0 (NCCL refuses two ranks on one device) over gloo with a
    FileStore in a temporary directory, each holding only its
    [B, S/4, Hkv, dh] slice.  (c1) the op against the unsharded kernel on
    the whole cache; (c2) the engine over serving_ctx(4), Yi-9B at full
    width and 4 of 48 layers (four copies of the weights share the card):
    every rank's tokens against rank 0's, the one-process static split's
    at shards=4 (the conformance oracle) and the shards=1 run's."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServingEngine
    world = 4
    cfg = dataclasses.replace(get_config("yi-9b"), n_layers=SHARD_LAYERS)
    rng = np.random.default_rng(0)            # the serve phase's prompts
    prompts = {uid: rng.integers(0, cfg.vocab_size, int(rng.integers(8, 65)))
               for uid in range(SHARD_REQUESTS)}
    t0 = time.perf_counter()
    ranks = _gloo_spawn(_collective_rank, world, prompts)
    spawn_s = time.perf_counter() - t0

    # (c1) against the unsharded kernel on the whole cache
    b, s, hkv, dh, hq = SERVE_SLOTS, SERVE_MAX_LEN, 4, 128, 32
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, kc, vc = (torch.randn(*shape, generator=gen, device="cuda").bfloat16()
                 for shape in ((b, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    for i, (kv, _, _) in enumerate(ranks[0]["op"]):
        kv_len = torch.tensor(kv, device="cuda")
        want = dops.decode_attn(q, kc, vc, kv_len)
        scale = _partial_scale(q, kc, vc, kv_len, world)
        errs = [_held(f"sharded (c1) rank {r} kv_len {kv}",
                      res["op"][i][1].cuda(), want, scale)
                for r, res in enumerate(ranks)]
        print(f"sharded (c1): {world} gloo ranks on one card, each its "
              f"[{b}, {s // world}, {hkv}, {dh}] slice, kv_len {kv}: max_abs_err "
              f"vs the unsharded kernel per rank "
              f"{[round(e, 6) for e in errs]}; split launches a rank "
              f"{[res['op'][i][2] for res in ranks]} [{card}]")
    del q, kc, vc

    # (c2) the engine: one process, static split and unsharded, same weights
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")

    def serve(shards):
        eng = ServingEngine(model, params, ServeConfig(
            slots=b, max_len=s, max_new_tokens=SERVE_NEW, shards=shards))
        for uid, p in prompts.items():
            eng.submit(uid, p)
        return eng.run(), eng.stats()
    static, st_static = serve(world)
    one, st_one = serve(1)
    del model, params
    torch.cuda.empty_cache()
    total = sum(len(v) for v in one.values())
    for r, res in enumerate(ranks):
        if res["tokens"] != ranks[0]["tokens"]:
            raise AssertionError(f"sharded (c2): rank {r}'s tokens differ "
                                 "from rank 0's")
        if res["cache"] != (b, s // world, cfg.n_kv_heads, cfg.head_dim):
            raise AssertionError(f"sharded (c2): rank {r} holds a cache of "
                                 f"{res['cache']}")
        n = SHARD_LAYERS * (res["stats"]["decode_steps"]
                            + res["stats"]["prefill_steps"])
        want = {"rmsnorm": (2 * SHARD_LAYERS + 1) * n // SHARD_LAYERS,
                "decode_attn": n, "decode_attn_merge": n}
        if res["launches"] != want:
            raise AssertionError(f"sharded (c2): rank {r} launched "
                                 f"{res['launches']}, expected {want}")
    got = ranks[0]["tokens"]
    if got != static:
        raise AssertionError("sharded (c2): the collective tokens differ "
                             "from the one-process static split's")
    agree = sum(int(x == y) for uid in one
                for x, y in zip(got[uid], one[uid]))
    st = ranks[0]["stats"]
    print(f"sharded (c2): {cfg.name} full width, {SHARD_LAYERS} layers, "
          f"{world} gloo ranks on one card, cache {ranks[0]['cache']} a "
          f"rank and layer: every rank's tokens equal rank 0's and the "
          f"static split's (shards={world}); {agree}/{total} equal the "
          f"shards=1 run's; launches on rank 0 {json.dumps(ranks[0]['launches'])}"
          f" over {st['decode_steps'] + st['prefill_steps']} steps; "
          f"mean_decode_step_s collective {st['mean_decode_step_s']:.6f}, "
          f"static {st_static['mean_decode_step_s']:.6f}, shards=1 "
          f"{st_one['mean_decode_step_s']:.6f}; engine wall a rank "
          f"{[round(res['wall'], 2) for res in ranks]} s, peak memory a "
          f"rank {[round(res['memory_gib'], 2) for res in ranks]} GiB; the "
          f"{world} processes took {spawn_s:.1f} s [{card}]")


def phase_sharded(card: str, model, params, engine, served) -> None:
    """Sequence-sharded serving (``kernels/decode_attn/sharded.py``,
    ``serve/sharded.py``): (a) the static split at the serve shape,
    (b) the engine at shards=4 on the serve phase's weights, (c) the
    collective merge over 4 gloo ranks on this card.  (b) serves the
    serve phase's 8 requests: its steps are host-bound, about twice a
    shards=1 step, so (c2) serves the first :data:`SHARD_REQUESTS`."""
    _sharded_op(card)
    _sharded_engine(card, model, params, engine, served)
    _sharded_collective(card)


# --------------------------------------------------------- train_sharded

TS_LAYERS = 2                  # (a), (c), (d): Yi-9B at full width, 2 of 48
TS_STEPS = 2                   # steps compared; (a) and (c) run one more
TS_B, TS_S = 2, 4096           # (a)'s global batch: one row a rank
TS_OCFG = dict(lr=3e-3, warmup_steps=10, total_steps=50)
TS_COMP = ("internvl2-2b", 2, 4, 512)       # (b): arch, layers, B, S
TS_EP = ("qwen3-moe-30b-a3b", 2)              # (e): arch, layers (TS_B x TS_S)
TS_EP32_SHAPE = (2, 1024)      # (e) in f32: its global batch B x S
# one step: at the second a router near-tie (top-k margin 1.9e-7) routes
# one token differently on the EP ranks (PERF.md, Findings), and no
# one-ulp control bounds what one rerouted token does to AdamW's update
TS_EP32_STEPS = 1
TS_SEQ = ("starcoder2-7b", 2, 1, 1024, 8)      # (f): arch, layers, B, S, ranks
TS_SEQ_STEPS = 3
TS_DEVICE = "cuda"
TS_DATA4 = 4                   # the four-card run's data axis (shapes)


def _ts_cfg(arch: str, layers: int):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=layers)


def _ts_batches(cfg, b: int, s: int, n: int) -> list:
    """``n`` global batches from seeded numpy: tokens, and a VLM's
    ``prefix_embeds`` (standard normal, f32)."""
    import numpy as np
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s),
                                        dtype=np.int32)}
        if cfg.n_prefix_embeds:
            batch["prefix_embeds"] = rng.standard_normal(
                (b, cfg.n_prefix_embeds, cfg.d_model), dtype=np.float32)
        out.append(batch)
    return out


def _on(batch: dict) -> dict:
    import torch
    return {k: torch.from_numpy(v).to(TS_DEVICE) for k, v in batch.items()}


def _ts_steps(step_fn, state, batches, res, after=None) -> None:
    """Run ``batches`` through ``step_fn``, each step with the counts set
    to 0 just before and read just after and its collectives recorded;
    ``after(i, state)`` after step i."""
    import torch
    from repro_torch.sharding import collectives
    for i, b in enumerate(batches):
        batch = _on(b)
        t0 = time.perf_counter()
        with collectives.recording() as log:
            (state, m), counts = _launches(lambda: step_fn(state, batch))
        res["wall"].append(time.perf_counter() - t0)
        res["metrics"].append({k: float(v) for k, v in m.items()})
        res["launches"].append(counts)
        res["wire"].append(collectives.summarize(log))
        res["int8_wire"] = sum(r.wire_bytes for r in log
                               if r.dtype == "int8")
        if after is not None:
            after(i, state)
    res["memory_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                         if TS_DEVICE == "cuda" else 0.0)
    res["reserved_gib"] = (torch.cuda.max_memory_reserved() / 2 ** 30
                           if TS_DEVICE == "cuda" else 0.0)


def _ts_plain(rank: int, world: int, job: dict) -> dict:
    """(a), then (d), on this rank (``_gloo_spawn``): Yi-9B ZeRO-3 over
    data=world, TS_STEPS + 1 steps, the state saved (sharded) after
    TS_STEPS; then the same model tensor-parallel over model=world
    (``_ts_tp``)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import build_model
    from repro_torch.train import AdamWConfig, trainstep
    cfg = _ts_cfg("yi-9b", TS_LAYERS)
    model = build_model(cfg)
    mesh = make_mesh((world, 1), ("data", "model"))
    ctx = steps.mesh_ctx(mesh)
    state = trainstep.init_state(model, seed=0, device=TS_DEVICE, ctx=ctx)
    step = trainstep.make_train_step(model, AdamWConfig(**TS_OCFG), ctx=ctx)
    mgr = CheckpointManager(job["ckpt"], keep=1, async_save=False)
    shardings = steps.state_shardings(steps.abstract_state(model), cfg, mesh)
    res = {"metrics": [], "launches": [], "wall": [], "wire": [],
           "local": {k: tuple(p.shape) for k, p in
                     state["params"].named_parameters()}}

    def save(i, state):
        if i + 1 == TS_STEPS:
            t0 = time.perf_counter()
            mgr.save(TS_STEPS, trainstep.state_tree(state), shardings)
            mgr.wait()
            res["save_s"] = time.perf_counter() - t0
    _ts_steps(step, state, job["batches"], res, save)
    del state, step, mgr
    if TS_DEVICE == "cuda":
        import torch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out = {"a": res, "d": _ts_tp(_ts_cfg("yi-9b", TS_LAYERS), world,
                                 job["batches"], TS_STEPS)}
    if TS_DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out["e"] = _ts_tp(_ts_cfg(*TS_EP), world, job["ep_batches"], TS_STEPS)
    if TS_DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    routes = []
    with _ts_routes(routes):
        out["e32"] = _ts_tp(_ts_f32(_ts_cfg(*TS_EP)), world,
                            job["ep32_batches"], TS_EP32_STEPS)
    out["e32"]["routes"] = routes
    return out


def _ts_routes(log: list):
    """A patch of ``moe._route`` that appends each call's picks (the
    top-k expert ids, sorted, [t, k]) and top-k margins (the k-th less
    the (k+1)-th probability, [t]) to ``log``, on the host."""
    from unittest import mock
    import torch
    from repro_torch.models import moe
    route = moe._route

    def recorded(xt, router_w, e, ctx=None):
        probs, gates, idx = route(xt, router_w, e, ctx)
        top = torch.topk(probs.detach(), e.top_k + 1, dim=-1).values
        log.append((idx.detach().sort(-1).values.cpu(),
                    (top[:, -2] - top[:, -1]).cpu()))
        return probs, gates, idx
    return mock.patch.object(moe, "_route", recorded)


def _ts_route_check(part: str, ranks: list, one: list, t: int) -> str:
    """Each route call of the expert-parallel ranks (``ranks``, a log of
    :func:`_ts_routes` each, rank r routing tokens [r · ts, (r + 1) ·
    ts) of the ``t``) picks, token by token, the experts the one-process
    step's same call (``one``) picks.  A token that differs is reported
    with its margin in the one-process step.  Returns the line's text."""
    if any(len(log) != len(one) for log in ranks):
        raise AssertionError(f"train_sharded {part}: route calls "
                             f"{[len(log) for log in ranks]}, one process "
                             f"{len(one)}")
    ts = -(-t // len(ranks))
    bad = []
    for c, (ids, margin) in enumerate(one):
        for r, log in enumerate(ranks):
            n = min(ts, t - r * ts)
            diff = (log[c][0][:n] != ids[r * ts:r * ts + n]).any(-1)
            bad += [(c, r * ts + int(i), float(margin[r * ts + int(i)]))
                    for i in diff.nonzero().flatten()]
    if bad:
        raise AssertionError(f"train_sharded {part}: tokens routed unlike "
                             f"the one-process step (call, token, its top-k "
                             f"margin there): {bad[:8]} of {len(bad)}")
    least = min(float(m.min()) for _, m in one)
    return (f"every pick of {len(one)} route calls x {t} tokens the "
            f"one-process step's (least top-k margin {least:.3e})")


def _ts_f32(cfg):
    """``cfg`` computing in f32 (its params are f32 in training)."""
    import dataclasses
    return dataclasses.replace(cfg, compute_dtype="float32")


def _ts_seq(rank: int, world: int, job: dict) -> dict:
    """(f) on this rank (``_gloo_spawn``): StarCoder2-7B over
    model=world, its 36 heads undivided (``_ts_tp``), in its bf16
    compute and then in f32."""
    cfg = _ts_cfg(*TS_SEQ[:2])
    out = {"bf16": _ts_tp(cfg, world, job["batches"], TS_SEQ_STEPS)}
    if TS_DEVICE == "cuda":
        import torch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out["f32"] = _ts_tp(_ts_f32(cfg), world, job["batches"], TS_SEQ_STEPS)
    return out


def _ts_tp(cfg, world: int, batches, keep_after: int) -> dict:
    """(d), (e) or (f) on this rank: ``cfg`` tensor-parallel over
    model=world (Megatron heads and FFN, the vocab-parallel embedding,
    head and loss, the layer boundaries sequence-sharded at S / world >=
    128; a MoE's experts E / world a rank, exchanged by all_to_all; heads
    the ranks do not divide on the sequence-sharded attention), from
    seed 0, every batch's step counted and recorded; after
    ``keep_after`` steps the whole params gathered to rank 0's host
    (``Shard.gather(dst=0)``)."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import build_model
    from repro_torch.train import AdamWConfig, trainstep
    model = build_model(cfg)
    mesh = make_mesh((1, world), ("data", "model"))
    ctx = steps.mesh_ctx(mesh)
    state = trainstep.init_state(model, seed=0, device=TS_DEVICE, ctx=ctx)
    step = trainstep.make_train_step(model, AdamWConfig(**TS_OCFG), ctx=ctx)
    shards = steps.state_shardings(steps.abstract_state(model), cfg,
                                   mesh)["params"]
    res = {"metrics": [], "launches": [], "wall": [], "wire": [],
           "local": {k: tuple(p.shape) for k, p in
                     state["params"].named_parameters()}}

    def keep(i, state):
        if i + 1 == keep_after:
            whole = {k: shards[k].gather(p.detach(), dst=0)
                     for k, p in state["params"].named_parameters()}
            res["p"] = None if whole["embed"] is None else {
                k: t.to("cpu", copy=True) for k, t in whole.items()}
    _ts_steps(step, state, batches, res, keep)
    return res


def _ts_pod_mean(grads, ef, ctx, names) -> tuple:
    """For one JAX leaf (``names``, compressed as one tensor): this rank's
    corrected gradient ``c`` (grad + residual, flat), its exact mean over
    ``pod`` (an f32 all-reduce, outside the recorded collectives), and
    the first hop's scale s1 = max |c| / 127 and max |exact mean|, both
    over every rank."""
    import torch
    import torch.distributed as dist
    c = torch.empty(sum(ef[k].numel() for k in names),
                    dtype=torch.float32, device=ef[names[0]].device)
    o = 0
    for k in names:                 # filled in place: no per-name copies
        n = ef[k].numel()
        c[o:o + n].copy_(grads[k].reshape(-1)).add_(ef[k].reshape(-1))
        o += n
    exact = c.clone()
    dist.all_reduce(exact, group=ctx.pod_group)
    exact /= ctx.pod
    m = torch.stack([c.abs().max(), exact.abs().max()])
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    return c, exact, float(m[0]) / 127, float(m[1])


def _ts_split(flat, like: dict, names) -> dict:
    out = flat.split([like[k].numel() for k in names])
    return {k: o.reshape(like[k].shape) for k, o in zip(names, out)}


def _ts_checked_sync(real, checks: list):
    """``compression.ef_compressed_pmean`` that also holds every synced
    element against the exact pod mean of its corrected gradient: within
    s1 / 2 + s2 / 2, the two hops' rounding (s2, the second hop's scale,
    is at most (max |exact mean| + s1 / 2) / 127), plus 1e-6 of the
    largest mean for the f32 products.  Appends, each step, the worst
    element's error over that bound and over s1."""

    def sync(grads, ef, ctx, groups=None):
        synced, new_ef = real(grads, ef, ctx, groups)
        worst, quanta = 0.0, 0.0
        for names in groups:
            # in place, so that the check holds at most two copies of a
            # leaf beside the step's own (the ranks share one card)
            c, exact, s1, mx = _ts_pod_mean(grads, ef, ctx, names)
            del c
            o = 0
            for k in names:
                n = synced[k].numel()
                exact[o:o + n].sub_(synced[k].reshape(-1))
                o += n
            err = float(exact.abs_().max())
            del exact
            bound = s1 / 2 + (mx + s1 / 2) / 127 / 2 + 1e-6 * mx
            worst = max(worst, err / max(bound, 1e-30))
            quanta = max(quanta, err / max(s1, 1e-30))
        checks.append((worst, quanta))
        return synced, new_ef
    return sync


def _ts_grid_sync(grads, ef, ctx, groups=None):
    """The one-quantum control for ``ef_compressed_pmean``: the exact pod
    mean of each corrected gradient rounded to a grid of step 2 s1, so
    each element moves by up to one quantum s1, as far as the two hops
    together may move it (s1 / 2 + s2 / 2); the residual carried as the
    compressed sync carries it."""
    synced, new_ef = {}, {}
    for names in groups:
        c, s, s1, _ = _ts_pod_mean(grads, ef, ctx, names)
        q = 2 * max(s1, 1e-30)
        s.div_(q).round_().mul_(q)
        synced.update(_ts_split(s, grads, names))
        new_ef.update(_ts_split(c.sub_(s), grads, names))
    return synced, new_ef


def _ts_compressed(rank: int, world: int, job: dict) -> dict:
    """(b) on this rank (``_gloo_spawn``), at pod=2, data=world/2, from
    seed 0 on the same batches: "compressed", the int8 error-feedback
    step, each sync held element by element (``_ts_checked_sync``);
    "plain", the uncompressed sharded step; "grid", the compressed step
    with its sync replaced by the one-quantum control
    (``_ts_grid_sync``)."""
    import contextlib
    from unittest import mock
    import torch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import build_model
    from repro_torch.train import AdamWConfig, compression, trainstep
    arch, layers, _, _ = TS_COMP
    cfg = _ts_cfg(arch, layers)
    model = build_model(cfg)
    mesh = make_mesh((2, world // 2, 1), ("pod", "data", "model"))
    ctx = steps.mesh_ctx(mesh)
    ocfg = AdamWConfig(**TS_OCFG)
    out = {"checks": []}
    for run in ("compressed", "plain", "grid"):
        if run == "plain":
            state = trainstep.init_state(model, seed=0, device=TS_DEVICE,
                                         ctx=ctx)
            step = trainstep.make_train_step(model, ocfg, ctx=ctx)
            patch = contextlib.nullcontext()
        else:
            state = trainstep.init_compressed_state(
                model, seed=0, device=TS_DEVICE, ctx=ctx)
            step = trainstep.make_compressed_train_step(model, ocfg, ctx)
            patch = mock.patch.object(
                compression, "ef_compressed_pmean",
                _ts_checked_sync(compression.ef_compressed_pmean,
                                 out["checks"])
                if run == "compressed" else _ts_grid_sync)
        res = {"metrics": [], "launches": [], "wall": [], "wire": []}
        if run == "compressed":
            res["groups"] = [sum(state["params"].get_parameter(n).numel()
                                 for n in names)
                             for names in trainstep.jax_leaf_groups(cfg)]
            res["n_local"] = sum(p.numel()
                                 for p in state["params"].parameters())
        with patch:
            _ts_steps(step, state, job["batches"], res)
        out[run] = res
        del state, step
        if TS_DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


def _ts_one_process(model, batches, move=None, keep=None,
                    keep_after=TS_STEPS, slices=None) -> dict:
    """The one-process step (the card's main path, as the train phase
    runs it) over ``batches`` from seed 0: metrics, and with ``keep`` the
    p0 and the params after ``keep_after`` steps on the host (without
    ``keep`` those params only).  ``move``: every rmsnorm output passed
    through it (a control: ``_ulp_moved`` or ``_ulp_moved_by_low_bit``).
    ``slices``: the MoE under the capacity rule of that many slices
    (``moe_forward`` with a ctx of ``tp = slices`` that is not
    tensor-parallel)."""
    import types
    from unittest import mock
    import torch
    from repro_torch.kernels.rmsnorm import ops as trops
    from repro_torch.models import blocks
    from repro_torch.train import AdamWConfig, trainstep
    state = trainstep.init_state(model, seed=0, device=TS_DEVICE)
    step = trainstep.make_train_step(model, AdamWConfig(**TS_OCFG))
    out = {"metrics": [], "p0": None, "p": None}
    if keep:
        out["p0"] = {k: p.detach().to("cpu", copy=True) for k, p in
                     state["params"].named_parameters()}
    patches = contextlib.ExitStack()
    if move is not None:
        patches.enter_context(mock.patch.object(
            trops, "rmsnorm", _moved_norm(trops.rmsnorm, move)))
    if slices is not None:
        ctx = types.SimpleNamespace(tp=slices, tensor_parallel=False)
        layer = blocks._layer_forward

        def capped(p, x, cfg, rope, causal=True, mode=None, kv=None,
                   _ctx=None):
            return layer(p, x, cfg, rope, causal, mode, kv, ctx)
        patches.enter_context(mock.patch.object(blocks, "_layer_forward",
                                                capped))
    with patches:
        for i, b in enumerate(batches):
            state, m = step(state, _on(b))
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if i + 1 == keep_after:
                out["p"] = {k: p.detach().to("cpu", copy=True) for k, p
                            in state["params"].named_parameters()}
    del state
    if TS_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def _update_gap(got: dict, ref: dict, p0: dict) -> float:
    """||p_got - p_ref|| / ||p_ref - p0|| over every parameter."""
    num = sum(float((got[k].float() - ref[k].float()).norm() ** 2)
              for k in ref)
    den = sum(float((ref[k].float() - p0[k].float()).norm() ** 2)
              for k in ref)
    return math.sqrt(num / den)


def _ts_adamw_shards(card: str) -> None:
    """``adamw_update`` at the shard shapes of (a) (data=2) and of the
    four-card run (data=4) of Yi-9B: each kernel output equal to the
    plain version's (|d| = 0, as check_adamw); the kernel's, the plain
    version's and ``torch._fused_adamw_``'s device time (``device_ms``,
    inputs past L2) and the bound (28 bytes an element over the memory
    rate).  Then ``adamw_update_many`` over the whole leaf set of one of
    (a)'s ranks (``_adamw_list``)."""
    import torch
    from repro_torch.kernels.adamw import _HYPER
    from repro_torch.kernels.adamw import ops as aops
    from repro_torch.models.lm import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.layout import shard_of

    class Stub:
        axis_names = ("data", "model")

        def __init__(self, d):
            self.shape = {"data": d, "model": 1}
    cfg = _ts_cfg("yi-9b", 1)
    meta = dict(build_model(cfg).init(device="meta",
                                      trainable=True).named_parameters())
    gen = torch.Generator(device=TS_DEVICE).manual_seed(16)
    for d in (2, TS_DATA4):
        mesh = Stub(d)
        specs = rules.param_specs(meta, cfg, mesh)
        shapes = sorted({shard_of(tuple(p.shape), specs[k], mesh,
                                  {"data": 0, "model": 0}).local_shape
                         for k, p in meta.items() if "data" in specs[k]})
        for shape in shapes:
            p, g, m = (torch.randn(*shape, generator=gen, device=TS_DEVICE)
                       for _ in range(3))
            v = torch.rand(*shape, generator=gen, device=TS_DEVICE)
            (got, counts) = _launches(lambda: aops.adamw_update(
                p, g, m, v, **_HYPER))
            ref = aops.adamw_update(p, g, m, v, mode="ref", **_HYPER)
            err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            if err != 0 or counts != {"adamw_update": 1}:
                raise AssertionError(f"train_sharded adamw {shape}: |d| "
                                     f"{err}, launches {counts}")
            n = p.numel()
            s7 = torch.stack(aops.scalars(p.device, *_HYPER.values())).unbind()
            step = torch.ones((), device=TS_DEVICE)
            sets = _copies(lambda: tuple(t.clone() for t in (p, g, m, v)),
                           16 * n)
            ms = device_ms(lambda *a: aops.adamw_update(*a, *s7), sets)
            plain = device_ms(lambda *a: aops.adamw_update(
                *a, *s7, mode="ref"), sets)

            def library(p, g, m, v):
                torch._fused_adamw_([p], [g], [m], [v], [], [step],
                                    lr=_HYPER["lr"], beta1=0.9, beta2=0.999,
                                    weight_decay=_HYPER["wd"],
                                    eps=_HYPER["eps"], amsgrad=False,
                                    maximize=False)
            lib = device_ms(library, [tuple(t.clone() for t in a)
                                      for a in sets])
            bms, by = bound_ms(28 * n, ADAMW_FLOPS * n, "float32")
            print(f"train_sharded adamw shard data={d} {list(shape)} f32: "
                  f"max_abs_err={err:g} ms={ms:.5f} plain_ms={plain:.5f} "
                  f"bound_ms={bms:.6f} ({by}) library_ms={lib:.5f} "
                  f"(torch._fused_adamw_) [{card}]")
            del sets
            del p, g, m, v, got, ref
    # (a)'s rank's leaves (its shards of the layers, the embedding, head
    # and final norm whole) in one launch, as its optimizer runs them
    _adamw_list(card, "train_sharded adamw list data=2",
                _yi9b_leaves(TS_LAYERS, 2), gen)


def _ts_limit(ref, *ctls):
    """``limit(key, i)``: twice the farthest of the controls ``ctls``
    from the one-process step's metric ``key`` at step i, plus 1e-6
    relative."""
    def limit(key, i):
        r = ref["metrics"][i][key]
        return (2 * max(abs(c["metrics"][i][key] - r) for c in ctls)
                + 1e-6 * abs(r))
    return limit


def _ts_ctl(gen_seed: int):
    """The one-ulp control's move, its signs drawn from a generator on
    the card seeded ``gen_seed``."""
    import torch
    return functools.partial(_ulp_moved, gen=torch.Generator(
        device=TS_DEVICE).manual_seed(gen_seed))


def _ts_tp_check(card, part, cfg, ranks, ref, ctls, shape, kept, what,
                 ref_name="one process") -> None:
    """(d), (e) or (f)'s checks (``part``) against the one-process step
    ``ref`` (``ref_name``) and the controls ``ctls`` ({name: run}) on
    global batches of
    ``shape`` (B, S): every rank's metrics alike; each step's loss and
    grad norm within twice the farthest control's distance plus 1e-6
    relative; the params after ``kept`` steps by ||p - p_1|| / ||p_1 -
    p_0|| within twice the farthest control's plus 1e-6; launches a rank
    a step rmsnorm 4 · layers + 1 (each on its S / world rows),
    adamw_update 1; a rank's counted wire bytes a step, by kind, equal to
    ``sharded_step_wire``'s ring model of the layout.  ``what(rank 0's
    result)``: the line's description of the layout.  Every step's line
    is printed before a failure is raised."""
    from repro_torch.roofline.analysis import sharded_step_wire
    world = len(ranks)
    b, s = shape
    limit = _ts_limit(ref, *ctls.values())
    want = {"rmsnorm": 4 * cfg.n_layers + 1, "adamw_update": 1}
    ring = sharded_step_wire(cfg, {"data": 1, "model": world}, b, s)
    for r, res in enumerate(ranks):
        if res["metrics"] != ranks[0]["metrics"]:
            raise AssertionError(f"train_sharded {part}: rank {r}'s "
                                 "metrics differ from rank 0's")
        for i, (counts, wire) in enumerate(zip(res["launches"],
                                               res["wire"])):
            if counts != want:
                raise AssertionError(f"train_sharded {part} rank {r} step "
                                     f"{i}: launches {counts}, expected "
                                     f"{want}")
            got = wire["collective_wire_bytes"]
            if set(got) != set(ring) or any(
                    abs(got[k] - ring[k]) > 1e-9 * ring[k] for k in ring):
                raise AssertionError(f"train_sharded {part} rank {r} step "
                                     f"{i}: wire bytes {got}, the ring "
                                     f"model of the layout {ring}")
    d = ranks[0]
    bad = []
    for i in range(len(d["metrics"])):
        for key in ("loss", "grad_norm"):
            got, one = d["metrics"][i][key], ref["metrics"][i][key]
            if not math.isfinite(got) or abs(got - one) > limit(key, i):
                bad.append(f"train_sharded {part} step {i} {key}: {got} vs "
                           f"{ref_name} {one} (|d| {abs(got - one):.3e} > "
                           f"{limit(key, i):.3e})")
        m = d["metrics"][i]
        print(f"train_sharded {part} step {i}: " + "; ".join(
            f"{key} {m[key]:.6f} ({ref_name} "
            f"{ref['metrics'][i][key]:.6f}, " + ", ".join(
                f"{name} {c['metrics'][i][key]:.6f}"
                for name, c in ctls.items()) + ")"
            for key in ("loss", "grad_norm"))
              + f"; wall a rank {[round(x['wall'][i], 3) for x in ranks]} "
              f"s; launches a rank {json.dumps(d['launches'][i])}; wire "
              f"bytes a rank "
              f"{json.dumps(d['wire'][i]['collective_wire_bytes'])} (by axis "
              f"{json.dumps(d['wire'][i]['collective_wire_bytes_by_axis'])}) "
              f"= the ring model [{card}]")
    gap_d = _update_gap(d["p"], ref["p"], ref["p0"])
    gaps = {name: _update_gap(c["p"], ref["p"], ref["p0"])
            for name, c in ctls.items()}
    gap_c = max(gaps.values())
    ctl_text = ", ".join(f"{name} {g:.3e}" for name, g in gaps.items())
    if gap_d > 2 * gap_c + 1e-6:
        bad.append(f"train_sharded {part}: params {gap_d:.3e} of the "
                   f"update from the {ref_name}'s ({ctl_text})")
    if bad:
        raise AssertionError("; ".join(bad))
    print(f"train_sharded {part}: {cfg.name} full width, {cfg.n_layers} "
          f"layers, {cfg.compute_dtype} compute, tensor-parallel over "
          f"model={world} ({world} gloo ranks "
          f"on one card), global batch {b} x {s}, the layer boundaries "
          f"sequence-sharded ({s // world} rows a rank); {what(d)}; params "
          f"after {kept} steps {gap_d:.3e} of the update away from the "
          f"{ref_name}'s ({ctl_text}; limit twice the farthest); steps a "
          f"rank "
          f"{len(d['metrics'])}; peak memory a rank "
          f"{[round(x['memory_gib'], 2) for x in ranks]} GiB [{card}]")


def _ts_seqshard(card: str) -> None:
    """(f): StarCoder2-7B over model=8, in its bf16 compute and in f32,
    each against the f32 one-process step (``phase_train_sharded``)."""
    import torch
    from repro_torch.models.lm import build_model
    _, _, b, s, world = TS_SEQ
    cfg = _ts_cfg(*TS_SEQ[:2])
    cfg32 = _ts_f32(cfg)
    model, model32 = build_model(cfg), build_model(cfg32)
    batches = _ts_batches(cfg, b, s, TS_SEQ_STEPS)
    kw = dict(keep_after=TS_SEQ_STEPS)
    ref = _ts_one_process(model32, batches, keep=True, **kw)
    ctl = _ts_one_process(model32, batches, _ts_ctl(5), **kw)
    one16 = _ts_one_process(model, batches, **kw)
    ctl16 = _ts_one_process(model, batches, _ts_ctl(5), **kw)
    free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    t0 = time.perf_counter()
    ranks = _gloo_spawn(_ts_seq, world, {"batches": batches})
    spawn_s = time.perf_counter() - t0

    def what(d):
        return (f"{cfg.n_heads} heads undivided, the sequence-sharded "
                f"attention: local wq {d['local']['blocks.0.attn.wq']}, wk "
                f"{d['local']['blocks.0.attn.wk']}, wo "
                f"{d['local']['blocks.0.attn.wo']} (whole), w_in "
                f"{d['local']['blocks.0.ffn.w_in']}, embed "
                f"{d['local']['embed']}; {free_gib:.2f} GiB free on the "
                f"card before the spawn, each rank capped at "
                f"{free_gib / world - GLOO_CONTEXT_GIB:.2f} GiB; the "
                f"{world} processes took {spawn_s:.1f} s")
    # bf16 against the f32 one-process step, as far from it as the bf16
    # one-process step and its one-ulp control are (both ~1% of each
    # gradient apart from f32); then f32 against its one-ulp control
    _ts_tp_check(card, "(f)", cfg, [r["bf16"] for r in ranks], ref,
                 {"bf16 one process": one16, "its one-ulp control": ctl16},
                 (b, s), TS_SEQ_STEPS, what, "f32 one process")
    _ts_tp_check(card, "(f) f32", cfg32, [r["f32"] for r in ranks], ref,
                 {"one-ulp control": ctl}, (b, s), TS_SEQ_STEPS, what)
    del ranks, ref, ctl, one16, ctl16
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_sharded(card: str) -> None:
    """Training across ranks on this card (``train.zero``,
    ``train.compression``, ``checkpoint.manager`` with shardings,
    ``runtime.elastic``), every rank a gloo process on cuda:0 (NCCL
    refuses two ranks on one device).  (a) Yi-9B at full width, 2 of 48
    layers, ZeRO-3 over data=2, global batch 2 x 4096, TS_STEPS + 1
    steps, each counted on each rank; held against the one-process step
    on the same batches: each step's loss and grad norm, and the params
    after TS_STEPS steps by ||p_a - p_1|| / ||p_1 - p_0||, each within
    twice the one-ulp control's (the one-process run with every rmsnorm
    output moved one ulp) plus 1e-6 relative.  (c) The checkpoint (a)
    saved after TS_STEPS steps restored by remesh_state onto one rank
    (the params compared there) and run one step: its loss and grad norm
    against (a)'s and the one-process step's, the same limit.  (b) 4
    ranks at pod=2, data=2 on InternVL2-2B (full width, 2 layers) run
    the compressed step, the uncompressed sharded step and the
    one-quantum control (``_ts_compressed``) on the same batches: every
    rank's metrics alike and finite in each; each synced gradient element
    within the two hops' rounding of the exact pod mean; step 0's loss
    (the same forward pass) within 1e-6 relative of the uncompressed
    step's; step 0's grad norm and step 1's loss and grad norm within
    twice the control's distance from the uncompressed step's plus 1e-6
    relative; the int8 wire bytes counted against ``wire_bytes``.  (d)
    After (a), in its two processes, Yi-9B tensor-parallel over model=2
    (``_ts_tp``, ``_ts_tp_check``): the same batches and steps held
    against the same one-process step and control, the same limits, the
    launches a rank a step, and the wire bytes against the ring model of
    the layout.  (e) After (d), in the same processes, Qwen3-MoE-30B-A3B
    (full width, 2 of 48 layers) expert-parallel over model=2 on 2 x
    4096 tokens (64 of its 128 experts a rank, capacity buffers [128,
    320, 2048] exchanged by all_to_all), TS_STEPS steps, held the same
    way against the one-process step with its MoE under the same
    capacity rule (2 slices) and that step's one-ulp control (each move
    by the output's low bit, as the MoE's recompute needs); then the same
    in f32 compute on 2 x 1024 tokens (TS_EP32_SHAPE), one step, a
    tight check of the same path, its every token routed as the
    one-process step routes it (``_ts_route_check``).  (f)
    StarCoder2-7B (full width, 2 of 32 layers) over model=8, its 36
    heads undivided (the sequence-sharded attention, 128 query rows a
    rank), 8 gloo ranks, 1 x 1024 tokens, TS_SEQ_STEPS steps: in its
    bf16 compute held against the f32 one-process step, the limits twice
    the farther of the bf16 one-process step and its one-ulp control
    from it; in f32 against the same step and its one-ulp control.  Then
    ``adamw_update`` at Yi-9B's shard shapes against its plain
    version."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import steps
    from repro_torch.models.lm import build_model
    from repro_torch.runtime import remesh_state
    from repro_torch.train import AdamWConfig, compression, trainstep
    cfg = _ts_cfg("yi-9b", TS_LAYERS)
    model = build_model(cfg)
    batches = _ts_batches(cfg, TS_B, TS_S, TS_STEPS + 1)
    ref = _ts_one_process(model, batches, keep=True)
    ctl = _ts_one_process(model, batches, _ts_ctl(5))
    ep_cfg = _ts_cfg(*TS_EP)
    ep_model = build_model(ep_cfg)
    ep_batches = _ts_batches(ep_cfg, TS_B, TS_S, TS_STEPS)
    ep_ref = _ts_one_process(ep_model, ep_batches, keep=True, slices=2)
    ep_ctl = _ts_one_process(ep_model, ep_batches, _ulp_moved_by_low_bit,
                             slices=2)
    ep32_batches = _ts_batches(ep_cfg, *TS_EP32_SHAPE, TS_EP32_STEPS)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ts_ckpt_")
    try:
        t0 = time.perf_counter()
        both = _gloo_spawn(_ts_plain, 2, {"batches": batches, "ckpt": ckpt,
                                          "ep_batches": ep_batches,
                                          "ep32_batches": ep32_batches})
        spawn_s = time.perf_counter() - t0
        ranks = [r["a"] for r in both]
        tp_ranks = [r["d"] for r in both]
        ep_ranks = [r["e"] for r in both]
        ep32_ranks = [r["e32"] for r in both]
        del both
        # every leaf and gradient f32: one AdamW launch a rank a step
        want = {"rmsnorm": 4 * TS_LAYERS + 1, "adamw_update": 1}
        for r, res in enumerate(ranks):
            if res["metrics"] != ranks[0]["metrics"]:
                raise AssertionError(f"train_sharded (a): rank {r}'s "
                                     "metrics differ from rank 0's")
            for i, counts in enumerate(res["launches"]):
                if counts != want:
                    raise AssertionError(f"train_sharded (a) rank {r} step "
                                         f"{i}: launches {counts}, expected "
                                         f"{want}")
        a = ranks[0]
        limit = _ts_limit(ref, ctl)
        for i in range(TS_STEPS + 1):
            for key in ("loss", "grad_norm"):
                d = abs(a["metrics"][i][key] - ref["metrics"][i][key])
                if not math.isfinite(a["metrics"][i][key]) or d > limit(key,
                                                                         i):
                    raise AssertionError(
                        f"train_sharded (a) step {i} {key}: "
                        f"{a['metrics'][i][key]} vs one-process "
                        f"{ref['metrics'][i][key]} (|d| {d:.3e} > "
                        f"{limit(key, i):.3e})")
            print(f"train_sharded (a) step {i}: loss "
                  f"{a['metrics'][i]['loss']:.6f} (one process "
                  f"{ref['metrics'][i]['loss']:.6f}, one-ulp control "
                  f"{ctl['metrics'][i]['loss']:.6f}) grad_norm "
                  f"{a['metrics'][i]['grad_norm']:.6f} (one process "
                  f"{ref['metrics'][i]['grad_norm']:.6f}, control "
                  f"{ctl['metrics'][i]['grad_norm']:.6f}); wall a rank "
                  f"{[round(x['wall'][i], 3) for x in ranks]} s; launches "
                  f"a rank {json.dumps(a['launches'][i])}; wire bytes a rank "
                  f"{json.dumps(a['wire'][i]['collective_wire_bytes'])} "
                  f"[{card}]")
        print(f"train_sharded (a): {cfg.name} full width, {TS_LAYERS} "
              f"layers, ZeRO-3 over data=2 (2 gloo ranks on one card), "
              f"global batch {TS_B} x {TS_S}; local wq {a['local']['blocks.0.attn.wq']}, "
              f"wo {a['local']['blocks.0.attn.wo']}, embed "
              f"{a['local']['embed']}; checkpoint saved in "
              f"{a['save_s']:.1f} s; peak memory a rank "
              f"{[round(x['memory_gib'], 2) for x in ranks]} GiB; the 2 "
              f"processes took {spawn_s:.1f} s [{card}]")

        # (c) restore (a)'s checkpoint onto one rank and run on
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ts_pg_")
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mgr = CheckpointManager(ckpt)
            step0, tree, mesh = remesh_state(
                mgr, cfg, lambda: steps.abstract_state(model), 1,
                model_parallel=1, device=TS_DEVICE)
            t_restore = time.perf_counter() - t0
            gap_a = _update_gap({k: t.cpu() for k, t in
                                 tree["params"].items()}, ref["p"],
                                ref["p0"])
            gap_c = _update_gap(ctl["p"], ref["p"], ref["p0"])
            if gap_a > 2 * gap_c + 1e-6:
                raise AssertionError(f"train_sharded (a): params after "
                                     f"{TS_STEPS} steps {gap_a:.3e} of the "
                                     f"update from the one process's, "
                                     f"control {gap_c:.3e}")
            ctx = steps.mesh_ctx(mesh)
            state = trainstep.init_state(model, seed=1, device=TS_DEVICE,
                                         ctx=ctx)
            trainstep.load_state_tree(state, tree)
            del tree
            step = trainstep.make_train_step(model, AdamWConfig(**TS_OCFG),
                                             ctx=ctx)
            (state, m), counts = _launches(
                lambda: step(state, _on(batches[TS_STEPS])))
            mc = {k: float(v) for k, v in m.items()}
            del state, step, m
        finally:
            dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)
        i = TS_STEPS
        for key in ("loss", "grad_norm"):
            for what, other in (("(a)", a["metrics"][i][key]),
                                ("one process", ref["metrics"][i][key])):
                d = abs(mc[key] - other)
                if d > limit(key, i):
                    raise AssertionError(f"train_sharded (c) {key}: "
                                         f"{mc[key]} vs {what} {other}")
        _ts_tp_check(card, "(d)", cfg, tp_ranks, ref,
                     {"one-ulp control": ctl}, (TS_B, TS_S),
                     TS_STEPS, lambda d: (
                         f"local wq {d['local']['blocks.0.attn.wq']}, wk "
                         f"{d['local']['blocks.0.attn.wk']}, wo "
                         f"{d['local']['blocks.0.attn.wo']}, w_in "
                         f"{d['local']['blocks.0.ffn.w_in']}, embed "
                         f"{d['local']['embed']}, head {d['local']['head']}"))
        del tp_ranks
        from repro_torch.models import moe

        def ep_what(b, s, size):
            t_ep, cap = moe.capacity(b * s, 2, ep_cfg.moe)
            buf = ep_cfg.moe.n_experts * cap * ep_cfg.d_model * size

            def what(d):
                a2a = d["wire"][0]["collective_wire_bytes"]["all-to-all"]
                return (f"expert-parallel: local w_in "
                        f"{d['local']['blocks.0.moe.w_in']}, w_out "
                        f"{d['local']['blocks.0.moe.w_out']}, router "
                        f"{d['local']['blocks.0.moe.router']}; {t_ep} "
                        f"tokens a rank's slice, cap {cap}, a capacity "
                        f"buffer [{ep_cfg.moe.n_experts}, {cap}, "
                        f"{ep_cfg.d_model}] of {buf / 1e6:.1f} MB, "
                        f"all-to-all wire a rank a step {a2a / 1e9:.3f} "
                        f"GB; against the one-process step with 2 "
                        f"capacity slices")
            return what
        _ts_tp_check(card, "(e)", ep_cfg, ep_ranks, ep_ref,
                     {"one-ulp control": ep_ctl}, (TS_B, TS_S), TS_STEPS,
                     ep_what(TS_B, TS_S, 2))
        del ep_ranks, ep_ref, ep_ctl, ep_model
        gc.collect()
        # (e) in f32, where a sum's order moves the result by ulps, not
        # bf16 roundings: a tight check of the same path
        ep32_cfg = _ts_f32(ep_cfg)
        ep32_model = build_model(ep32_cfg)
        routes = []
        with _ts_routes(routes):
            ep32_ref = _ts_one_process(ep32_model, ep32_batches, keep=True,
                                       keep_after=TS_EP32_STEPS, slices=2)
        ep32_ctl = _ts_one_process(ep32_model, ep32_batches,
                                   _ulp_moved_by_low_bit,
                                   keep_after=TS_EP32_STEPS, slices=2)
        agreed = _ts_route_check("(e) f32", [r["routes"] for r in ep32_ranks],
                                 routes, math.prod(TS_EP32_SHAPE))
        what32 = ep_what(*TS_EP32_SHAPE, 4)
        _ts_tp_check(card, "(e) f32", ep32_cfg, ep32_ranks, ep32_ref,
                     {"one-ulp control": ep32_ctl}, TS_EP32_SHAPE,
                     TS_EP32_STEPS, lambda d: f"{what32(d)}; {agreed}")
        del ep32_ranks, ep32_ref, ep32_ctl
        print(f"train_sharded (c): (a)'s checkpoint at step {step0} "
              f"restored by remesh_state onto {tuple(mesh.shape)} "
              f"{tuple(mesh.mesh_dim_names)} in {t_restore:.1f} s; params "
              f"after {TS_STEPS} steps {gap_a:.3e} of the update away from "
              f"the one process's (control {gap_c:.3e}, limit twice it); "
              f"step {i}: loss {mc['loss']:.6f} ((a) "
              f"{a['metrics'][i]['loss']:.6f}, one process "
              f"{ref['metrics'][i]['loss']:.6f}) grad_norm "
              f"{mc['grad_norm']:.6f} ((a) {a['metrics'][i]['grad_norm']:.6f},"
              f" one process {ref['metrics'][i]['grad_norm']:.6f}); launches "
              f"{json.dumps(counts)} [{card}]")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del ref, ctl
    gc.collect()
    if TS_DEVICE == "cuda":
        torch.cuda.empty_cache()
    _ts_seqshard(card)

    # (b) the compressed step on 4 ranks, against the uncompressed one
    arch, layers, b, s = TS_COMP
    ccfg = _ts_cfg(arch, layers)
    free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    t0 = time.perf_counter()
    ranks = _gloo_spawn(_ts_compressed, 4, {"batches": _ts_batches(
        ccfg, b, s, TS_STEPS)})
    spawn_s = time.perf_counter() - t0
    want = {"rmsnorm": 4 * layers + 1, "adamw_update": 1}
    for r, res in enumerate(ranks):
        for run in ("compressed", "plain", "grid"):
            x = res[run]
            if x["metrics"] != ranks[0][run]["metrics"]:
                raise AssertionError(f"train_sharded (b) {run}: rank {r}'s "
                                     "metrics differ from rank 0's")
            if any(c != want for c in x["launches"]):
                raise AssertionError(f"train_sharded (b) {run} rank {r}: "
                                     f"launches {x['launches']}, expected "
                                     f"{want}")
            if not all(math.isfinite(v) for m in x["metrics"]
                       for v in m.values()):
                raise AssertionError(f"train_sharded (b) {run}: non-finite "
                                     f"{x['metrics']}")
        for i, (worst, quanta) in enumerate(res["checks"]):
            if not worst <= 1.0:
                raise AssertionError(
                    f"train_sharded (b) rank {r} step {i}: a synced "
                    f"gradient element {worst:.3f} of its bound (half of "
                    f"each hop's quantization step) from the exact pod "
                    f"mean ({quanta:.3f} of s1)")
    c = ranks[0]["compressed"]
    pm, cm, gm = (ranks[0][k]["metrics"]
                  for k in ("plain", "compressed", "grid"))
    # step 0's loss is the same forward pass in both steps; the sync shows
    # from step 0's grad norm on
    d0 = abs(cm[0]["loss"] - pm[0]["loss"])
    if d0 > 1e-6 * abs(pm[0]["loss"]):
        raise AssertionError(f"train_sharded (b) step 0 loss: compressed "
                             f"{cm[0]['loss']} vs uncompressed "
                             f"{pm[0]['loss']}")
    gaps = []
    for i, key in ((0, "grad_norm"), (1, "loss"), (1, "grad_norm")):
        ref = pm[i][key]
        d, ctl = abs(cm[i][key] - ref), abs(gm[i][key] - ref)
        lim = 2 * ctl + 1e-6 * abs(ref)
        gaps.append(f"step {i} {key} |d| {d:.3e} (control {ctl:.3e})")
        if d > lim:
            raise AssertionError(
                f"train_sharded (b) step {i} {key}: compressed {cm[i][key]}"
                f" vs uncompressed {ref} (|d| {d:.3e} > twice the "
                f"one-quantum control's {ctl:.3e})")
    wire = c["wire"][-1]["collective_wire_bytes"]
    counted = c["int8_wire"]
    # per JAX leaf: its pieces' N int8s, padded to a multiple of the 2
    # pods, go out once in the all-to-all and once in the all-gather,
    # each sending half of them
    padded = sum(2 * (-(-n // 2)) for n in c["groups"])
    analytic = compression.wire_bytes(c["n_local"], 2)["int8_ef_a2a_ag"]
    if counted != padded:
        raise AssertionError(f"train_sharded (b): int8 wire bytes counted "
                             f"{counted}, the shards give {padded}")
    checks = [x for res in ranks for x in res["checks"]]
    # a process's peaks over its three runs: those read after the last
    peaks = [(round(x["grid"]["memory_gib"], 2),
              round(x["grid"]["reserved_gib"], 2)) for x in ranks]
    for i, m in enumerate(cm):
        print(f"train_sharded (b) step {i}: loss {m['loss']:.6f} "
              f"(uncompressed {pm[i]['loss']:.6f}, one-quantum control "
              f"{gm[i]['loss']:.6f}) grad_norm {m['grad_norm']:.6f} "
              f"(uncompressed {pm[i]['grad_norm']:.6f}, control "
              f"{gm[i]['grad_norm']:.6f}) lr {m['lr']:.3e}; wall a rank "
              f"{[round(x['compressed']['wall'][i], 3) for x in ranks]} s "
              f"[{card}]")
    print(f"train_sharded (b): {ccfg.name} full width, {layers} layers, "
          f"pod=2 x data=2 (4 gloo ranks on one card), global batch {b} x "
          f"({ccfg.n_prefix_embeds} + {s}); against the uncompressed "
          f"sharded step: {'; '.join(gaps)}, each within twice the "
          f"control's; synced gradients against the exact pod mean: worst "
          f"element {max(w for w, _ in checks):.3f} of its bound, "
          f"{max(q for _, q in checks):.3f} of s1; int8 wire bytes a rank "
          f"a step (all-to-all + all-gather of the pod sync) "
          f"{counted:.0f} = the shards' {padded:.0f}; wire_bytes(local "
          f"params {c['n_local']}, 2 pods)['int8_ef_a2a_ag'] = "
          f"{analytic:.0f} (the pad of each leaf to a multiple of 2 "
          f"apart); all collectives a rank a step {json.dumps(wire)}; peak "
          f"memory a rank, allocated / reserved {peaks} GiB, "
          f"{free_gib:.2f} GiB free on the card before the spawn, each "
          f"rank capped at {free_gib / 4 - GLOO_CONTEXT_GIB:.2f} GiB; the 4 "
          f"processes took {spawn_s:.1f} s [{card}]")
    _ts_adamw_shards(card)


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
    # an empty tune cache of this run's own: every op with no config
    # resolves its planned (or static default) config
    cache_dir = tempfile.mkdtemp(prefix="repro_torch_cache_")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(cache_dir,
                                                        "tune_cache.json")
    try:
        return _run(t_start)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def _run(t_start: float) -> int:
    import torch

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
    from repro_torch import obs
    with obs.collect() as registry_events:
        phase_registry(card, results)
    phase_resolve(card)
    phase_guard(card, registry_events)
    del registry_events
    print(f"kernels checked in {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s [{card}]")
        return out

    model, params, engine, counts, served = timed("serve", phase_serve,
                                                  card)
    timed("in-model", phase_in_model, card, model, params, engine)
    timed("profile", phase_profile, card, model, params, engine)
    timed("prefill", phase_prefill, card, model, params)
    timed("sharded", phase_sharded, card, model, params, engine, served)
    del model, params, engine          # free the serve weights and cache
    torch.cuda.empty_cache()
    timed("families", phase_families, card)
    timed("whisper", phase_whisper, card)
    timed("train-families", phase_train_families, card)
    train_counts = timed("train", phase_train, card)
    timed("train_sharded", phase_train_sharded, card)
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
