#!/usr/bin/env python3
"""doitgen, the stream kernels (K1, the K2 read, the K4 ring), the
ring's adamw body, rmsnorm, rowstat, mxv, the column-dot, decode
attention, gemver's elementwise steps and the stencils of the PyTorch
port, timed
on one card for several checkouts in turn (an A/B of two commits, run
as parent, change, change, parent).

    python3 tools/torch_kernel_ab.py ROOT [ROOT ...] [--replays N]

Each ROOT is a checkout of the repository (its ``src/repro_torch`` and
``csrc`` are built and run as they stand there).  For each ROOT, in its
own process: build the libraries it times, then time through
the public ops, as ``chip_smoke.py`` times them (CUDA graphs of many
calls over input copies that together exceed 3x the 50 MB L2, between
CUDA events):

  * doitgen ``A [r, 256, 256] x C4 [256, 256]`` at r = 16 (the bench
    size) in f32, bf16 and f16, and at r = 256 in f32 and bf16;
  * stream copy, triad (alpha 1.5) and init at [8192, 4096] in f32 and
    bf16, at the default config (D=4, P=2), on K1 and on the K4 ring at
    lookahead 1, 3 and 4, and ``gemver_sum`` at vn = 4·2²⁰ on the ring;
  * ``stream_read`` at [8192, 4096] in f32 and bf16 (both passes), and
    its merge alone on the pass-1 partials;
  * ``adamw_update`` on the ring at lookahead 1, 3, 4 on Yi-9B's
    embedding [64000, 4096] f32 (timed eagerly: a graph would hold every
    call's 3 GB of outputs), and its K1 kernel at the ZeRO-3 shard shapes
    of ``ADAMW_K1`` (f32, default config);
  * the optimizer over Yi-9B's f32 leaf lists of ``ADAMW_LISTS`` (the
    one-card train step's 75 leaves, 8 layers; a four-card ZeRO-3
    rank's 435 shard leaves, 48 layers at data=4): the checkout's
    ``optimizer.adamw_step`` (device time between CUDA events, and its
    host wall time to return and to finish), and its update alone, as
    the checkout runs it (``adamw_update_many`` with the clip scale
    fused where the checkout has it, else a ``g.float() * scale`` pass
    and the per-tensor op for each leaf); ``AB_ONLY=adamw_dp``: the list
    update over D x P of ``ADAMW_DP`` where the checkout has
    ``adamw_update_many``;
  * rmsnorm at x [4, 4096] (a decode step's rows) and [8192, 4096] (a
    train step's) in bf16, at the op's resolved config;
  * rowstat (``rowstat_gen``, D=4, P=2) at 4096^2 and 16384^2 in f32
    and bf16;
  * the row-dot: ``mxv`` and ``gemver_mxv2_gen`` (alpha 1.5, D=4, P=2)
    at 4096^2 and 16384^2 in f32, bf16 and f16, outputs held; where the
    checkout's ``rowdot`` takes ``parts``, ``mxv`` over the parts of
    ``ROWDOT_PARTS`` and at the rule's parts with x read through
    ``__ldg`` (not staged in shared memory);
  * the column-dot: ``mxv_t``, ``gemver_mxv1_gen`` and
    ``gemver_mxv1_sum_gen`` (D=4, P=2) at 4096^2 and 16384^2 in f32 and
    bf16;
  * rmsnorm at x [8, 1001] in bf16 and f32 (rows that are not whole
    16-byte vectors) and decode attention (``decode_attn``, B=4,
    S=4096, kv_len uniform) at Yi-9B's heads (Hkv=4, Hq=32, dh=128) and
    Phi-2's (Hkv=Hq=32, dh=80); a checkout whose kernels refuse a shape
    records ``"refused"``;
  * the K1 ``gemver_sum`` at vn = 4·2²⁰ in f32, bf16 and f16 at the
    default config (D=4, P=2) and over D = 1, 2, 4, 8 (P=2), and
    ``gemver_outer`` at 16384² and 4096² in f32, bf16 and f16, outputs
    held, and where the checkout's ``outer_geometry`` takes a run, over
    the runs of ``OUTER_RUNS`` (row slots a block) at D = 1, 4, 8;
  * jacobi2d and conv3x3 (the op, conv3x3's weight packing included) at
    x [2050, 2048] and [16386, 16384] in f32 and bf16, and at [16386,
    16386] (a row pitch that is not a power of two) in f32; where the
    checkout's ``stencil.geometry`` takes a run length, both kernels at
    x [2050, 2048] and [16386, 16384] over the runs of ``STENCIL_RUNS``
    and the rule's own (``stencil_runs``);

and beside each, in the first ROOT's process only, one PyTorch call
that computes the same function: ``torch.matmul(A.view(-1, s), C4)``,
``x.clone()``, ``torch.add(b, c, alpha=1.5)``, ``torch.full``, ``x +
z``, ``x.view(D, -1).sum(1, dtype=float32)``, ``part.sum(0)``,
``torch._fused_adamw_`` (over the same lists for the optimizer rows),
``F.rms_norm``, ``(x.amax(1), x.sum(1))``,
``torch.mv`` (and ``1.5 * torch.mv``), ``torch.mv(A.t(), y)`` (with
gemver's scaling and adds),
SDPA with ``enable_gqa``, ``torch.addr`` twice, ``F.conv2d`` (the
5-point cross of 0.2 for jacobi2d).  TF32 is off.  The K1
``gemver_sum`` rows, the stencils and their library calls hold every
call's output (``device_ms(..., hold=True)``), so an output that fits
L2 is written to HBM as in use, not to one buffer that stays in L2;
so do the row-dot and ``gemver_outer`` rows.

``AB_ONLY=plain`` times the plain versions (``mode="ref"`` on the card,
outputs held) of ``PLAIN``: jacobi2d and conv3x3 at x [16386, 16386]
f32, ``mxv`` f16, ``gemver_mxv2_gen``, ``gemver_mxv1_gen`` and
``gemver_mxv1_sum_gen`` in 16-bit at 16384^2 and 4096^2.

``AB_ONLY=section,...`` in the environment times only those sections
(of :data:`SECTIONS`), e.g. ``AB_ONLY=rowdot,gemver_outer``.

Prints one JSON line per ROOT (milliseconds), then the card's name and
power limit.  Compare roots by the alternation, never across calls.
"""
from __future__ import annotations

import inspect
import os
import sys

import ab_turns

DOITGEN = [((16, 256, 256), "float32"), ((16, 256, 256), "bfloat16"),
           ((16, 256, 256), "float16"), ((256, 256, 256), "float32"),
           ((256, 256, 256), "bfloat16")]
STREAM_SHAPE = (8192, 4096)
STREAM_DTYPES = ("float32", "bfloat16")
RING_LOOKAHEADS = (1, 3, 4)
GEMVER_SUM_N = 4 * 2 ** 20
EMBED = (64000, 4096)
RMSNORM_ROWS = (4, 8192)
RMSNORM_DM = 4096
ROWSTAT = [(4096, "float32"), (4096, "bfloat16"), (16384, "float32"),
           (16384, "bfloat16")]
COLDOT = [(4096, "float32"), (4096, "bfloat16"), (16384, "float32"),
          (16384, "bfloat16")]
RMSNORM_ODD = [((8, 1001), "bfloat16"), ((8, 1001), "float32")]
# (model, Hkv, Hq, dh) at B=4, S=4096
DECODE = [("yi-9b", 4, 32, 128), ("phi-2", 32, 32, 80)]
DECODE_B, DECODE_S = 4, 4096
SUM_DTYPES = ("float32", "bfloat16", "float16")
SUM_D = (1, 2, 4, 8)
# the row-dot (mxv, gemver_mxv2_gen) and gemver_outer: (n, dtype) of
# A [n, n]
ROWDOT = [(n, dt) for n in (4096, 16384)
          for dt in ("float32", "bfloat16", "float16")]
OUTER = [(n, dt) for n in (16384, 4096)
         for dt in ("float32", "bfloat16", "float16")]
# run lengths (row slots a block) of the gemver_outer run table, by
# (n, dtype, D) of A [n, n]
OUTER_RUNS = {(16384, "float32", 4): (1, 2, 4, 8, 16),
              (16384, "bfloat16", 4): (1, 2, 4, 8, 16),
              (16384, "bfloat16", 1): (4, 8, 16, 32, 64),
              (16384, "bfloat16", 8): (1, 2, 4, 8),
              (4096, "float32", 4): (1, 2, 4, 8),
              (4096, "bfloat16", 4): (1, 2, 4, 8)}
D_SWEEP = (1, 2, 4, 8)
# column parts a row slot of the row-dot's parts table, by (n, dtype)
ROWDOT_PARTS = {(16384, "float32"): (1, 2, 4, 8),
                (16384, "bfloat16"): (1, 2, 4, 8),
                (4096, "bfloat16"): (1, 2, 4, 8)}
SECTIONS = ("doitgen", "stream", "rmsnorm", "rowstat", "rowdot", "coldot",
            "rmsnorm_odd", "decode", "gemver_sum", "gemver_outer",
            "stencil", "plain", "adamw", "adamw_list", "adamw_dp")
# the per-tensor K1 adamw kernel at ZeRO-3 shard shapes of Yi-9B (f32)
ADAMW_K1 = [(2048, 4096), (1024, 512), (2048, 512)]
# (tag, layers, data ranks) of Yi-9B's leaf lists for the optimizer rows
ADAMW_LISTS = [("one-card 75 leaves", 8, 1), ("rank 435 leaves", 48, 4)]
# (D, P) of the list update's sweep
ADAMW_DP = [(d, p) for d in (1, 2, 4, 8) for p in (1, 2, 4)]
# the plain versions (``mode="ref"`` on the card) that PERF.md's kernel
# table had no time for: (op name, n of A [n, n] or of x [n, n], dtype)
PLAIN = [("jacobi2d", 16386, "float32"), ("conv3x3", 16386, "float32"),
         ("mxv", 16384, "float16"), ("mxv", 4096, "float16"),
         ("gemver_mxv2_gen", 16384, "bfloat16"),
         ("gemver_mxv2_gen", 16384, "float16"),
         ("gemver_mxv2_gen", 4096, "bfloat16"),
         ("gemver_mxv1_gen", 16384, "bfloat16"),
         ("gemver_mxv1_gen", 4096, "bfloat16"),
         ("gemver_mxv1_sum_gen", 16384, "bfloat16"),
         ("gemver_mxv1_sum_gen", 4096, "bfloat16")]
# (x shape, dtype) of the stencils
STENCILS = [((2050, 2048), "float32"), ((2050, 2048), "bfloat16"),
            ((16386, 16384), "float32"), ((16386, 16384), "bfloat16"),
            ((16386, 16386), "float32")]
# run lengths (rows) of the stencil run table, by (x shape, dtype)
STENCIL_RUNS = {((2050, 2048), "float32"): (1, 2, 4, 8, 16),
                ((2050, 2048), "bfloat16"): (1, 2, 4, 8, 16),
                ((16386, 16384), "float32"): (8, 16, 32, 64, 128),
                ((16386, 16384), "bfloat16"): (8, 16, 32, 64, 128)}


def refused(fn, *args):
    """Time ``fn(*args)``, or ``"refused"`` where this checkout's kernels
    do not take the shape (its wrapper raises ValueError or
    NotImplementedError before any launch)."""
    try:
        return fn(*args)
    except (ValueError, NotImplementedError):
        return "refused"


def _sections() -> set:
    """The sections ``AB_ONLY`` names (every one where it is unset)."""
    only = os.environ.get("AB_ONLY")
    if not only:
        return set(SECTIONS)
    picked = set(only.split(","))
    unknown = picked - set(SECTIONS)
    if unknown:
        raise SystemExit(f"AB_ONLY: unknown sections {sorted(unknown)}")
    return picked


def one(root: str, replays: int, with_library: bool) -> dict:
    on = _sections()
    sys.path.insert(0, os.path.join(root, "src"))
    # the timing of this repository's chip_smoke.py, whichever ROOT runs
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    from chip_smoke import _copies as copies
    from chip_smoke import device_ms, eager_ms
    from repro_torch.codegen import plan_blocks, run_spec
    from repro_torch.kernels import cuda
    from repro_torch.kernels.doitgen import doitgen
    from repro_torch.kernels.gemver import gemver_sum
    from repro_torch.kernels.stream import (stream_copy, stream_copy_manual,
                                            stream_init, stream_read)
    from repro_torch.kernels.stream import kernel as sk
    from repro_torch.kernels.stream import specs as ss
    from repro_torch.kernels.stream.ops import _DEFAULT
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch.nn.functional as F
    from repro_torch.core.striding import StridingConfig
    from repro_torch.kernels.gen import rowstat_gen
    from repro_torch.kernels.mxv import mxv
    from repro_torch.kernels.rmsnorm import ops as rops
    cuda.build(["doitgen", "stream", "manual_ring", "gemver", "adamw",
                "rmsnorm", "reduction", "stream_reduction", "decode_attn",
                "stencil"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dt):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    out: dict = {"root": root}
    for shape, dt_name in (DOITGEN if "doitgen" in on else ()):
        dt = getattr(torch, dt_name)
        r, q, s = shape
        isz = torch.empty((), dtype=dt).element_size()
        c4 = rand((s, s), dt)
        sets = copies(lambda: (rand(shape, dt), c4), r * q * s * isz)
        reps = 8 if r == 256 else 20
        key = f"doitgen {dt_name} {list(shape)}"
        out[key] = device_ms(lambda a, c: doitgen(a, c), sets, reps, replays)
        if with_library:
            out[f"{key} torch.matmul"] = device_ms(
                lambda a, c: torch.matmul(a.view(-1, s), c), sets, reps,
                replays)
        del sets
        torch.cuda.empty_cache()
    n = STREAM_SHAPE[0] * STREAM_SHAPE[1]
    for dt_name in (STREAM_DTYPES if "stream" in on else ()):
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        s1 = copies(lambda: (rand(STREAM_SHAPE, dt),), n * isz)
        s2 = copies(lambda: (rand(STREAM_SHAPE, dt), rand(STREAM_SHAPE, dt)),
                    2 * n * isz)
        out[f"copy {dt_name}"] = device_ms(lambda x: stream_copy(x), s1,
                                           replays=replays)
        out[f"triad {dt_name}"] = device_ms(
            lambda b, c: run_spec(ss.triad_spec, (b, c, 1.5), _DEFAULT), s2,
            replays=replays)
        out[f"init {dt_name}"] = device_ms(
            lambda: stream_init(STREAM_SHAPE, 3.5, dt), [()],
            replays=replays)
        if with_library:
            out[f"copy {dt_name} x.clone()"] = device_ms(
                lambda x: x.clone(), s1, replays=replays)
            out[f"triad {dt_name} torch.add"] = device_ms(
                lambda b, c: torch.add(b, c, alpha=1.5), s2, replays=replays)
            out[f"init {dt_name} torch.full"] = device_ms(
                lambda: torch.full(STREAM_SHAPE, 3.5, dtype=dt,
                                   device="cuda"), [()], replays=replays)
        for la in RING_LOOKAHEADS:
            cfg = _DEFAULT.replace(lookahead=la)
            out[f"ring copy {dt_name} la{la}"] = device_ms(
                lambda x: stream_copy_manual(x, config=cfg), s1,
                replays=replays)
            out[f"ring triad {dt_name} la{la}"] = device_ms(
                lambda b, c: run_spec(ss.triad_spec, (b, c, 1.5), cfg), s2,
                replays=replays)
            out[f"ring fill {dt_name} la{la}"] = device_ms(
                lambda: stream_init(STREAM_SHAPE, 3.5, dt, config=cfg),
                [()], replays=replays)
        vn = GEMVER_SUM_N
        vsets = copies(lambda: (rand((vn,), dt), rand((vn,), dt)),
                       2 * vn * isz)
        for la in RING_LOOKAHEADS:
            cfg = _DEFAULT.replace(lookahead=la)
            out[f"ring gemver_sum {dt_name} la{la}"] = device_ms(
                lambda x, z: gemver_sum(x, z, config=cfg), vsets,
                replays=replays)
        if with_library:
            out[f"gemver_sum {dt_name} x + z"] = device_ms(
                lambda x, z: x + z, vsets, replays=replays)
        # the read, both passes, then its merge alone
        r1 = copies(lambda: ((1 + rand(STREAM_SHAPE, torch.float32)).to(dt),),
                    n * isz)
        d = _DEFAULT.stride_unroll
        out[f"read {dt_name}"] = device_ms(lambda x: stream_read(x), r1,
                                           replays=replays)
        x2 = r1[0][0].reshape(d, -1)
        spec = ss.read_spec(x2)
        part = sk.read_split(spec, plan_blocks(spec, _DEFAULT), x2, _DEFAULT)
        psets = [(part.clone(),) for _ in range(64)]
        out[f"read merge {dt_name} {list(part.shape)}"] = device_ms(
            lambda p: sk.read_merge(p), psets, replays=replays)
        if with_library:
            out[f"read {dt_name} x.view(D, -1).sum(1)"] = device_ms(
                lambda x: x.view(d, -1).sum(1, dtype=torch.float32), r1,
                replays=replays)
            out[f"read merge {dt_name} part.sum(0)"] = device_ms(
                lambda p: p.sum(0), psets, replays=replays)
        del s1, s2, vsets, r1, psets
        torch.cuda.empty_cache()
    # rmsnorm (bf16), rowstat and the row-dot that shares its library
    dm = RMSNORM_DM
    for t in (RMSNORM_ROWS if "rmsnorm" in on else ()):
        rsets = copies(lambda: (rand((t, dm), torch.bfloat16),
                                (1 + 0.1 * rand((dm,), torch.float32))
                                .to(torch.bfloat16)), t * dm * 2)
        key = f"rmsnorm bfloat16 [{t}, {dm}]"
        out[key] = device_ms(lambda x, w: rops.rmsnorm(x, w, 1e-5), rsets,
                             replays=replays)
        if with_library:
            out[f"{key} F.rms_norm"] = device_ms(
                lambda x, w: F.rms_norm(x, (dm,), w, 1e-5), rsets,
                replays=replays)
        del rsets
    cfg42 = StridingConfig(4, 2)
    for n, dt_name in (ROWSTAT if "rowstat" in on else ()):
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        xsets = copies(lambda: (rand((n, n), dt),), n * n * isz)
        key = f"rowstat {dt_name} [{n}, {n}]"
        out[key] = device_ms(lambda x: rowstat_gen(x, config=cfg42), xsets,
                             replays=replays)
        if with_library:
            out[f"{key} x.amax(1), x.sum(1)"] = device_ms(
                lambda x: (x.amax(1), x.sum(1)), xsets, replays=replays)
        del xsets
        torch.cuda.empty_cache()
    # the row-dot: mxv and gemver_mxv2 (alpha A x), and (where the
    # checkout's row-dot takes them) the parts of ROWDOT_PARTS
    from repro_torch.kernels.gen import gemver_mxv2_gen
    from repro_torch.kernels.mxv import kernel as mk
    alpha = 1.5
    for n, dt_name in (ROWDOT if "rowdot" in on else ()):
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        xsets = copies(lambda: (rand((n, n), dt), rand((n,), dt)),
                       n * n * isz)
        tag = f"{dt_name} [{n}, {n}]"
        reps = 8 if n > 8192 else 20
        out[f"mxv {tag}"] = device_ms(
            lambda a, v: mxv(a, v, config=cfg42), xsets, reps, replays,
            hold=True)
        out[f"gemver_mxv2 {tag}"] = device_ms(
            lambda a, v: gemver_mxv2_gen(a, v, alpha, config=cfg42), xsets,
            reps, replays, hold=True)
        rowdot_takes_parts = "parts" in inspect.signature(
            mk.rowdot).parameters
        for parts in (ROWDOT_PARTS.get((n, dt_name), ())
                      if rowdot_takes_parts else ()):
            from repro_torch.codegen import plan_blocks
            from repro_torch.kernels.mxv import specs as mspecs
            bp = plan_blocks(mspecs.mxv_spec(*xsets[0]), cfg42)
            rule = mk.rowdot_geometry(bp.rows, bp.cols, isz, bp.d, sms).parts
            out[f"mxv parts {tag} parts {parts}"
                + (" (the rule's)" if parts == rule else "")] = device_ms(
                lambda a, v, _p=parts, _bp=bp: mk.rowdot(
                    mspecs.mxv_spec(a, v), _bp, [a, v], cfg42, (), _p),
                xsets, reps, replays, hold=True)
            if parts == rule:
                out[f"mxv parts {tag} parts {parts}, x by __ldg"] = (
                    device_ms(lambda a, v, _bp=bp: mk.rowdot(
                        mspecs.mxv_spec(a, v), _bp, [a, v], cfg42, (),
                        x_shared=False), xsets, reps, replays, hold=True))
        if with_library:
            out[f"mxv {tag} torch.mv"] = device_ms(
                lambda a, v: torch.mv(a, v), xsets, reps, replays, hold=True)
            out[f"gemver_mxv2 {tag} alpha * torch.mv"] = device_ms(
                lambda a, v: alpha * torch.mv(a, v), xsets, reps, replays,
                hold=True)
        del xsets
        torch.cuda.empty_cache()
    # the column-dot: mxv_t, gemver_mxv1 and gemver_mxv1_sum
    from repro_torch.kernels.gen import gemver_mxv1_gen, gemver_mxv1_sum_gen
    from repro_torch.kernels.mxv import mxv_t
    beta = 1.2
    for n, dt_name in (COLDOT if "coldot" in on else ()):
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        csets = copies(lambda: (rand((n, n), dt), rand((n,), dt),
                                rand((n,), dt), rand((n,), dt)),
                       n * n * isz)
        tag = f"{dt_name} [{n}, {n}]"
        out[f"mxv_t {tag}"] = device_ms(
            lambda a, y, x, z: mxv_t(a, y, config=cfg42), csets,
            replays=replays)
        out[f"gemver_mxv1 {tag}"] = device_ms(
            lambda a, y, x, z: gemver_mxv1_gen(a, y, x, beta, config=cfg42),
            csets, replays=replays)
        out[f"gemver_mxv1_sum {tag}"] = device_ms(
            lambda a, y, x, z: gemver_mxv1_sum_gen(a, y, x, z, beta,
                                                   config=cfg42),
            csets, replays=replays)
        if with_library:
            out[f"mxv_t {tag} torch.mv(A.t(), y)"] = device_ms(
                lambda a, y, x, z: torch.mv(a.t(), y), csets,
                replays=replays)
            out[f"gemver_mxv1 {tag} x + b*torch.mv(A.t(), y)"] = device_ms(
                lambda a, y, x, z: x + beta * torch.mv(a.t(), y), csets,
                replays=replays)

            def mxv1_sum_lib(a, y, x, z):
                s = beta * torch.mv(a.t(), y).float()
                return x + s + z, s.sum()
            out[f"gemver_mxv1_sum {tag} x + s + z, s.sum()"] = device_ms(
                mxv1_sum_lib, csets, replays=replays)
        del csets
        torch.cuda.empty_cache()
    # rmsnorm at rows that are not whole 16-byte vectors
    for (t, dm), dt_name in (RMSNORM_ODD if "rmsnorm_odd" in on else ()):
        dt = getattr(torch, dt_name)
        rsets = copies(lambda: (rand((t, dm), dt),
                                (1 + 0.1 * rand((dm,), torch.float32))
                                .to(dt)), t * dm * 4)
        key = f"rmsnorm {dt_name} [{t}, {dm}]"
        out[key] = refused(device_ms, lambda x, w: rops.rmsnorm(x, w, 1e-5),
                           rsets, 20, replays)
        if with_library:
            out[f"{key} F.rms_norm"] = device_ms(
                lambda x, w: F.rms_norm(x, (dm,), w, 1e-5), rsets,
                replays=replays)
    # decode attention, bf16, both passes
    from repro_torch.kernels.decode_attn import ops as dops
    kv_len = torch.randint(1, DECODE_S + 1, (DECODE_B,), generator=gen,
                           device="cuda")
    for model, hkv, hq, dh in (DECODE if "decode" in on else ()):
        b, s = DECODE_B, DECODE_S
        dsets = copies(lambda: (rand((b, hq, dh), torch.bfloat16),
                                rand((b, s, hkv, dh), torch.bfloat16),
                                rand((b, s, hkv, dh), torch.bfloat16)),
                       2 * b * s * hkv * dh * 2)
        key = f"decode_attn bfloat16 {model} dh={dh} B={b} S={s}"
        out[key] = refused(device_ms, lambda q, k, v: dops.decode_attn(
            q, k, v, kv_len=kv_len), dsets, 20, replays)
        if with_library:
            mask = (torch.arange(s, device="cuda")[None, :]
                    < kv_len[:, None])[:, None, None, :]
            lsets = [(q[:, :, None], k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous()) for q, k, v in dsets]
            out[f"{key} SDPA enable_gqa"] = device_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True), lsets,
                replays=replays)
            del lsets
        del dsets
        torch.cuda.empty_cache()
    # the K1 gemver_sum, gemver_outer in bf16, the stencils
    from repro_torch.kernels.conv3x3 import conv3x3
    from repro_torch.kernels.gemver import gemver_outer
    from repro_torch.kernels.jacobi2d import jacobi2d
    vn = GEMVER_SUM_N
    for dt_name in (SUM_DTYPES if "gemver_sum" in on else ()):
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        vsets = copies(lambda: (rand((vn,), dt), rand((vn,), dt)),
                       3 * vn * isz)
        device_ms(lambda x, z: x + z, vsets, replays=replays)   # warm-up
        out[f"gemver_sum {dt_name}"] = device_ms(
            lambda x, z: gemver_sum(x, z), vsets, replays=replays, hold=True)
        for d in SUM_D:
            cfg = StridingConfig(d, 2)
            out[f"gemver_sum {dt_name} D={d}"] = device_ms(
                lambda x, z: gemver_sum(x, z, config=cfg), vsets,
                replays=replays, hold=True)
        if with_library:
            out[f"gemver_sum {dt_name} K1 x + z"] = device_ms(
                lambda x, z: x + z, vsets, replays=replays, hold=True)
        del vsets
    # a checkout whose outer_geometry takes a run also times the runs of
    # OUTER_RUNS beside its rule's own
    from repro_torch.kernels.gemver import kernel as gk
    outer_geo = getattr(gk, "outer_geometry", None)
    outer_runs = (outer_geo if outer_geo is not None and "run" in
                  inspect.signature(outer_geo).parameters else None)
    for n, dt_name in (OUTER if "gemver_outer" in on else ()):
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        osets = copies(lambda: (rand((n, n), dt),
                                *(rand((n,), dt) for _ in range(4))),
                       2 * n * n * isz)
        key = f"gemver_outer {dt_name} [{n}, {n}]"
        reps = 8 if n > 8192 else 20
        out[key] = device_ms(lambda *t: gemver_outer(*t), osets, reps,
                             replays, hold=True)
        if with_library:
            out[f"{key} torch.addr twice"] = device_ms(
                lambda a, u1, v1, u2, v2: torch.addr(
                    torch.addr(a, u1, v1), u2, v2), osets, reps, replays,
                hold=True)
        for d in (D_SWEEP if outer_runs is not None else ()):
            if (n, dt_name, d) not in OUTER_RUNS:
                continue
            from repro_torch.codegen import plan_blocks
            from repro_torch.kernels.gemver import specs as gspecs
            bp = plan_blocks(gspecs.gemver_outer_spec(*osets[0]),
                             StridingConfig(d, 2))
            rule = gk.outer_geometry(n, n, isz, d, sms).run
            for run in sorted(set(OUTER_RUNS[(n, dt_name, d)]) | {rule}):
                g = gk.outer_geometry(n, n, isz, d, sms, run=run)

                def launch(*t, _g=g, _bp=bp):
                    o = torch.empty_like(t[0])
                    gk.outer_launch(t, o, _bp, _g)
                    return o
                out[f"gemver_outer runs {dt_name} [{n}, {n}] D={d} run "
                    f"{run}" + (" (the rule's)" if run == rule else "")
                    + f", {g.blocks} blocks"] = device_ms(
                    launch, osets, reps, replays, hold=True)
        del osets
        torch.cuda.empty_cache()
    from repro_torch.kernels import stencil as st
    from repro_torch.kernels.jacobi2d import specs as jspecs
    # a checkout whose stencil geometry takes a run length also times
    # the runs of STENCIL_RUNS beside its rule's own
    geo = getattr(st, "geometry", None)
    runs_of = STENCIL_RUNS if geo is not None and "run" in \
        inspect.signature(geo).parameters else {}
    w = rand((3, 3), torch.float32)
    cross = torch.tensor([[0.0, 0.2, 0.0], [0.2, 0.2, 0.2],
                          [0.0, 0.2, 0.0]], device="cuda")
    for shape, dt_name in (STENCILS if "stencil" in on else ()):
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        ssets = copies(lambda: (rand(shape, dt),), shape[0] * shape[1] * isz)
        reps = 8 if shape[0] > 4096 else 20
        tag = f"{dt_name} x {list(shape)}"
        out[f"jacobi2d {tag}"] = device_ms(lambda x: jacobi2d(x), ssets, reps,
                                           replays, hold=True)
        out[f"conv3x3 {tag}"] = device_ms(lambda x: conv3x3(x, w), ssets,
                                          reps, replays, hold=True)
        if with_library:
            cd, wd = cross.to(dt), w.to(dt)
            out[f"jacobi2d {tag} F.conv2d"] = device_ms(
                lambda x: F.conv2d(x[None, None], cd[None, None]), ssets,
                reps, replays, hold=True)
            out[f"conv3x3 {tag} F.conv2d"] = device_ms(
                lambda x: F.conv2d(x[None, None], wd[None, None]), ssets,
                reps, replays, hold=True)
        if (shape, dt_name) in runs_of:
            bp = plan_blocks(jspecs.jacobi_spec(ssets[0][0]),
                             StridingConfig(4, 1))
            w9 = st.kernel_weights([w[r, c] for r in range(3)
                                    for c in range(3)], w.device)
            rule = geo(bp, isz, sms).run
            for run in sorted(set(runs_of[(shape, dt_name)]) | {rule}):
                g = geo(bp, isz, sms, run=run)
                out[f"stencil runs {tag} run {run}"
                    + (" (the rule's)" if run == rule else "")
                    + f", {g.blocks} blocks: jacobi2d, conv3x3"] = [
                    device_ms(lambda x: st.launch("jacobi2d", x, None, bp, g),
                              ssets, reps, replays, hold=True),
                    device_ms(lambda x: st.launch("conv3x3", x, w9, bp, g),
                              ssets, reps, replays, hold=True)]
        del ssets
        torch.cuda.empty_cache()
    for name, n, dt_name in (PLAIN if "plain" in on else ()):
        import repro_torch.kernels as K
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        op = getattr(K, name)
        if name in ("jacobi2d", "conv3x3"):
            w = rand((3, 3), dt)
            psets = copies(lambda: (rand((n, n), dt),), n * n * isz)
            fn = ((lambda x: op(x, mode="ref")) if name == "jacobi2d"
                  else (lambda x: op(x, w, mode="ref")))
        elif name == "gemver_mxv1_sum_gen":
            psets = copies(lambda: (rand((n, n), dt), *(rand((n,), dt)
                                                       for _ in range(3))),
                           n * n * isz)
            fn = lambda a, y, x, z: op(a, y, x, z, 1.25, mode="ref")
        elif name == "gemver_mxv1_gen":
            psets = copies(lambda: (rand((n, n), dt), rand((n,), dt),
                                    rand((n,), dt)), n * n * isz)
            fn = lambda a, y, x: op(a, y, x, 1.25, mode="ref")
        else:
            psets = copies(lambda: (rand((n, n), dt), rand((n,), dt)),
                           n * n * isz)
            fn = ((lambda a, x: op(a, x, mode="ref")) if name == "mxv"
                  else (lambda a, x: op(a, x, 1.5, mode="ref")))
        out[f"plain {name} {dt_name} [{n}, {n}]"] = device_ms(
            fn, psets, 4 if n > 8192 else 10, replays, hold=True)
        del psets
        torch.cuda.empty_cache()
    if "adamw" in on:
        adamw_rows(out, gen, replays, with_library)
    if "adamw_list" in on or "adamw_dp" in on:
        adamw_lists(out, gen, with_library, "adamw_list" in on,
                    "adamw_dp" in on)
    return out


def adamw_rows(out: dict, gen, replays: int, with_library: bool) -> None:
    """The ring's adamw body on Yi-9B's embedding, and the per-tensor K1
    op at the shard shapes of ``ADAMW_K1``."""
    import torch
    from chip_smoke import _copies as copies
    from chip_smoke import device_ms, eager_ms
    from repro_torch.kernels.adamw import _HYPER
    from repro_torch.kernels.adamw import ops as aops

    def rand(shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    p, g, m = (rand(EMBED) for _ in range(3))
    v = torch.rand(*EMBED, generator=gen, device="cuda")
    s7 = torch.stack(aops.scalars(torch.device("cuda"),
                                  *_HYPER.values())).unbind()
    for la in RING_LOOKAHEADS:
        cfg = aops._DEFAULT.replace(lookahead=la)
        out[f"ring adamw f32 {list(EMBED)} la{la}"] = eager_ms(
            lambda *a: aops.adamw_update(*a, *s7, config=cfg), (p, g, m, v))
    step = torch.ones((), device="cuda")

    def library(p_, g_, m_, v_):
        torch._fused_adamw_([p_], [g_], [m_], [v_], [], [step],
                            lr=_HYPER["lr"], beta1=0.9, beta2=0.999,
                            weight_decay=_HYPER["wd"], eps=_HYPER["eps"],
                            amsgrad=False, maximize=False)
    if with_library:
        out[f"adamw f32 {list(EMBED)} torch._fused_adamw_"] = eager_ms(
            library, (p, g, m, v))
    del p, g, m, v
    for shape in ADAMW_K1:
        n = shape[0] * shape[1]
        sets = copies(lambda: (rand(shape), rand(shape), rand(shape),
                               torch.rand(*shape, generator=gen,
                                          device="cuda")), 16 * n)
        key = f"adamw k1 f32 {list(shape)}"
        out[key] = device_ms(lambda *a: aops.adamw_update(*a, *s7), sets,
                             replays=replays)
        if with_library:
            out[f"{key} torch._fused_adamw_"] = device_ms(
                library, [tuple(t.clone() for t in a) for a in sets],
                replays=replays)
        del sets
    torch.cuda.empty_cache()


def adamw_lists(out: dict, gen, with_library: bool, steps: bool = True,
                sweep: bool = False) -> None:
    """The optimizer over each leaf list of ``ADAMW_LISTS`` as this
    checkout runs it (see the module doc): the step and the update
    (``steps``), the update's D x P sweep (``sweep``)."""
    import time
    import torch
    from chip_smoke import _yi9b_leaves, eager_ms
    from repro_torch.core.striding import StridingConfig
    from repro_torch.kernels.adamw import _HYPER
    from repro_torch.kernels.adamw import ops as aops
    from repro_torch.train import optimizer as topt
    ocfg = topt.AdamWConfig()
    for tag, layers, data in ADAMW_LISTS:
        leaves = _yi9b_leaves(layers, data)
        params, grads = ({k: torch.randn(*sh, generator=gen, device="cuda")
                          for k, sh in leaves.items()} for _ in range(2))
        state = topt.adamw_init(params)
        n = sum(t.numel() for t in params.values())
        out[f"adamw list {tag} elements"] = n
        if steps:
            # the optimizer phase: norm, clip, scalars and the update
            out[f"adamw_step {tag}"] = eager_ms(
                lambda: topt.adamw_step(ocfg, params, grads, state), ())
            host, done = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                topt.adamw_step(ocfg, params, grads, state)
                host.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                done.append(time.perf_counter() - t0)
            out[f"adamw_step {tag} host return ms"] = min(host) * 1e3
            out[f"adamw_step {tag} host wall ms"] = min(done) * 1e3
        # the update alone, clip scale 0.5, weight decay by the JAX rule
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        ms = [state["m"][k] for k in names]
        vs = [state["v"][k] for k in names]
        wds = [ocfg.weight_decay if topt.decays(k, params[k]) else 0.0
               for k in names]
        scale = torch.tensor(0.5, device="cuda")
        s7 = torch.stack(aops.scalars(torch.device("cuda"),
                                      *_HYPER.values()))
        many = getattr(aops, "adamw_update_many", None)
        for d, p in (ADAMW_DP if sweep and many is not None else ()):
            cfg = StridingConfig(d, p)
            out[f"adamw update {tag} D={d} P={p}"] = eager_ms(
                lambda: many(ps, gs, ms, vs, wds, s7, gscale=scale,
                             config=cfg), ())
        if not steps:
            del params, grads, state, ps, gs, ms, vs
            torch.cuda.empty_cache()
            continue
        if many is not None:
            def update():
                many(ps, gs, ms, vs, wds, s7, gscale=scale)
        else:
            one = dict(zip(_HYPER, s7.unbind()))

            def update():
                for p, g, m, v, wd in zip(ps, gs, ms, vs, wds):
                    aops.adamw_update(p, g.float() * scale, m, v,
                                      **dict(one, wd=wd))
        out[f"adamw update {tag}"] = eager_ms(update, ())
        if with_library:
            steps = [torch.ones((), device="cuda") for _ in ps]
            out[f"adamw update {tag} torch._fused_adamw_"] = eager_ms(
                lambda: torch._fused_adamw_(
                    ps, gs, ms, vs, [], steps, lr=_HYPER["lr"], beta1=0.9,
                    beta2=0.999, weight_decay=ocfg.weight_decay,
                    eps=_HYPER["eps"], amsgrad=False, maximize=False), ())
        del params, grads, state, ps, gs, ms, vs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(ab_turns.main(__file__, __doc__, one, "--replays", 5))
