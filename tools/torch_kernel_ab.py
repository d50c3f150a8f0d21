#!/usr/bin/env python3
"""doitgen, the stream kernels (K1, the K2 read, the K4 ring), the
ring's adamw body, rmsnorm, rowstat, mxv, the column-dot and decode
attention of the PyTorch port, timed
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
    call's 3 GB of outputs);
  * rmsnorm at x [4, 4096] (a decode step's rows) and [8192, 4096] (a
    train step's) in bf16, at the op's resolved config;
  * rowstat (``rowstat_gen``, D=4, P=2) at 4096^2 and 16384^2 in f32
    and bf16, and mxv (the row-dot that shares its library) at the same
    sizes in f32;
  * the column-dot: ``mxv_t``, ``gemver_mxv1_gen`` and
    ``gemver_mxv1_sum_gen`` (D=4, P=2) at 4096^2 and 16384^2 in f32 and
    bf16;
  * rmsnorm at x [8, 1001] in bf16 and f32 (rows that are not whole
    16-byte vectors) and decode attention (``decode_attn``, B=4,
    S=4096, kv_len uniform) at Yi-9B's heads (Hkv=4, Hq=32, dh=128) and
    Phi-2's (Hkv=Hq=32, dh=80); a checkout whose kernels refuse a shape
    records ``"refused"``;

and beside each, in the first ROOT's process only, one PyTorch call
that computes the same function: ``torch.matmul(A.view(-1, s), C4)``,
``x.clone()``, ``torch.add(b, c, alpha=1.5)``, ``torch.full``, ``x +
z``, ``x.view(D, -1).sum(1, dtype=float32)``, ``part.sum(0)``,
``torch._fused_adamw_``, ``F.rms_norm``, ``(x.amax(1), x.sum(1))``,
``torch.mv``, ``torch.mv(A.t(), y)`` (with gemver's scaling and adds),
SDPA with ``enable_gqa``.  TF32 is off.

Prints one JSON line per ROOT (milliseconds), then the card's name and
power limit.  Compare roots by the alternation, never across calls.
"""
from __future__ import annotations

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


def refused(fn, *args):
    """Time ``fn(*args)``, or ``"refused"`` where this checkout's kernels
    do not take the shape (its wrapper raises ValueError or
    NotImplementedError before any launch)."""
    try:
        return fn(*args)
    except (ValueError, NotImplementedError):
        return "refused"


def one(root: str, replays: int, with_library: bool) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    # the timing of this repository's chip_smoke.py, whichever ROOT runs
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    from chip_smoke import _copies as copies
    from chip_smoke import device_ms, eager_ms
    from repro_torch.codegen import plan_blocks, run_spec
    from repro_torch.kernels import cuda
    from repro_torch.kernels.adamw import _HYPER
    from repro_torch.kernels.adamw import ops as aops
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
                "rmsnorm", "reduction", "stream_reduction", "decode_attn"])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dt):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    out: dict = {"root": root}
    for shape, dt_name in DOITGEN:
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
    for dt_name in STREAM_DTYPES:
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
    for t in RMSNORM_ROWS:
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
    for n, dt_name in ROWSTAT:
        dt = getattr(torch, dt_name)
        isz = torch.empty((), dtype=dt).element_size()
        xsets = copies(lambda: (rand((n, n), dt),), n * n * isz)
        key = f"rowstat {dt_name} [{n}, {n}]"
        out[key] = device_ms(lambda x: rowstat_gen(x, config=cfg42), xsets,
                             replays=replays)
        if with_library:
            out[f"{key} x.amax(1), x.sum(1)"] = device_ms(
                lambda x: (x.amax(1), x.sum(1)), xsets, replays=replays)
        if dt == torch.float32:
            v = rand((n,), dt)
            out[f"mxv {dt_name} [{n}, {n}]"] = device_ms(
                lambda a: mxv(a, v, config=cfg42), xsets, replays=replays)
            if with_library:
                out[f"mxv {dt_name} [{n}, {n}] torch.mv"] = device_ms(
                    lambda a: torch.mv(a, v), xsets, replays=replays)
        del xsets
        torch.cuda.empty_cache()
    # the column-dot: mxv_t, gemver_mxv1 and gemver_mxv1_sum
    from repro_torch.kernels.gen import gemver_mxv1_gen, gemver_mxv1_sum_gen
    from repro_torch.kernels.mxv import mxv_t
    beta = 1.2
    for n, dt_name in COLDOT:
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
    for (t, dm), dt_name in RMSNORM_ODD:
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
    for model, hkv, hq, dh in DECODE:
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
    # adamw on the ring, Yi-9B's embedding, f32
    p, g, m = (rand(EMBED, torch.float32) for _ in range(3))
    v = torch.rand(*EMBED, generator=gen, device="cuda")
    s7 = torch.stack(aops.scalars(torch.device("cuda"),
                                  *_HYPER.values())).unbind()
    for la in RING_LOOKAHEADS:
        cfg = aops._DEFAULT.replace(lookahead=la)
        out[f"ring adamw f32 {list(EMBED)} la{la}"] = eager_ms(
            lambda *a: aops.adamw_update(*a, *s7, config=cfg), (p, g, m, v))
    if with_library:
        step = torch.ones((), device="cuda")
        out[f"adamw f32 {list(EMBED)} torch._fused_adamw_"] = eager_ms(
            lambda p_, g_, m_, v_: torch._fused_adamw_(
                [p_], [g_], [m_], [v_], [], [step], lr=_HYPER["lr"],
                beta1=0.9, beta2=0.999, weight_decay=_HYPER["wd"],
                eps=_HYPER["eps"], amsgrad=False, maximize=False),
            (p, g, m, v))
    return out


if __name__ == "__main__":
    sys.exit(ab_turns.main(__file__, __doc__, one, "--replays", 5))
