#!/usr/bin/env python3
"""The sweeps the port's H100 stream model (``repro_torch.core.dma_model``)
is fitted to, timed on one card, and the fit itself.

    python3 tools/torch_stream_fit.py [SECTION ...] [--out FILE]
    python3 tools/torch_stream_fit.py --fit FILE

Measuring (on the card; each section in its own process, so a config
that faults loses only its section):

  * ``dp`` — the D x P sweep: the K1 copy (``stream_copy``) and the K2
    read (``stream_read``) at [8192, 4096] in f32 and bf16 over D in
    {1, 2, 4, 8, 16} and P in {1, 2, 4, 8};
  * ``pitch`` — the pitch sweep: the K1 copy at D = 4, P = 2 and the
    stencil (``jacobi2d``, f32, D = 4) over arrays of 128 MiB whose row
    pitch is 2^k bytes (k = 11..17), so that the D streams start an exact
    power of two apart, and 2^k + 1024 bytes (one column step of the
    copy's P = 2 more: a 2^k + 256 B row would time the emitter's pad and
    crop, a 2^k + 512 B one a walk in P = 1 steps);
  * ``main`` — each op of the main path at the configs the planner can
    rank (D in {1, 2, 4, 8, 16}, P in {1, 2, 4, 8}, D·P <= 32; and
    ``block_rows`` 4 and 16 at the op's static default): decode attention
    at the serve shape (B=4, S=4096, Hkv=4, Hq=32, dh=128, bf16, every
    position valid), ``mxv`` and ``mxv_t`` at 16384^2 in f32 and bf16,
    ``adamw_update`` at [64000, 4096] and [4096, 1024] f32,
    ``gemver_sum`` at vn = 4·2^20 f32, ``gemver_outer`` at 16384^2 f32,
    and the K1 init and triad at [8192, 4096] f32;
  * ``resolved`` — each main-path op at the config it resolves to with
    none given (``kernel.resolve``'s source) and at the static default of
    the wrappers before config resolution reached the card, in
    alternation (default, resolved, resolved, default).

Each point is timed as ``chip_smoke.py`` times a kernel (CUDA graphs of
many calls over input copies that together exceed 3x the 50 MB L2, every
output held; the [64000, 4096] adamw eagerly) and held once against the
op's plain version on the same inputs (``rel_err``: max |kernel - plain|
over max |plain|).  Every point is one JSON line on stdout and in FILE
(default ``chiprun_out/stream_fit.jsonl``); the card's name and power
limit end the output.

Fitting (no card needed): ``--fit FILE`` reads the K1 / K2 stream points
of FILE (the ``dp`` section's copy and read, the ``main`` section's
triad and init), fits the stream model's issue latency, per-stream
ceiling and stream count (``dma_model.fit_model``: the least-error
model under which every swept op's planned config runs within 3% of its
static default) and prints each measured point beside the model's
prediction, each planned op's time against its static default's, the
pitch sweep's cost of a power-of-two pitch (time a byte: the other
pitch moves more bytes), and the ``resolved`` section's rows.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SECTIONS = ("dp", "pitch", "main", "resolved")
DS = (1, 2, 4, 8, 16)
PS = (1, 2, 4, 8)
STREAM_SHAPE = (8192, 4096)
PITCH_BYTES = 2 ** 27                  # each pitch-sweep array: 128 MiB
PITCH_KS = tuple(range(11, 18))
# the other pitch: one column step of the copy's P = 2 (256 f32) more, so
# the copy runs the same P-wide steps at both pitches (a 2^k + 256 B row
# would be padded and cropped, a 2^k + 512 B one walked in P = 1 steps)
PITCH_EXTRA = 1024
EMBED = (64000, 4096)
ADAMW_BENCH = (4096, 1024)
GEMVER_SUM_N = 4 * 2 ** 20
LINALG_N = 16384


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def _rel(got, want) -> float:
    import torch
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    worst = 0.0
    for g, w in zip(got, want):
        d = float((g.double() - w.double()).abs().max())
        worst = max(worst, d / max(float(w.double().abs().max()), 1e-30))
    return worst


def _configs(default):
    """The planner's (D, P) space at bm 0, then bm 4 and 16 at the
    op's static default."""
    from repro_torch.core.striding import StridingConfig
    out = [StridingConfig(d, p) for d in DS for p in PS if d * p <= 32]
    out += [default.replace(block_rows=bm) for bm in (4, 16)]
    return out


def _point(emit, section, op, dtype, cfg, ms, rel, **extra):
    row = dict(section=section, op=op, dtype=dtype, d=cfg.stride_unroll,
               p=cfg.portion_unroll, bm=cfg.block_rows, ms=ms,
               rel_err=rel, **extra)
    emit(row)


def _timer(hold=True):
    sys.path.insert(0, ROOT)
    from chip_smoke import device_ms
    return lambda fn, sets, reps=20: device_ms(fn, sets, reps, 5, hold=hold)


def section_dp(emit):
    import torch
    from chip_smoke import _copies
    from repro_torch.core.striding import StridingConfig
    from repro_torch.kernels.stream import stream_copy, stream_read
    time = _timer()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = STREAM_SHAPE[0] * STREAM_SHAPE[1]
    for dt in (torch.float32, torch.bfloat16):
        isz = torch.empty((), dtype=dt).element_size()
        sets = _copies(lambda: (torch.randn(*STREAM_SHAPE, generator=gen,
                                            device="cuda").to(dt),),
                       n * isz)
        for d in DS:
            for p in PS:
                cfg = StridingConfig(d, p)
                for op, fn in (("stream_copy", stream_copy),
                               ("stream_read", stream_read)):
                    x = sets[0][0]
                    rel = _rel(fn(x, config=cfg),
                               fn(x, config=cfg, mode="ref"))
                    ms = time(lambda x: fn(x, config=cfg), sets)
                    _point(emit, "dp", op, str(dt)[6:], cfg, ms, rel,
                           bytes=n * isz * (2 if op == "stream_copy"
                                            else 1))
        del sets
        torch.cuda.empty_cache()


def section_pitch(emit):
    import torch
    from chip_smoke import _copies
    from repro_torch.core.striding import StridingConfig
    from repro_torch.kernels.jacobi2d import jacobi2d
    from repro_torch.kernels.stream import stream_copy
    time = _timer()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = StridingConfig(4, 2)
    for k in PITCH_KS:
        for extra in (0, PITCH_EXTRA):
            pitch = 2 ** k + extra
            rows = PITCH_BYTES // 2 ** k
            cols = pitch // 4
            sets = _copies(lambda: (torch.randn(rows, cols, generator=gen,
                                                device="cuda"),),
                           rows * pitch)
            x = sets[0][0]
            rel = _rel(stream_copy(x, config=cfg),
                       stream_copy(x, config=cfg, mode="ref"))
            ms = time(lambda x: stream_copy(x, config=cfg), sets)
            _point(emit, "pitch", "stream_copy", "float32", cfg, ms, rel,
                   pitch=pitch, rows=rows, bytes=2 * rows * pitch)
            # the stencil's input rows are its output rows + 2
            xs = _copies(lambda: (torch.randn(rows + 2, cols, generator=gen,
                                              device="cuda"),),
                         (rows + 2) * pitch)
            x = xs[0][0]
            rel = _rel(jacobi2d(x, config=cfg),
                       jacobi2d(x, config=cfg, mode="ref"))
            ms = time(lambda x: jacobi2d(x, config=cfg), xs)
            _point(emit, "pitch", "jacobi2d", "float32", cfg, ms, rel,
                   pitch=pitch, rows=rows,
                   bytes=(rows + 2) * pitch + rows * (pitch - 8))
            del sets, xs
            torch.cuda.empty_cache()


def main_ops():
    """[(op, dtype, make inputs, call(inputs, config), default, eager)] —
    the main path's ops at their timed shapes."""
    import torch
    from repro_torch.core.striding import StridingConfig
    from repro_torch.kernels.adamw import ops as aops
    from repro_torch.kernels.decode_attn import decode_attn
    from repro_torch.kernels.gemver import gemver_outer, gemver_sum
    from repro_torch.kernels.mxv import mxv, mxv_t
    from repro_torch.kernels.gen import stream_triad_gen
    from repro_torch.kernels.stream import stream_init
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    d4p1, d4p2, d2p2 = (StridingConfig(4, 1), StridingConfig(4, 2),
                        StridingConfig(2, 2))
    b, s, hkv, hq, dh = 4, 4096, 4, 32, 128
    bf = torch.bfloat16
    n = LINALG_N
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01, bc1=0.5,
                 bc2=0.25)
    ops = [
        ("decode_attn", "bfloat16",
         lambda: (rand(b, hq, dh, dt=bf), rand(b, s, hkv, dh, dt=bf),
                  rand(b, s, hkv, dh, dt=bf),
                  torch.full((b,), s, device="cuda")),
         lambda i, c, m=None: decode_attn(*i[:3], kv_len=i[3], config=c,
                                          mode=m), d4p1, False),
    ]
    for dt in (torch.float32, bf):
        ops.append((f"mxv", str(dt)[6:],
                    lambda dt=dt: (rand(n, n, dt=dt), rand(n, dt=dt)),
                    lambda i, c, m=None: mxv(*i, config=c, mode=m), d4p2,
                    False))
        ops.append((f"mxv_t", str(dt)[6:],
                    lambda dt=dt: (rand(n, n, dt=dt), rand(n, dt=dt)),
                    lambda i, c, m=None: mxv_t(*i, config=c, mode=m), d4p2,
                    False))
    for shape, eager in ((EMBED, True), (ADAMW_BENCH, False)):
        ops.append((f"adamw_update {list(shape)}", "float32",
                    lambda shape=shape: (rand(*shape), rand(*shape),
                                         rand(*shape),
                                         rand(*shape).abs()),
                    lambda i, c, m=None: aops.adamw_update(
                        *i, config=c, mode=m, **hyper), d2p2, eager))
    vn = GEMVER_SUM_N
    ops += [
        ("gemver_sum", "float32", lambda: (rand(vn), rand(vn)),
         lambda i, c, m=None: gemver_sum(*i, config=c, mode=m), d4p2,
         False),
        ("gemver_outer", "float32",
         lambda: (rand(n, n), rand(n), rand(n), rand(n), rand(n)),
         lambda i, c, m=None: gemver_outer(*i, config=c, mode=m), d4p2,
         False),
        ("stream_init", "float32", lambda: (),
         lambda i, c, m=None: stream_init(STREAM_SHAPE, 3.5, config=c,
                                          mode=m), d4p2, False),
        ("stream_triad", "float32",
         lambda: (rand(*STREAM_SHAPE), rand(*STREAM_SHAPE)),
         lambda i, c, m=None: stream_triad_gen(*i, 1.5, config=c, mode=m),
         d4p2, False),
    ]
    return ops


def _nbytes(inputs) -> int:
    return sum(t.numel() * t.element_size() for t in inputs)


def section_main(emit):
    import torch
    from chip_smoke import _copies, eager_ms
    time = _timer()
    for op, dt, make, call, default, eager in main_ops():
        first = make()
        sets = [first] if eager else (
            [first] + _copies(make, max(_nbytes(first), 1), cap=7))
        reps = 8 if _nbytes(first) > 2 ** 29 else 20
        for cfg in _configs(default):
            try:
                rel = _rel(call(first, cfg), call(first, cfg, "ref"))
            except (ValueError, NotImplementedError) as exc:
                emit(dict(section="main", op=op, dtype=dt,
                          d=cfg.stride_unroll, p=cfg.portion_unroll,
                          bm=cfg.block_rows, refused=str(exc)[:200]))
                continue
            ms = (eager_ms(lambda *i: call(i, cfg), first) if eager
                  else time(lambda *i: call(i, cfg), sets, reps))
            _point(emit, "main", op, dt, cfg, ms, rel,
                   default=cfg == default)
        del first, sets
        torch.cuda.empty_cache()


def section_resolved(emit):
    """Each main-path op at the config it resolves to with none given,
    against its static default, alternated (default, resolved, resolved,
    default)."""
    import torch
    from chip_smoke import _copies, eager_ms
    from repro_torch import obs
    time = _timer()
    for op, dt, make, call, default, eager in main_ops():
        first = make()
        sets = [first] if eager else (
            [first] + _copies(make, max(_nbytes(first), 1), cap=7))
        reps = 8 if _nbytes(first) > 2 ** 29 else 20
        with obs.collect() as col:
            call(first, None)
        res = [e for e in col.named("kernel.resolve")]
        ev = res[0].attrs if res else {}
        from repro_torch.core.striding import StridingConfig
        cfg = StridingConfig(ev.get("d", 1), ev.get("p", 1),
                             block_rows=ev.get("block_rows", 0))
        rel = _rel(call(first, None), call(first, default, "ref"))
        times = {}
        for which in ("default", "resolved", "resolved", "default"):
            c = default if which == "default" else None
            t = (eager_ms(lambda *i: call(i, c), first, reps=10) if eager
                 else time(lambda *i: call(i, c), sets, reps))
            times.setdefault(which, []).append(t)
        emit(dict(section="resolved", op=op, dtype=dt,
                  source=ev.get("source"), d=cfg.stride_unroll,
                  p=cfg.portion_unroll, bm=cfg.block_rows,
                  default=[default.stride_unroll, default.portion_unroll,
                           default.block_rows],
                  resolved_ms=times["resolved"],
                  default_ms=times["default"], rel_err=rel,
                  ratio=sum(times["resolved"]) / sum(times["default"])))
        del first, sets
        torch.cuda.empty_cache()


def one(section: str) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    from repro_torch.kernels import cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda.build()
    fn = {"dp": section_dp, "pitch": section_pitch, "main": section_main,
          "resolved": section_resolved}[section]
    fn(lambda row: print(json.dumps(row), flush=True))
    return 0


def measure(sections, out_path) -> int:
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    rc = 0
    with open(out_path, "a") as f:
        for sec in sections:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", sec],
                cwd=ROOT, capture_output=True, text=True)
            for line in proc.stdout.splitlines():
                print(line, flush=True)
                if line.startswith("{"):
                    f.write(line + "\n")
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-6000:])
                print(f"section {sec}: exit {proc.returncode}", flush=True)
                rc = proc.returncode
    print(_card())
    return rc


FIT_OPS = {"stream_copy": (1, 1), "stream_read": (1, 0),
           "stream_triad": (2, 1), "stream_init": (0, 1)}


def fit_points(rows):
    """The K1 / K2 stream points of a sweep (bm 0) as the stream model's
    ``(d, p, itemsize, write streams, bytes/s)``: each (op, dtype)'s rates
    scaled so that its best equals the best of all (the model ranks by
    the shape of the surface; each op's own ceiling differs by a few %)."""
    groups: dict = {}
    for r in rows:
        if (r.get("section") in ("dp", "main") and r.get("op") in FIT_OPS
                and "ms" in r and not r.get("bm")):
            groups.setdefault((r["op"], r["dtype"]), []).append(r)
    top = 0.0
    for (op, dt), g in groups.items():
        n = STREAM_SHAPE[0] * STREAM_SHAPE[1]
        item = 2 if dt == "bfloat16" else 4
        for r in g:
            r["bw"] = n * item * sum(FIT_OPS[op]) / (r["ms"] * 1e-3)
        top = max(top, max(r["bw"] for r in g))
    pts = []
    for (op, dt), g in sorted(groups.items()):
        best = max(r["bw"] for r in g)
        for r in g:
            pts.append(((r["op"], dt), r["d"], r["p"],
                        2 if dt == "bfloat16" else 4,
                        r["d"] * FIT_OPS[op][1], r["bw"] / best * top))
    return pts


def planned_ops():
    """{(op, dtype): (Traffic, the parent's static default)} of the swept
    ops whose wrappers plan (``gemver_sum`` passes no Traffic), with the
    Traffic their wrappers build at the swept shapes."""
    import torch
    from repro_torch.core.planner import Traffic
    from repro_torch.core.striding import StridingConfig
    from repro_torch.kernels.adamw.ops import _blocking
    d4p1, d4p2, d2p2 = ((4, 1, 0), (4, 2, 0), (2, 2, 0))
    f32, bf = torch.float32, torch.bfloat16
    rows, cols = STREAM_SHAPE
    n = LINALG_N
    out = {("decode_attn", "bfloat16"): (Traffic(4096, 4 * 128, bf,
                                                 read_arrays=2), d4p1),
           ("gemver_outer", "float32"): (Traffic(n, n, f32, read_arrays=1,
                                                 write_arrays=1), d4p2),
           ("stream_init", "float32"): (Traffic(rows, cols, f32,
                                                read_arrays=0,
                                                write_arrays=1), d4p2),
           ("stream_triad", "float32"): (Traffic(rows, cols, f32,
                                                 read_arrays=2,
                                                 write_arrays=1), d4p2)}
    for dt in (f32, bf):
        name = str(dt)[6:]
        out[("mxv", name)] = (Traffic(n, n, dt, read_arrays=1), d4p2)
        out[("mxv_t", name)] = (Traffic(n, n, dt, read_arrays=2), d4p2)
        out[("stream_copy", name)] = (Traffic(rows, cols, dt, read_arrays=1,
                                              write_arrays=1), d4p2)
        out[("stream_read", name)] = (Traffic(rows, cols, dt), d4p2)
    for shape in (EMBED, ADAMW_BENCH):
        r, c = _blocking(shape[0] * shape[1])
        out[(f"adamw_update {list(shape)}", "float32")] = (
            Traffic(r, c, f32, read_arrays=4, write_arrays=3), d2p2)
    del StridingConfig
    return out


def _measured(rows) -> dict:
    """{(op, dtype): {(d, p, bm): ms}} of the dp and main sections."""
    out: dict = {}
    for r in rows:
        if r.get("section") in ("dp", "main") and "ms" in r:
            out.setdefault((r["op"], r["dtype"]), {})[
                (r["d"], r["p"], r["bm"])] = r["ms"]
    return out


def planner_check(model, measured, ops, tolerance: float = 0.03):
    """[(op, dtype, planned (d, p, bm), ms, default ms, ratio)] of every
    planned op under ``model``, and whether every ratio is within
    ``tolerance`` of the default's time."""
    from repro_torch.core.planner import plan
    rows, ok = [], True
    for key, (traffic, default) in ops.items():
        times = measured.get(key)
        if not times:
            continue
        c = plan(traffic, model=model).config
        got = (c.stride_unroll, c.portion_unroll, c.block_rows)
        ms = times.get(got)
        ratio = ms / times[default] if ms is not None else None
        ok = ok and ratio is not None and ratio <= 1 + tolerance
        rows.append((*key, got, ms, times[default], ratio))
    return rows, ok


def fit(path: str) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import dma_model
    rows = [json.loads(l) for l in open(path) if l.startswith("{")]
    pts = fit_points(rows)
    measured, ops = _measured(rows), planned_ops()
    model, resid = dma_model.fit_model(
        [p[1:] for p in pts],
        accept=lambda m: planner_check(m, measured, ops)[1])
    print(f"fitted: hbm_bw {model.hbm_bw:.6g} B/s, latency "
          f"{model.latency:.6g} s, stream_bw {model.stream_bw:.6g} B/s, "
          f"n_streams {model.n_streams} (rms relative residual "
          f"{resid:.4f})")
    for (op, dt), d, p, item, nw, bw in pts:
        pred = dma_model.predict(model, d, p, item, nw)
        print(f"{op} {dt} D={d} P={p}: {bw / 1e12:.3f} TB/s (scaled); "
              f"model {pred / 1e12:.3f} ({pred / bw - 1:+.1%})")
    checks, ok = planner_check(model, measured, ops)
    for op, dt, got, ms, dms, ratio in checks:
        print(f"planned {op} {dt}: D={got[0]} P={got[1]} bm={got[2]} "
              f"{ms} ms against the default's {dms:.5g} ms "
              f"(ratio {ratio})")
    print(f"every planned op within 3% of its default: {ok}")
    pitch = [r for r in rows if r.get("section") == "pitch" and "ms" in r]
    for r in pitch:
        if r["pitch"] & (r["pitch"] - 1):
            continue
        other = next((o for o in pitch if o["op"] == r["op"]
                      and o["pitch"] == r["pitch"] + PITCH_EXTRA), None)
        if other:
            rate, rate_o = (x["bytes"] / x["ms"] / 1e9 for x in (r, other))
            print(f"pitch {r['op']} 2^{r['pitch'].bit_length() - 1} B: "
                  f"{r['ms']:.5f} ms ({rate:.3f} TB/s), +{PITCH_EXTRA} B: "
                  f"{other['ms']:.5f} ms ({rate_o:.3f} TB/s); time a byte, "
                  f"power of two / other: {rate_o / rate:.4f}")
    for r in rows:
        if r.get("section") == "resolved":
            print(f"resolved {r['op']} {r['dtype']}: {r['source']} D={r['d']}"
                  f" P={r['p']} bm={r['bm']} {r['resolved_ms']} ms; static "
                  f"default {r['default']} {r['default_ms']} ms; ratio "
                  f"{r['ratio']:.4f}")
    return 0


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        return one(args[1])
    if args[:1] == ["--fit"]:
        return fit(args[1])
    out = os.path.join(ROOT, "chiprun_out", "stream_fit.jsonl")
    if "--out" in args:
        i = args.index("--out")
        out = args[i + 1]
        del args[i:i + 2]
    sections = args or list(SECTIONS)
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        print(__doc__, file=sys.stderr)
        return 2
    return measure(sections, out)


if __name__ == "__main__":
    sys.exit(main())
