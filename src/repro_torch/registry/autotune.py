"""Empirical (D, P) autotuner over the kernel registry.

The analytic planner (``repro_torch.core.planner``) predicts bandwidth;
the paper's method is exhaustive *measurement* per kernel and
micro-architecture (§6.3).  :func:`tune` takes the planner's ranked
candidate configs, times the registered kernel variant at each, and
persists the measured best in the tune cache, so that later op calls
resolve

    explicit config  >  tune-cache (measured best)  >  planner model
    >  static default

without measuring again, as the JAX package's autotuner
(``src/repro/registry/autotune.py``) does.  :func:`tune_all` sweeps every
registered kernel.

How a candidate is timed (:func:`_measure`):

  * on the card (CUDA inputs, the hand kernels): ten calls over
    input copies that together exceed 3x the L2 (each call finds its
    inputs cold), every output held to the end (an output that fits L2
    would otherwise stay there between calls), captured in one CUDA
    graph; each of ``iters`` samples is one replay between CUDA events,
    divided by the calls.  Where a call cannot be captured, each sample
    is the same calls run eagerly between the events;
  * on the CPU (the plain versions): ``perf_counter`` around each call.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core.planner import rank_configs, traffic_bytes
from repro_torch.core.striding import (SINGLE_STRIDED, StridingConfig,
                                       valid_stride_unrolls)
from repro_torch.registry import base, tunecache
from repro_torch.roofline.hw import H100_HW

__all__ = ["TuneResult", "TrialTimeout", "tune", "tune_all",
           "candidate_configs"]

# fallback sweep when a spec has no Traffic signature (or the planner
# rejects every point): the paper's low-D corner of the space
_FALLBACK = (StridingConfig(1, 1), StridingConfig(2, 1),
             StridingConfig(2, 2), StridingConfig(4, 1),
             StridingConfig(4, 2))

# §5.1.1 cache-block tiles added to every (D, P) sweep (0 = the emitter's
# default); the planner prunes infeasible (block, D, P) points against
# its budget before anything is measured
_BLOCK_CANDIDATES = (0, 4, 16)

# calls a sample on the card: enough that a sample of a 10 µs kernel is
# 100 µs between its events
_REPS = 10


@dataclasses.dataclass(frozen=True)
class TuneResult:
    kernel: str
    key: str
    config: StridingConfig
    seconds: float
    mode: str
    from_cache: bool
    trials: tuple[tuple[StridingConfig, float], ...] = ()
    predicted_bw: float = 0.0


class TrialTimeout(RuntimeError):
    """A single autotune measurement exceeded the per-trial budget."""


def _shape(spec: base.KernelSpec, sizes: Mapping[str, int]) -> tuple:
    return (spec.cache_shape(sizes) if spec.cache_shape is not None
            else tuple(sizes.values()))


def _fallback_configs(spec: base.KernelSpec, sizes: Mapping[str, int],
                      max_candidates: int,
                      ) -> list[tuple[StridingConfig, float]]:
    """The low-D fallback sweep, validated against the problem: each
    candidate's stride_unroll is lowered to the largest valid divisor of
    the row extent and the list deduplicated — a D the kernel would
    clamp anyway is not measured twice under two labels."""
    shape = _shape(spec, sizes)
    rows = int(shape[0]) if shape else 1
    valid = set(valid_stride_unrolls(rows))
    out: list[tuple[StridingConfig, float]] = []
    seen: set[tuple[int, int]] = set()
    for cfg in _FALLBACK:
        d = cfg.stride_unroll
        if d not in valid:
            d = max((v for v in valid if v < d), default=1)
        key = (d, cfg.portion_unroll)
        if key in seen:
            continue
        seen.add(key)
        if d != cfg.stride_unroll:
            cfg = cfg.replace(stride_unroll=d)
        out.append((cfg, 0.0))
        if len(out) >= max_candidates:
            break
    return out


def candidate_configs(spec: base.KernelSpec, sizes: Mapping[str, int],
                      dtype, max_candidates: int = 8,
                      ) -> list[tuple[StridingConfig, float]]:
    """Planner-ranked (config, predicted_bw) candidates for one problem,
    gated through the port's emitter on the row's traversal."""
    if spec.traffic is not None:
        trav = None
        if spec.traversal is not None:
            try:
                trav = spec.traversal(sizes, dtype)
            except Exception:     # noqa: BLE001 — screening is best-effort
                trav = None
        try:
            ranked = rank_configs(spec.traffic(sizes, dtype),
                                  block_rows_candidates=_BLOCK_CANDIDATES,
                                  spec=trav)
            out, seen, dp_seen = [], set(), set()
            for cfg, bw, _cols in ranked:
                key = (cfg.stride_unroll, cfg.portion_unroll, cfg.block_rows)
                if key in seen:
                    continue
                seen.add(key)
                out.append((cfg, bw))
                dp_seen.add(key[:2])
                # the block dimension must not crowd out distinct (D, P)
                # coverage: fill until max_candidates distinct (D, P)
                # pairs, capped at 2x total measurements
                if (len(dp_seen) >= max_candidates
                        or len(out) >= 2 * max_candidates):
                    break
            return out
        except ValueError:
            pass
    return _fallback_configs(spec, sizes, max_candidates)


def _median(ts: Sequence[float]) -> float:
    """True median: even sample counts average the two middle samples."""
    s = sorted(ts)
    n = len(s)
    mid = n // 2
    if n % 2:
        return s[mid]
    return 0.5 * (s[mid - 1] + s[mid])


def _reject_outliers(ts: Sequence[float], k: float = 5.0,
                     ) -> tuple[list[float], int]:
    """Drop samples farther than ``k`` median-absolute-deviations from
    the median (a stall inflating one sample must not move the winner).
    Returns (kept, n_rejected); with a degenerate MAD the originals are
    kept."""
    med = _median(ts)
    mad = _median([abs(t - med) for t in ts])
    if mad <= 0.0:
        return list(ts), 0
    kept = [t for t in ts if abs(t - med) <= k * mad]
    if not kept:
        return list(ts), 0
    return kept, len(ts) - len(kept)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(t) for t in x)
    return 0


def _input_sets(spec, sizes, dtype, device, first) -> list:
    """Enough copies of the inputs (at most 8) that one pass over them
    exceeds 3x the card's L2, so each call finds its inputs cold."""
    each = max(_nbytes(first), 1)
    n = max(1, min(8, -(-3 * H100_HW.l2_bytes // each)))
    return [first] + [spec.make_inputs(sizes, dtype, device)
                      for _ in range(n - 1)]


def _device_samples(call, sets, iters: int) -> list[float]:
    """``iters`` CUDA-event samples of ``_REPS`` calls (at least one a
    set) over ``sets`` with every output held (see the module doc), in
    seconds per call."""
    reps = max(_REPS, len(sets))
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    graph, held = torch.cuda.CUDAGraph(), []
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for a in sets:
                call(a)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            for i in range(reps):
                held.append(call(sets[i % len(sets)]))
        graph.replay()
        run = graph.replay
    except RuntimeError:
        # not capturable: time the same calls eagerly
        del graph
        graph, held = None, []
        torch.cuda.synchronize()

        def run():
            held.clear()
            for i in range(reps):
                held.append(call(sets[i % len(sets)]))
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        t0.record()
        run()
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1) * 1e-3 / reps)
    del graph, held
    return out


def _measure(spec: base.KernelSpec, sets: list, cfg: StridingConfig,
             mode: str, iters: int, warmup: int,
             timeout_s: Optional[float] = None) -> tuple[float, int]:
    """Median seconds of one call after ``warmup`` calls, with MAD
    outlier rejection; returns (median, n_outliers_rejected).  Raises
    :class:`TrialTimeout` when a call (on the CPU) or a sample (on the
    card) takes longer than ``timeout_s``.  Fault sites: ``tune_trial``
    (the candidate raises), ``tune_slow`` (each call stalls),
    ``tune_outlier`` (one sample inflated, which the MAD filter must
    absorb).

    Every call runs ``cfg`` and nothing else
    (``common.exact_config``): a candidate that fails raises here, and
    is never timed under another config by the guard's fallback chain."""
    from repro_torch.kernels import common
    from repro_torch.runtime import faults

    faults.fire_if("tune_trial", spec.name)
    run_mode = None if mode == "cuda" else "ref"   # None: by the device

    def call(inputs):
        faults.sleep_if("tune_slow", spec.name, seconds=0.05)
        with common.exact_config():
            return spec.run(inputs, cfg, run_mode)

    def check(dt):
        if timeout_s is not None and dt > timeout_s:
            raise TrialTimeout(
                f"{spec.name} candidate d={cfg.stride_unroll} "
                f"p={cfg.portion_unroll}: {dt:.3f}s > {timeout_s:.3f}s")

    for i in range(warmup):
        t0 = time.perf_counter()
        call(sets[i % len(sets)])
        check(time.perf_counter() - t0)
    if mode == "cuda":
        ts = _device_samples(call, sets, iters)
        for t in ts:
            check(t * max(_REPS, len(sets)))
    else:
        ts = []
        for i in range(iters):
            t0 = time.perf_counter()
            call(sets[i % len(sets)])
            ts.append(time.perf_counter() - t0)
            check(ts[-1])
    if faults.should_fire("tune_outlier", spec.name):
        ts[0] = max(ts) * 100.0 + 1.0
    kept, rejected = _reject_outliers(ts)
    return _median(kept), rejected


def _problem_bytes(spec: base.KernelSpec, sizes: Mapping[str, int],
                   dtype) -> Optional[int]:
    """Traffic bytes of one traversal, or None without a signature."""
    if spec.traffic is None:
        return None
    try:
        return traffic_bytes(spec.traffic(sizes, dtype))
    except (ValueError, TypeError, KeyError):
        return None


def _rehydrate_trials(entry: Mapping[str, Any],
                      ) -> tuple[tuple[StridingConfig, float], ...]:
    """The measured sweep of a cache entry's ``trials`` list, so a cache
    hit shows the trials a fresh sweep returns."""
    look = int(entry.get("lookahead", 2))
    arr = entry.get("arrangement", "grouped")
    out = []
    for t in entry.get("trials", ()):
        out.append((StridingConfig(int(t["d"]), int(t["p"]),
                                   lookahead=look, arrangement=arr,
                                   block_rows=int(t.get("block_rows", 0))),
                    float(t["seconds"])))
    return tuple(out)


def _launched(before: dict) -> list[str]:
    """Sources (``csrc`` stems) of the kernels launched since ``before``
    (a snapshot of ``cuda.KERNELS`` launch counts)."""
    from repro_torch.kernels import cuda
    return sorted({k.source for n, k in cuda.KERNELS.items()
                   if k.launches != before.get(n, 0)})


def tune(kernel, sizes: Optional[Mapping[str, int]] = None,
         dtype=torch.float32, device=None, mode: Optional[str] = None,
         cache: Optional[tunecache.TuneCache] = None, force: bool = False,
         max_candidates: int = 8, iters: int = 5, warmup: int = 2,
         timestamp: Optional[float] = None,
         trial_timeout_s: Optional[float] = None) -> TuneResult:
    """Measured sweep for one kernel; cached on disk, hit on re-tune.

    ``device`` follows the entry points' rule: the card unless the caller
    asks for the CPU (``device="cpu"``: the plain versions, timed with
    ``perf_counter``).  ``mode="ref"`` times the plain versions on the
    card.  Each candidate gets ``warmup`` discarded calls and the median
    of ``iters`` samples (see the module doc); a call or
    sample longer than ``trial_timeout_s`` abandons the candidate.

    Every cache entry records provenance (``timestamp`` — pass the
    caller's clock, e.g. ``time.time()`` — the device, the torch and
    CUDA versions, the hash of each kernel source the sweep launched and
    the timing knobs).  With telemetry on, each measured candidate emits
    a ``tune.trial`` event (config, median seconds, the planner's
    ``predicted_bw``, measured GiB/s from the row's Traffic bytes) and
    cache hits and misses tick ``tune.cache.hit`` / ``.miss``.

    The sweep is self-healing: a candidate that raises is quarantined and
    skipped (``tune.candidate_failed``), one over the trial time limit is
    abandoned (``tune.trial_timeout``), samples beyond 5 MADs of the
    median are rejected (``tune.outlier_rejected``), and a stale cache
    entry is measured again (``tune.cache.stale``).  If every candidate
    fails, the sweep returns the single-strided floor without writing
    the cache.  A hit launches nothing."""
    from repro_torch.kernels import common
    spec = kernel if isinstance(kernel, base.KernelSpec) else base.get(kernel)
    sizes = dict(sizes if sizes is not None else spec.default_sizes)
    dev = common.resolve_device(device)
    mode = common.kernel_mode(dev, mode)
    cache = cache or tunecache.default_cache()
    key = tunecache.cache_key(spec.name, _shape(spec, sizes), dtype, dev,
                              mode)

    if not force:
        entry = cache.lookup(key)
        if entry is not None and not tunecache.entry_is_fresh(entry):
            # provenance says another build or version measured this
            obs.counter("tune.cache.stale", kernel=spec.name, mode=mode)
            entry = None
        if entry is not None:
            obs.counter("tune.cache.hit", kernel=spec.name, mode=mode)
            result = TuneResult(
                kernel=spec.name, key=key,
                config=tunecache._entry_config(entry),
                seconds=float(entry.get("seconds", 0.0)), mode=mode,
                from_cache=True, trials=_rehydrate_trials(entry),
                predicted_bw=float(entry.get("predicted_bw", 0.0)))
            if obs.enabled():
                obs.event("tune.result", kernel=spec.name, key=key,
                          from_cache=True, d=result.config.stride_unroll,
                          p=result.config.portion_unroll,
                          block_rows=result.config.block_rows,
                          seconds=result.seconds, mode=mode)
            return result

    obs.counter("tune.cache.miss", kernel=spec.name, mode=mode)
    from repro_torch.kernels import cuda
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    first = spec.make_inputs(sizes, dtype, dev)
    sets = (_input_sets(spec, sizes, dtype, dev, first)
            if mode == "cuda" else [first])
    iters, warmup = max(iters, 1), max(warmup, 0)
    timeout_s = trial_timeout_s if trial_timeout_s else None
    nbytes = _problem_bytes(spec, sizes, dtype)
    trials = []
    for cfg, bw in candidate_configs(spec, sizes, dtype, max_candidates):
        if cache.is_quarantined(key, cfg):
            # a config recorded as failing is not measured again
            obs.counter("tune.candidate_quarantined", kernel=spec.name)
            continue
        try:
            sec, n_outliers = _measure(spec, sets, cfg, mode, iters,
                                       warmup, timeout_s)
        except (KeyboardInterrupt, SystemExit):
            raise
        except TrialTimeout:
            obs.counter("tune.trial_timeout", kernel=spec.name,
                        d=cfg.stride_unroll, p=cfg.portion_unroll)
            continue
        except Exception as exc:             # noqa: BLE001 — recorded
            failure = type(exc).__name__
            cache.quarantine(key, cfg, failure)
            obs.counter("tune.candidate_failed", kernel=spec.name,
                        failure=failure, d=cfg.stride_unroll,
                        p=cfg.portion_unroll)
            continue
        if n_outliers:
            obs.counter("tune.outlier_rejected", float(n_outliers),
                        kernel=spec.name, d=cfg.stride_unroll,
                        p=cfg.portion_unroll)
        trials.append((cfg, sec, bw))
        if obs.enabled():
            obs.event("tune.trial", kernel=spec.name,
                      d=cfg.stride_unroll, p=cfg.portion_unroll,
                      block_rows=cfg.block_rows, seconds=sec,
                      predicted_bw=bw,
                      measured_gibs=(nbytes / sec / 2**30
                                     if nbytes and sec > 0 else None),
                      mode=mode)
    del first, sets
    if not trials:
        # every candidate raised, timed out or was quarantined: the
        # single-strided floor, without poisoning the cache
        obs.event("tune.exhausted", kernel=spec.name, key=key, mode=mode)
        return TuneResult(kernel=spec.name, key=key,
                          config=SINGLE_STRIDED, seconds=float("inf"),
                          mode=mode, from_cache=False)
    trials.sort(key=lambda t: t[1])
    best_cfg, best_sec, best_bw = trials[0]
    cache.store(key, {
        "d": best_cfg.stride_unroll, "p": best_cfg.portion_unroll,
        "lookahead": best_cfg.lookahead,
        "arrangement": best_cfg.arrangement,
        "block_rows": best_cfg.block_rows,
        "seconds": best_sec, "predicted_bw": best_bw, "mode": mode,
        "source": "autotune",
        "provenance": tunecache.provenance(
            _launched(before), timestamp=timestamp,
            device=tunecache.device_kind(dev), iters=iters, warmup=warmup),
        "trials": [{"d": c.stride_unroll, "p": c.portion_unroll,
                    "block_rows": c.block_rows,
                    "seconds": s} for c, s, _ in trials],
    })
    if obs.enabled():
        obs.event("tune.result", kernel=spec.name, key=key,
                  from_cache=False, d=best_cfg.stride_unroll,
                  p=best_cfg.portion_unroll,
                  block_rows=best_cfg.block_rows, seconds=best_sec,
                  predicted_bw=best_bw, mode=mode)
    return TuneResult(kernel=spec.name, key=key, config=best_cfg,
                      seconds=best_sec, mode=mode, from_cache=False,
                      trials=tuple((c, s) for c, s, _ in trials),
                      predicted_bw=best_bw)


def tune_all(kernels: Optional[Sequence[str]] = None,
             **kw: Any) -> dict[str, TuneResult]:
    """Sweep every (or the named) registered kernel; {name: TuneResult}."""
    specs = ([base.get(k) for k in kernels] if kernels is not None
             else base.all_specs())
    return {s.name: tune(s, **kw) for s in specs}
