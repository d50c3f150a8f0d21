"""Analytical memory-stream concurrency models.

Two models share one latency-hiding core (Little's law:
``throughput = min(peak, outstanding_bytes / latency)``):

* :class:`StreamModel` — the *target* model: D concurrent global-memory
  streams of the port's hand kernels, each keeping ``lookahead`` units
  of P portions in flight.  The planner scores candidate
  ``StridingConfig``\\ s with it.  It has the form of the JAX package's
  ``TpuDmaModel`` (``src/repro/core/dma_model.py``: a per-stream ring,
  a number of streams usefully engaged, the §4.5 aliasing penalty and
  the §4.4 write-stream cap); :data:`H100_STREAMS` holds the card's
  constants, fitted by :func:`fit_model` to the D × P sweep of
  ``tools/torch_stream_fit.py``.

* :class:`CpuPrefetchModel` — the *paper-validation* model: the shape
  of the paper's Fig 2/3/4 curves (throughput, stall cycles, hit ratios
  against stride count) for the Coffee Lake L2 streamer, calibrated to
  the paper's +33%/+13%/+11% read/write/copy gains at 16 strides.  Pure
  arithmetic, as in the JAX package.

Both models treat the §4.5 collision as a multiplicative efficiency loss
when concurrent streams alias (``layout.collides``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

from repro_torch.core import layout
from repro_torch.core.striding import StridingConfig

__all__ = ["StreamModel", "CpuPrefetchModel", "H100_STREAMS",
           "COFFEE_LAKE", "default_model", "fit_model", "predict"]


@dataclasses.dataclass(frozen=True)
class StreamModel:
    """Little's-law model of D concurrent memory streams on one device."""

    hbm_bw: float                 # bytes/s the device sustains at best
    latency: float                # s — issue → first byte of one step
    stream_bw: float              # bytes/s — one stream's ceiling
    n_streams: int                # streams usefully engaged at once
    descriptor_overhead: float = 0.0   # s per step (strided blocks)
    layout: layout.Layout = layout.H100_LAYOUT

    def stream_bandwidth(self, block_bytes: int, lookahead: int) -> float:
        """Sustained bytes/s of ONE stream with a ``lookahead``-deep ring
        of ``block_bytes`` steps; each step pays the issue latency plus
        one descriptor."""
        in_flight = max(lookahead - 1, 0) * block_bytes + block_bytes
        issue = self.latency + self.descriptor_overhead
        latency_bound = in_flight / (issue + block_bytes / self.stream_bw)
        return min(latency_bound, self.stream_bw)

    def throughput(self, config: StridingConfig, block_bytes: int,
                   spacing_bytes: Optional[int] = None,
                   n_write_streams: int = 0) -> float:
        """Predicted aggregate bytes/s for a multi-strided traversal."""
        d = config.stride_unroll
        per_stream = self.stream_bandwidth(block_bytes * config.portion_unroll,
                                           config.lookahead)
        engaged = min(d, self.n_streams)
        agg = engaged * per_stream
        # paper §4.5: aliased spacing → streams thrash the same banks
        if (spacing_bytes is not None and d > 1
                and layout.collides(spacing_bytes, self.layout)):
            agg *= 1.0 / (1.0 + 0.25 * d)
        # paper §4.4: too many concurrent write streams contend; soft cap
        if n_write_streams > self.n_streams // 2:
            agg *= (self.n_streams // 2) / n_write_streams
        return min(agg, self.hbm_bw)


# Fitted by fit_model (tools/torch_stream_fit.py --fit) to the D × P
# sweep of the K1 copy and the K2 read at [8192, 4096] in f32 and bf16,
# with the K1 triad and init in f32, on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit (PERF.md §6): the least-error model under
# which every swept op's planned config runs within 3% of its static
# default (rms residual 16%; the least-error model overall, 10%, rates
# D = 2, P = 1 at the ceiling, where the triad runs 26% slower).
H100_STREAMS = StreamModel(hbm_bw=3.02181e12, latency=5.01187e-10,
                           stream_bw=2.85277e12, n_streams=8)


def default_model(descriptor_overhead: Optional[float] = None
                  ) -> StreamModel:
    """The planner's scoring model: :data:`H100_STREAMS`, with its
    per-step descriptor term replaced where one is given (seconds)."""
    if descriptor_overhead is None:
        return H100_STREAMS
    return dataclasses.replace(H100_STREAMS,
                               descriptor_overhead=descriptor_overhead)


def predict(model: StreamModel, d: int, p: int, item: int,
            n_write: int = 0) -> float:
    """The model's bytes/s for D streams of P units of ``item``-byte
    elements at lookahead 2, with ``n_write`` write streams."""
    rows = model.layout.unit_rows[item]
    return model.throughput(StridingConfig(d, p),
                            rows * model.layout.lane * item,
                            n_write_streams=n_write)


def fit_model(points: Sequence[tuple[int, int, int, int, float]],
              base: StreamModel = H100_STREAMS,
              accept: Optional[Callable[[StreamModel], bool]] = None,
              ) -> tuple[StreamModel, float]:
    """Fit the issue latency, the per-stream ceiling and the number of
    streams engaged to measured points ``(d, p, itemsize, n_write,
    bytes/s)`` by grid search on the rms of the log ratio of predicted to
    measured bandwidth; the device ceiling is the best measured rate.
    Where ``accept`` is given, the best-fitting model it accepts wins
    (the least-error one where it accepts none).  Returns (model, rms
    relative residual)."""
    hbm = max(bw for *_, bw in points)
    fits = []
    for li in range(71):
        lat = 1e-12 * 10 ** (li / 10)         # 1 ps .. 10 µs
        for si in range(41):
            sbw = hbm * 10 ** (-si / 40)      # the ceiling .. 10% of it
            for n in (2, 4, 8, 12, 16, 24, 32, 64):
                m = dataclasses.replace(base, hbm_bw=hbm, latency=lat,
                                        stream_bw=sbw, n_streams=n)
                err = sum(math.log(predict(m, d, p, it, nw) / bw) ** 2
                          for d, p, it, nw, bw in points)
                fits.append((err, len(fits), m))
    fits.sort(key=lambda f: f[:2])
    pick = next((f for f in fits if accept is None or accept(f[2])),
                fits[0])
    return pick[2], math.expm1(math.sqrt(pick[0] / len(points)))


@dataclasses.dataclass(frozen=True)
class CpuPrefetchModel:
    """Qualitative model of a stride-detecting HW prefetcher (paper Fig 2-4).

    Calibration targets (paper §4.3/§4.4/§4.6, Coffee Lake i7-8700):
      reads  +33% at 16 strides; writes +3-13%; copy +5-11%;
      prefetcher off: flat-to-declining in D;
      power-of-two spacing: collapse growing with D (Fig 5).
    """

    peak_bw: float = 19.87e9       # bytes/s (paper Table 2)
    mem_latency: float = 81e-9     # s
    line_bytes: int = 64
    n_prefetch_engines: int = 16   # streams trackable by L1+L2 prefetchers
    prefetch_depth_1: float = 13.0 # lines in flight for a single stream
    depth_decay: float = 0.22      # per-stream depth shrinks as engines split
    demand_mlp: float = 10.0       # demand-miss parallelism (MLBP w/o prefetch)

    def lines_in_flight(self, d: int, prefetch_on: bool = True) -> float:
        if not prefetch_on:
            # out-of-order window sustains ~demand_mlp misses regardless of D,
            # slightly degrading with D (more DTLB/issue pressure).
            return self.demand_mlp * (1.0 - 0.004 * (d - 1))
        engaged = min(d, self.n_prefetch_engines)
        depth = self.prefetch_depth_1 / (1.0 + self.depth_decay * (engaged - 1)) ** 0.5
        extra = self.demand_mlp * 0.35
        total = engaged * depth + extra
        if d > self.n_prefetch_engines:  # un-tracked streams demand-miss
            total *= self.n_prefetch_engines / d
        return total

    def throughput(self, d: int, prefetch_on: bool = True,
                   aliased: bool = False, write_fraction: float = 0.0) -> float:
        lines = self.lines_in_flight(d, prefetch_on)
        if aliased and d > 1:
            # concurrent streams hitting one set evict each other's
            # prefetched lines; grows with D (Fig 5).
            lines /= (1.0 + 0.45 * (d - 1))
        bw = min(lines * self.line_bytes / self.mem_latency, self.peak_bw)
        if write_fraction > 0:
            # RFO + writeback halves effective useful bandwidth share and the
            # prefetcher covers only the read part (paper: writes gain less).
            read_bw = bw
            wb_cost = 1.0 + write_fraction
            bw = read_bw / wb_cost
        return bw

    # -- Fig 3/4 derived observables ------------------------------------
    def hit_ratio(self, d: int, level: str, prefetch_on: bool = True) -> float:
        """Modeled cache hit ratio at L1/L2/L3 (paper Fig 4)."""
        if not prefetch_on:
            return {"l1": 0.5, "l2": 0.0, "l3": 0.0}[level]
        cover = self.lines_in_flight(d, True) / (
            self.lines_in_flight(self.n_prefetch_engines, True))
        cover = min(cover, 1.0)
        if level == "l1":
            return 0.5  # consumption outruns L1 fill (paper §4.3)
        if level == "l2":
            return min(0.25 + 0.55 * cover, 0.9)
        if level == "l3":
            return min(0.45 + 0.5 * cover, 0.95)
        raise ValueError(level)

    def stall_cycles_per_line(self, d: int, freq_hz: float = 3.2e9,
                              prefetch_on: bool = True) -> float:
        """Modeled execution stalls w/ outstanding loads per line (Fig 3)."""
        bw = self.throughput(d, prefetch_on)
        t_line = self.line_bytes / bw
        t_min = self.line_bytes / self.peak_bw
        return max(t_line - 0.25 * t_min, 0.0) * freq_hz


COFFEE_LAKE = CpuPrefetchModel()
