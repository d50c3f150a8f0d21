"""Multi-striding configuration — the paper's core abstraction.

A striding configuration distributes a loop-unroll budget ``U`` over
``stride_unroll`` (D) concurrent memory streams of ``portion_unroll`` (P)
vector portions each, so that ``U = D * P`` (paper §3, Fig 1).

On Hopper a "stream" is one of D independent global-memory load
sequences a thread block keeps in flight, each offset by one segment
(``k * seg`` rows); ``lookahead`` is the number of buffers in each
stream's ring (2 = classic double-buffering, 1 = no prefetch — the
analogue of the paper's MSR prefetcher-off ablation).
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "StridingConfig",
    "SINGLE_STRIDED",
    "stream_offsets",
    "pad_to_multiple",
    "choose_block",
    "divisors",
    "valid_stride_unrolls",
]


@dataclasses.dataclass(frozen=True)
class StridingConfig:
    """Paper §3 configuration point.

    Attributes:
      stride_unroll: D — number of concurrent strides (streams).
      portion_unroll: P — vector portions processed per stream per step.
      lookahead: buffers per stream ring; 1 disables prefetch overlap
        ("prefetch_off" mode), 2 is double-buffering.
      arrangement: "grouped" (all accesses of a stream consecutive within
        the loop body — the paper's default, higher throughput §4.1) or
        "interleaved" (round-robin across streams — used for the §4.4
        non-temporal store comparison).
      block_rows: §5.1.1 cache-block size — rows each stream processes
        per step (the re-use tile).  0 = let the emitter pick its
        default.
    """

    stride_unroll: int = 1
    portion_unroll: int = 1
    lookahead: int = 2
    arrangement: str = "grouped"
    block_rows: int = 0

    def __post_init__(self):
        if self.stride_unroll < 1:
            raise ValueError(f"stride_unroll must be >= 1, got {self.stride_unroll}")
        if self.portion_unroll < 1:
            raise ValueError(f"portion_unroll must be >= 1, got {self.portion_unroll}")
        if self.lookahead < 1:
            raise ValueError(f"lookahead must be >= 1, got {self.lookahead}")
        if self.arrangement not in ("grouped", "interleaved"):
            raise ValueError(f"unknown arrangement {self.arrangement!r}")
        if self.block_rows < 0:
            raise ValueError(f"block_rows must be >= 0, got {self.block_rows}")

    @property
    def unrolls(self) -> int:
        """Total unroll budget U = D * P."""
        return self.stride_unroll * self.portion_unroll

    @property
    def is_single_strided(self) -> bool:
        return self.stride_unroll == 1

    def replace(self, **kw) -> "StridingConfig":
        return dataclasses.replace(self, **kw)


SINGLE_STRIDED = StridingConfig(1, 1)


def divisors(n: int) -> list[int]:
    """All divisors of n, ascending."""
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    small, large = [], []
    i = 1
    while i * i <= n:
        if n % i == 0:
            small.append(i)
            if i != n // i:
                large.append(n // i)
        i += 1
    return small + large[::-1]


def valid_stride_unrolls(extent: int, max_d: int = 32) -> list[int]:
    """Stride-unroll candidates that evenly divide ``extent``."""
    return [d for d in divisors(extent) if d <= max_d]


def stream_offsets(extent: int, d: int) -> list[int]:
    """Start offsets (in rows/elements) of ``d`` maximally-spaced streams.

    The paper's Fig 1 (right): streams partition the traversal axis into d
    equal segments traversed concurrently; stream k starts at k*(extent//d).
    ``extent`` must be divisible by d (the generator pads/crops to enforce
    this, mirroring the paper's divisibility constraint in §5.1.2).
    """
    if extent % d != 0:
        raise ValueError(f"extent {extent} not divisible by stride_unroll {d}")
    seg = extent // d
    return [k * seg for k in range(d)]


def pad_to_multiple(n: int, multiple: int) -> int:
    """Round n up to a multiple (paper §5.1.2: pad instead of leftovers)."""
    return -(-n // multiple) * multiple


def choose_block(extent: int, preferred: int) -> int:
    """Largest divisor of ``extent`` that is <= preferred (>= 1)."""
    b = min(preferred, extent)
    while extent % b != 0:
        b -= 1
    return b
