"""Shard-aware token data pipeline with multi-strided host readahead.

Numpy only, as in the JAX package (``src/repro/data/pipeline.py``), so
the port yields the same tokens bit for bit.

Two sources behind one iterator API:
  * SyntheticTokens — deterministic per-(step, shard) PRNG stream; used by
    examples/tests and for dry-runs. Restart-safe: batch(step) is a pure
    function, so resuming from a checkpoint replays identically.
  * MemmapTokens — a flat binary token file. The reader applies the
    paper's insight at the storage tier: instead of one sequential cursor
    it opens D strided cursors at maximal spacing (stream_offsets) and
    round-robins readahead across them — multi-stream prefetch keeps the
    page cache primed the same way multi-striding primes the HW
    prefetcher (§4), and is how the host side keeps up with per-pod input
    streams at scale.

Both are *deterministically shardable*: each data-parallel host pulls
only its shard (process_index-derived) and any (step, shard) pair maps to
a unique slice of the stream — elastic resharding (the JAX package's
repro.runtime.elastic, not ported yet) re-maps shards without replaying
data.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.striding import stream_offsets


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    n_shards: int = 1
    shard_id: int = 0
    seed: int = 0
    readahead_streams: int = 4      # D strided host-prefetch cursors

    @property
    def shard_batch(self) -> int:
        if self.global_batch % self.n_shards:
            raise ValueError("global_batch must divide over shards")
        return self.global_batch // self.n_shards


class SyntheticTokens:
    """batch(step) → tokens [shard_batch, seq_len] int32, pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        # unique, overlap-free counter per (step, shard)
        base = (np.int64(step) * cfg.n_shards + cfg.shard_id) * (1 << 20)
        rng = np.random.Generator(np.random.Philox(key=cfg.seed,
                                                   counter=[0, 0, 0, base]))
        return rng.integers(0, cfg.vocab_size,
                            (cfg.shard_batch, cfg.seq_len),
                            dtype=np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class MemmapTokens:
    """Strided reader over a flat int32 token file.

    The file is split into ``readahead_streams`` maximal-spacing segments
    (paper Fig 1 right); sequences are drawn round-robin across the
    stream cursors so the OS readahead keeps D concurrent positions hot.
    """

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        n_seq = len(self.tokens) // cfg.seq_len
        d = max(1, min(cfg.readahead_streams, n_seq))
        while n_seq % d:
            d -= 1
        self.n_seq = n_seq
        self.d = d
        self.offsets = stream_offsets(n_seq, d)  # in sequences

    def seq(self, idx: int) -> np.ndarray:
        s = self.cfg.seq_len
        return np.asarray(self.tokens[idx * s:(idx + 1) * s])

    def batch(self, step: int) -> np.ndarray:
        """Global order: round-robin over D strided cursors; shard-sliced."""
        cfg = self.cfg
        out = np.empty((cfg.shard_batch, cfg.seq_len), np.int32)
        seg = self.n_seq // self.d
        for i in range(cfg.shard_batch):
            flat = (step * cfg.global_batch
                    + cfg.shard_id * cfg.shard_batch + i)
            k = flat % self.d                    # stream
            j = (flat // self.d) % seg           # position within stream
            out[i] = self.seq(self.offsets[k] + j)
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_pipeline(cfg: DataConfig, path: Optional[str] = None):
    return MemmapTokens(path, cfg) if path else SyntheticTokens(cfg)
