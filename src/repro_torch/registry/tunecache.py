"""On-disk cache of empirically-tuned (D, P) configurations.

The paper finds the best (stride_unroll, portion_unroll) point per kernel
and micro-architecture by exhaustive measurement (§6.3); this module is
the persistence layer for those measurements, as the JAX package's
``src/repro/registry/tunecache.py`` is for its own.  Entries are keyed by

    torch:kernel name | problem shape | dtype | device kind | mode

where the device kind is ``torch.cuda.get_device_name()`` on the card
and ``cpu`` on the host, and the mode is ``cuda`` (the hand kernels) or
``ref`` (the plain versions).  The ``torch:`` prefix keeps every key
apart from the JAX package's, even where the other fields agree (a
plain-version entry on the host, ``…|float32|cpu|ref``).

Location: ``$REPRO_TORCH_TUNE_CACHE`` if set, else
``~/.cache/repro_torch/tune_cache.json`` — a file of its own, so neither
package reads the other's entries.  The file layout (schema 2)::

    {"schema": 2,
     "entries":    {key: {"d": 4, "p": 2, "lookahead": 2, ...}},
     "quarantine": {key: {"4|2|0": {"reason": "resource", "count": 1}}}}

A flat ``{key: entry}`` file (schema 1) is read as its entries and
rewritten as schema 2 on the next store.

Self-healing:

  * **torn or corrupt files** — a file that fails to parse is moved aside
    to ``<path>.corrupt`` (one ``os.replace``, never deleted) and the
    cache rebuilds empty instead of failing resolution or a tune; the
    ``cache_corrupt`` fault site simulates a torn read;
  * **atomic writes** — every save goes through write-tmp + ``fsync`` +
    ``os.replace``, so an interrupted tuner never tears the file a
    reader sees;
  * **stale entries** — an entry whose provenance records another torch
    or CUDA version, or another hash of a kernel source it launched
    (``kernels.cuda.source_hash``: the tag of the library's name), is a
    miss: a PR that rebuilds a kernel invalidates its tuned entries;
  * **quarantine** — configs recorded as failing under a key are never
    resolved again, by :meth:`TuneCache.config_for` or the autotuner.

**Sibling modes.**  A ``ref`` entry never serves a ``cuda`` lookup:
timings of the plain version say nothing about the card.  A ``ref``
lookup on the card is served by the card's ``cuda`` entry where it has
no entry of its own, so that the plain version, run on the card to hold
a kernel against, computes at the config the kernel ran (some outputs'
shapes depend on it, e.g. ``stream_read``'s ``[D]``).

The file is read again only when its modification time changes.  The
per-call path of config resolution (:meth:`TuneCache.version`) looks at
that time at most every ``RECHECK_S`` seconds: a store or quarantine
through the cache shows at once, another process's within a second.
This module imports no kernel code, so the op wrappers can consult it
without an import cycle.
"""
from __future__ import annotations

import functools
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Any, Mapping, Optional

import torch

from repro_torch import obs
from repro_torch.core.striding import StridingConfig

__all__ = ["TuneCache", "default_cache", "default_path", "cache_key",
           "cached_config", "reset_default_cache", "config_key",
           "device_kind", "entry_is_fresh", "provenance",
           "SCHEMA_VERSION", "KEY_PREFIX"]

_ENV = "REPRO_TORCH_TUNE_CACHE"

SCHEMA_VERSION = 2
KEY_PREFIX = "torch:"
MODES = ("cuda", "ref")

# How often the per-call path (:meth:`TuneCache.version`) looks at the
# file's modification time: system calls are slow on the card's host,
# and every op call resolves its config (about 150 a decode step).
RECHECK_S = 1.0
# versions of every cache's contents, unique across instances
_VERSIONS = itertools.count(1)


def default_path() -> str:
    env = os.environ.get(_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tune_cache.json")


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def device_kind(device) -> str:
    """``torch.cuda.get_device_name()`` of a CUDA device, ``cpu`` for the
    host."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return _card_name(dev.index if dev.index is not None
                          else torch.cuda.current_device())
    if dev.type == "cpu":
        return "cpu"
    raise ValueError(f"no tune cache keys for device {dev}")


def _mode_device(mode: Optional[str], device) -> tuple[str, Any]:
    """(mode, device) with the defaults filled in: the mode follows the
    device (``cuda`` on the card, ``ref`` on the host), the device the
    mode (the current card for ``cuda``, the host otherwise)."""
    if device is None:
        device = "cuda" if mode == "cuda" else "cpu"
    if mode is None:
        mode = "cuda" if torch.device(device).type == "cuda" else "ref"
    if mode not in MODES:
        raise ValueError(f"unknown kernel mode {mode!r} (cuda or ref)")
    return mode, device


def cache_key(kernel: str, shape, dtype, device=None,
              mode: Optional[str] = None) -> str:
    """Stable string key for one (kernel, problem, device, mode) point."""
    if device is not None and not isinstance(device, torch.device):
        device = torch.device(device)
    return _key(kernel, tuple(shape), dtype, device, mode)


@functools.lru_cache(maxsize=4096)
def _key(kernel: str, shape: tuple, dtype, device, mode) -> str:
    # memoized: every op call looks its key up (a serve step ~150 times)
    mode, device = _mode_device(mode, device)
    shape_s = "x".join(str(int(s)) for s in shape)
    dtype_s = str(dtype).removeprefix("torch.")
    return (f"{KEY_PREFIX}{kernel}|{shape_s}|{dtype_s}|"
            f"{device_kind(device)}|{mode}")


def config_key(config: StridingConfig) -> str:
    """Stable identity of one config point for the quarantine store.

    ``lookahead``/``arrangement`` are folded in only when non-default so
    the common (D, P, block_rows) points stay short and greppable."""
    key = (f"{config.stride_unroll}|{config.portion_unroll}"
           f"|{config.block_rows}")
    if config.lookahead != 2 or config.arrangement != "grouped":
        key += f"|{config.lookahead}|{config.arrangement}"
    return key


def provenance(sources=(), **extra) -> dict:
    """What an entry was measured under: the torch and CUDA versions and
    the hash of every kernel source in ``sources`` (stems of
    ``csrc/*.cu``), plus ``extra`` (timestamp, device, timing knobs)."""
    prov = {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda}
    if sources:
        from repro_torch.kernels import cuda   # deferred: no kernel code
        prov["sources"] = {s: cuda.source_hash(s) for s in sorted(sources)}
    prov.update(extra)
    return prov


def entry_is_fresh(entry: Mapping[str, Any]) -> bool:
    """Provenance-based staleness: an entry measured under another torch
    or CUDA version, or against another version of a kernel source it
    launched, must not be trusted over a re-tune.  Entries without
    provenance (hand-written fixtures) are accepted — staleness needs
    positive evidence."""
    prov = entry.get("provenance")
    if not isinstance(prov, dict):
        return True
    if prov.get("torch_version", torch.__version__) != torch.__version__:
        return False
    if prov.get("cuda_version", torch.version.cuda) != torch.version.cuda:
        return False
    sources = prov.get("sources") or {}
    if sources:
        from repro_torch.kernels import cuda   # deferred: no kernel code
        for stem, tag in sources.items():
            try:
                if cuda.source_hash(stem) != tag:
                    return False
            except OSError:                    # the source is gone
                return False
    return True


def _entry_config(entry: Mapping[str, Any]) -> StridingConfig:
    return StridingConfig(
        stride_unroll=int(entry["d"]),
        portion_unroll=int(entry["p"]),
        lookahead=int(entry.get("lookahead", 2)),
        arrangement=entry.get("arrangement", "grouped"),
        block_rows=int(entry.get("block_rows", 0)))


class TuneCache:
    """JSON-backed measured-config store (thread-safe, lazily loaded,
    self-healing — see the module doc)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_path()
        self._lock = threading.Lock()
        self._data: Optional[dict[str, dict[str, Any]]] = None
        self._mtime: float = -1.0
        self._version = 0
        self._checked = -RECHECK_S

    # ------------------------------------------------------------ load/save
    def _quarantine_file(self) -> None:
        """Move the unparseable file aside (``<path>.corrupt``) so the
        rebuild never destroys the evidence of what tore it."""
        sidecar = self.path + ".corrupt"
        try:
            os.replace(self.path, sidecar)
        except OSError:
            sidecar = None
        obs.counter("tunecache.corrupt_quarantined")
        obs.event("tunecache.corrupt", path=self.path, sidecar=sidecar)

    def _load(self) -> dict[str, dict[str, Any]]:
        from repro_torch.runtime import faults
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            if self._data is None or self._mtime != -1.0:
                self._data = {"entries": {}, "quarantine": {}}
                self._mtime = -1.0
                self._version = next(_VERSIONS)
            return self._data
        if self._data is None or mtime != self._mtime:
            try:
                with open(self.path) as f:
                    raw = f.read()
                if faults.should_fire("cache_corrupt", self.path):
                    raw = raw[: len(raw) // 2]     # simulate a torn write
                parsed = json.loads(raw)
                if not isinstance(parsed, dict):
                    raise json.JSONDecodeError("top-level object", raw, 0)
            except OSError:
                parsed = {}
            except json.JSONDecodeError:
                # torn or corrupted file: move it aside, rebuild empty
                self._quarantine_file()
                parsed = {}
            if "schema" in parsed:
                self._data = {
                    "entries": dict(parsed.get("entries", {})),
                    "quarantine": dict(parsed.get("quarantine", {})),
                }
            else:
                # schema 1: a flat {key: entry} map, no quarantine
                self._data = {"entries": parsed, "quarantine": {}}
            self._mtime = mtime
            self._version = next(_VERSIONS)
        return self._data

    def _save(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        payload = {"schema": SCHEMA_VERSION,
                   "entries": self._data["entries"],
                   "quarantine": self._data["quarantine"]}
        # the tmp is fully written and fsync'd before the rename makes it
        # visible, so no reader sees a torn file
        fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._version = next(_VERSIONS)
        try:
            self._mtime = os.path.getmtime(self.path)
        except OSError:
            self._mtime = -1.0

    def version(self) -> int:
        """A number that changes whenever the entries this cache serves
        may have: on every store or quarantine through it, and when the
        file changed, which this looks at (one ``stat``) at most every
        ``RECHECK_S`` seconds.  What ``resolve_config`` keys its per-call
        memo on."""
        now = time.monotonic()
        if self._data is None or now - self._checked >= RECHECK_S:
            with self._lock:
                self._load()
            self._checked = now
        return self._version

    # ------------------------------------------------------------- access
    def lookup(self, key: str) -> Optional[dict[str, Any]]:
        with self._lock:
            return self._load()["entries"].get(key)

    def store(self, key: str, entry: dict[str, Any]) -> None:
        with self._lock:
            data = self._load()
            data["entries"][key] = entry
            self._save()

    def entries(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return dict(self._load()["entries"])

    # --------------------------------------------------------- quarantine
    def quarantine(self, key: str, config: StridingConfig,
                   reason: str) -> None:
        """Record a config that failed under this key so it is never
        resolved again (by ``config_for`` or the autotune sweep)."""
        ck = config_key(config)
        with self._lock:
            data = self._load()
            q = data["quarantine"].setdefault(key, {})
            rec = q.get(ck)
            if rec is None:
                q[ck] = {"reason": reason, "count": 1,
                         "d": config.stride_unroll,
                         "p": config.portion_unroll,
                         "block_rows": config.block_rows}
            else:
                rec["count"] = int(rec.get("count", 0)) + 1
                rec["reason"] = reason
            self._save()
        obs.event("tunecache.quarantine", key=key, config=ck,
                  reason=reason)

    def is_quarantined(self, key: str, config: StridingConfig,
                       reload: bool = True) -> bool:
        """Whether ``config`` is quarantined under ``key``; with
        ``reload=False`` against the file as last read (a caller that
        has just looked an entry up saves a second ``stat``)."""
        with self._lock:
            data = self._load() if reload or self._data is None \
                else self._data
            q = data["quarantine"].get(key)
        return bool(q) and config_key(config) in q

    def quarantined(self, key: str) -> dict[str, dict[str, Any]]:
        """{config_key: record} for one cache key (empty when clean)."""
        with self._lock:
            return dict(self._load()["quarantine"].get(key, {}))

    # ------------------------------------------------------------ resolve
    def config_for(self, kernel: str, shape, dtype,
                   mode: Optional[str] = None,
                   device=None) -> Optional[StridingConfig]:
        """Tuned StridingConfig for a problem, or None on a miss.

        The entry of the lookup's own mode is tried first; a ``ref``
        lookup on a card then falls back to that card's ``cuda`` entry
        (never the reverse: see the module doc).  An entry is skipped
        when it is stale (:func:`entry_is_fresh`) or its config is
        quarantined under the lookup's key.

        Telemetry: ``tunecache.hit`` (the mode's own entry),
        ``tunecache.sibling_fallback`` (the card's ``cuda`` entry served
        a ``ref`` lookup), ``tunecache.stale_rejected`` /
        ``tunecache.quarantined_skip`` (an entry present but unusable)
        or ``tunecache.miss``."""
        mode, device = _mode_device(mode, device)
        qkey = cache_key(kernel, shape, dtype, device, mode)
        tried = [mode]
        if mode == "ref" and torch.device(device).type == "cuda":
            tried.append("cuda")     # the card's own measurement
        for m in tried:
            key = qkey if m == mode else cache_key(kernel, shape, dtype,
                                                   device, m)
            entry = self.lookup(key)
            if entry is None:
                continue
            if not entry_is_fresh(entry):
                obs.counter("tunecache.stale_rejected", kernel=kernel,
                            mode=m)
                continue
            cfg = _entry_config(entry)
            # quarantine is checked under the mode the caller will run
            if self.is_quarantined(qkey, cfg, reload=False):
                obs.counter("tunecache.quarantined_skip", kernel=kernel,
                            mode=m)
                continue
            if obs.enabled():
                if m == mode:
                    obs.counter("tunecache.hit", kernel=kernel, mode=m)
                else:
                    obs.counter("tunecache.sibling_fallback",
                                kernel=kernel, mode=mode, served_by=m)
            return cfg
        obs.counter("tunecache.miss", kernel=kernel, mode=mode)
        return None


_default: Optional[TuneCache] = None
_default_lock = threading.Lock()


def default_cache() -> TuneCache:
    """Process-wide cache bound to the current $REPRO_TORCH_TUNE_CACHE
    path."""
    global _default
    cache = _default
    if cache is not None and cache.path == os.environ.get(_ENV):
        return cache          # the per-call path: no lock, no path built
    with _default_lock:
        path = default_path()
        if _default is None or _default.path != path:
            _default = TuneCache(path)
        return _default


def reset_default_cache() -> None:
    """Drop the memoized default cache (tests repoint
    $REPRO_TORCH_TUNE_CACHE)."""
    global _default
    with _default_lock:
        _default = None


def cached_config(kernel: str, shape, dtype, mode: Optional[str] = None,
                  device=None) -> Optional[StridingConfig]:
    """Measured-best config from the default cache, or None."""
    return default_cache().config_for(kernel, shape, dtype, mode=mode,
                                      device=device)
