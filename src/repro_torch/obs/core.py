"""Structured-telemetry core: events, counters and the scoped collector.

Two record kinds flow through one ``Event`` type:

  * ``event``   — a point-in-time fact with key/value attributes
                  (e.g. one serving step, one config resolution);
  * ``counter`` — a named increment.

Emission is routed to the installed *collector*.  When none is
installed (the default) every emit function returns after a single
``is None`` check, so instrumented hot paths (per-token decode) pay no
measurable cost.  :func:`collect` installs a :class:`MemoryCollector`
for the scope of a ``with`` block (tests, programmatic inspection).

This module imports nothing from the rest of ``repro_torch`` so any layer
(kernels, serve) can instrument without an
import cycle.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Iterator, Optional

__all__ = ["Event", "MemoryCollector", "enabled", "event", "counter",
           "collect"]


@dataclasses.dataclass(frozen=True)
class Event:
    """One telemetry record (point event or counter increment)."""

    kind: str                      # "event" | "counter"
    name: str                      # dotted event name, e.g. "serve.step"
    attrs: dict[str, Any]
    value: float = 1.0             # counter increment
    ts: float = 0.0                # wall-clock seconds (time.time)


class MemoryCollector:
    """In-memory event store for tests and programmatic inspection."""

    def __init__(self) -> None:
        self.events: list[Event] = []
        self._lock = threading.Lock()

    def record(self, ev: Event) -> None:
        with self._lock:
            self.events.append(ev)

    # ------------------------------------------------------------ queries
    def named(self, name: str) -> list[Event]:
        """All records with an exact dotted name, oldest first."""
        return [e for e in self.events if e.name == name]

    def counters(self) -> dict[str, float]:
        """{counter name: summed increments} over everything recorded."""
        out: dict[str, float] = {}
        for e in self.events:
            if e.kind == "counter":
                out[e.name] = out.get(e.name, 0.0) + e.value
        return out


# The installed collector.  ``None`` means disabled: the emit functions
# below return immediately, which is the near-zero-overhead contract the
# hot paths (resolve_config, per-token decode) rely on.
_collector: Optional[Any] = None
_install_lock = threading.Lock()


def enabled() -> bool:
    """True when a collector is installed (telemetry flows somewhere)."""
    return _collector is not None


@contextlib.contextmanager
def collect() -> Iterator[MemoryCollector]:
    """Scoped MemoryCollector: install on entry, restore prior on exit.

    The test-suite idiom::

        with obs.collect() as col:
            engine.run()
        assert col.named("serve.step")
    """
    global _collector
    with _install_lock:
        prev = _collector
        col = MemoryCollector()
        _collector = col
    try:
        yield col
    finally:
        with _install_lock:
            _collector = prev


# ------------------------------------------------------------- emission

def event(name: str, **attrs: Any) -> None:
    """Record a point event; no-op (one None check) when disabled."""
    c = _collector
    if c is None:
        return
    c.record(Event("event", name, attrs, 1.0, time.time()))


def counter(name: str, value: float = 1.0, **attrs: Any) -> None:
    """Record a counter increment; no-op when disabled."""
    c = _collector
    if c is None:
        return
    c.record(Event("counter", name, attrs, value, time.time()))
