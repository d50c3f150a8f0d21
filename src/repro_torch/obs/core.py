"""Structured-telemetry core: events, counters, spans and collectors.

Three record kinds flow through one ``Event`` type, as in the JAX
package's ``repro.obs.core``:

  * ``event``   — a point-in-time fact with key/value attributes
                  (e.g. one serving step, one config resolution);
  * ``counter`` — a named increment;
  * ``span``    — a timed region; its duration in seconds is the
                  record's ``value``, stamped when the region exits.

Emission is routed to the installed *collector*.  When none is
installed (the default) every emit function returns after a single
``is None`` check, so instrumented hot paths (per-token decode, op
dispatch) pay no measurable cost.  Two collectors ship:
:class:`MemoryCollector` (tests, programmatic inspection; :func:`collect`
installs one for the scope of a ``with`` block) and the JSONL file sink
in :mod:`repro_torch.obs.sinks`.

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

__all__ = [
    "Event", "MemoryCollector", "enabled", "active_collector",
    "event", "counter", "span", "install", "uninstall", "collect",
]


@dataclasses.dataclass(frozen=True)
class Event:
    """One telemetry record (point event, counter increment, or span)."""

    kind: str                      # "event" | "counter" | "span"
    name: str                      # dotted event name, e.g. "serve.step"
    attrs: dict[str, Any]
    value: float = 1.0             # counter increment / span duration_s
    ts: float = 0.0                # wall-clock seconds (time.time)

    def to_dict(self) -> dict[str, Any]:
        return {"kind": self.kind, "name": self.name, "value": self.value,
                "ts": self.ts, "attrs": dict(self.attrs)}


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

    def counter_value(self, name: str) -> float:
        return self.counters().get(name, 0.0)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()

    def close(self) -> None:   # collector protocol (sinks flush files)
        pass


# The installed collector.  ``None`` means disabled: the emit functions
# below return immediately, which is the near-zero-overhead contract the
# hot paths (resolve_config, per-token decode) rely on.
_collector: Optional[Any] = None
_install_lock = threading.Lock()


def enabled() -> bool:
    """True when a collector is installed (telemetry flows somewhere)."""
    return _collector is not None


def active_collector() -> Optional[Any]:
    """The installed collector, or None when telemetry is disabled."""
    return _collector


def install(collector: Any) -> None:
    """Install a collector (anything with ``record(Event)``), closing the
    one it replaces."""
    global _collector
    with _install_lock:
        prev = _collector
        _collector = collector
        if prev is not None and prev is not collector:
            close = getattr(prev, "close", None)
            if close:
                close()


def uninstall() -> None:
    """Remove (and close) the installed collector; emission becomes a
    no-op again."""
    global _collector
    with _install_lock:
        prev, _collector = _collector, None
        if prev is not None:
            close = getattr(prev, "close", None)
            if close:
                close()


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


class _Span:
    """Mutable attribute bag yielded by :func:`span`."""

    __slots__ = ("attrs",)

    def __init__(self, attrs: dict[str, Any]):
        self.attrs = attrs

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)


class _NullSpan:
    """Disabled-mode span: ``set`` swallows everything."""

    __slots__ = ()

    def set(self, **attrs: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[Any]:
    """Timed region: records a ``span`` event whose value is its duration
    in seconds (``time.perf_counter``) on exit.  The ``yield``ed object
    takes ``.set(key=value)`` to attach results found inside the region.
    No-op when disabled."""
    c = _collector
    if c is None:
        yield _NULL_SPAN
        return
    sp = _Span(dict(attrs))
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        dur = time.perf_counter() - t0
        # re-read: the collector may have been swapped inside the region
        cc = _collector
        if cc is not None:
            cc.record(Event("span", name, sp.attrs, dur, time.time()))
