"""File sinks and ``REPRO_TORCH_OBS`` environment wiring for
repro_torch.obs (the JAX package's ``repro.obs.sinks``, under the
port's own variable).

``REPRO_TORCH_OBS`` selects where telemetry flows (read once, when
``repro_torch.obs`` is first imported; re-run
:func:`configure_from_env` after changing it in-process):

  * unset / ``""`` / ``"0"`` / ``"off"``  — disabled (no-op fast path);
  * ``"memory"``                          — process-wide
    :class:`~repro_torch.obs.core.MemoryCollector`, reachable via
    ``obs.active_collector()``;
  * ``"jsonl:PATH"`` or any other value   — :class:`JsonlSink` writing
    one JSON object per record to ``PATH`` (the bare value is the path).

JSONL lines are ``Event.to_dict()`` payloads::

    {"kind": "event", "name": "kernel.resolve", "value": 1.0,
     "ts": 1754650000.123, "attrs": {"kernel": "mxv", "source": "tuned"}}
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

from repro_torch.obs import core

__all__ = ["JsonlSink", "configure_from_env", "read_jsonl"]

_ENV = "REPRO_TORCH_OBS"
_OFF = ("", "0", "off", "none", "disabled")


class JsonlSink:
    """Append-only JSON-lines collector (thread-safe, line-buffered).

    A failed write (an ``OSError``, or the ``sink_io`` fault site armed
    through ``runtime.faults``) drops that record and counts it in
    ``dropped``: telemetry never takes the workload down."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1)
        self.dropped = 0

    def record(self, ev: core.Event) -> None:
        line = json.dumps(ev.to_dict(), default=str)
        from repro_torch.runtime import faults
        try:
            if faults.enabled():
                # probed outside the sink lock: the fired rule's audit
                # event re-enters record() on this same sink
                faults.fire_if("sink_io", self.path)
            with self._lock:
                self._f.write(line + "\n")
        except (OSError, faults.InjectedFault):
            # a failing sink cannot report its own failure through
            # itself: count the lost record in the object
            with self._lock:
                self.dropped += 1

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def read_jsonl(path: str, strict: bool = False) -> list[dict]:
    """Parse a JSONL telemetry file back into record dicts.

    A process killed mid-write leaves a truncated final line; by default
    malformed lines are skipped (counted in ``read_jsonl.skipped``, a
    function attribute reset per call) so a torn file is still
    readable.  ``strict=True`` raises on a bad line instead."""
    out = []
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if strict:
                    raise
                skipped += 1
    read_jsonl.skipped = skipped
    return out


read_jsonl.skipped = 0


def configure_from_env(env: Optional[str] = None) -> None:
    """(Re)install the collector ``REPRO_TORCH_OBS`` (or ``env``) names;
    see the module doc."""
    val = os.environ.get(_ENV, "") if env is None else env
    val = val.strip()
    if val.lower() in _OFF:
        core.uninstall()
        return
    if val.lower() == "memory":
        core.install(core.MemoryCollector())
        return
    path = val[len("jsonl:"):] if val.startswith("jsonl:") else val
    core.install(JsonlSink(path))
