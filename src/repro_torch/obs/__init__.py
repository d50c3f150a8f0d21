"""repro_torch.obs — structured telemetry for the port (the JAX
package's ``repro.obs``).

Counters, point events and timed spans with key/value attributes,
routed to an installed collector (in-memory for tests, a JSONL file for
runs); a no-op when disabled.  Select a sink with ``REPRO_TORCH_OBS``
(``memory`` / ``jsonl:PATH`` / a bare path; unset = off), read once when
this package is first imported, or install one programmatically.  The
names the port emits are in the README's port observability table, and
``tools/torch_speclint.py --repo-lint`` checks that every name emitted
under ``src/repro_torch/`` is there.
"""
from repro_torch.obs.core import (Event, MemoryCollector, active_collector,
                                  collect, counter, enabled, event, install,
                                  span, uninstall)
from repro_torch.obs.sinks import JsonlSink, configure_from_env, read_jsonl

__all__ = [
    "Event", "MemoryCollector", "JsonlSink",
    "enabled", "active_collector", "event", "counter", "span",
    "install", "uninstall", "collect", "configure_from_env", "read_jsonl",
]

# honour $REPRO_TORCH_OBS once, at import: unset costs one env read
configure_from_env()
