"""Structured telemetry (events and counters) — see ``obs.core``."""
from repro_torch.obs.core import (Event, MemoryCollector, collect, counter,
                                  enabled, event)

__all__ = ["Event", "MemoryCollector", "enabled", "event", "counter",
           "collect"]
