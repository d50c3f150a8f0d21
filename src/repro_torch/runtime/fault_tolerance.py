"""Fault tolerance: straggler detection, heartbeats and the restart
policy.

Stragglers (a slow step, a throttled card) are detected from the
step-time distribution; liveness from heartbeat timestamps.  The serving
engine records per-slot step times and beats once per step.
``RestartPolicy`` turns both into a recovery action.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional


class StepMonitor:
    """Tracks per-host step durations; flags stragglers.

    A host is a straggler when its rolling median exceeds
    ``threshold`` × the cross-host median over the same window.
    """

    def __init__(self, window: int = 50, threshold: float = 1.5):
        self.window = window
        self.threshold = threshold
        self._t: dict[str, deque] = {}

    def record(self, host: str, seconds: float) -> None:
        self._t.setdefault(host, deque(maxlen=self.window)).append(seconds)

    @staticmethod
    def _median(xs) -> float:
        """True median: even windows average the two middle samples
        (``s[len // 2]`` alone takes the upper one — the same systematic
        upward bias autotune's ``_measure`` had, which inflates every
        host's rolling median and masks real stragglers near the
        threshold)."""
        s = sorted(xs)
        n = len(s)
        if not n:
            return 0.0
        mid = n // 2
        if n % 2:
            return s[mid]
        return 0.5 * (s[mid - 1] + s[mid])

    def medians(self) -> dict[str, float]:
        return {h: self._median(d) for h, d in self._t.items()}

    def global_median(self) -> float:
        return self._median([m for m in self.medians().values()])

    def stragglers(self) -> list[str]:
        g = self.global_median()
        if g <= 0:
            return []
        return [h for h, m in self.medians().items()
                if m > self.threshold * g]


class HeartbeatRegistry:
    """Host liveness via heartbeat timestamps (coordinator side)."""

    def __init__(self, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self._last: dict[str, float] = {}

    def beat(self, host: str) -> None:
        self._last[host] = self.clock()

    def alive(self) -> list[str]:
        now = self.clock()
        return [h for h, t in self._last.items() if now - t <= self.timeout]

    def dead(self) -> list[str]:
        now = self.clock()
        return [h for h, t in self._last.items() if now - t > self.timeout]


@dataclasses.dataclass
class RestartPolicy:
    """Decides the recovery action after failures.

    evict_stragglers: drop flagged hosts at the next checkpoint boundary
    (cheaper than mid-step); max_failures_per_hour bounds crash-looping —
    beyond it, halt for operator attention instead of thrashing the
    cluster.
    """
    max_failures_per_hour: int = 6
    evict_stragglers: bool = True
    _failures: list = dataclasses.field(default_factory=list)

    def on_failure(self, now: Optional[float] = None) -> str:
        now = time.monotonic() if now is None else now
        self._failures = [t for t in self._failures if now - t < 3600]
        self._failures.append(now)
        if len(self._failures) > self.max_failures_per_hour:
            return "halt"
        return "restore_and_remesh"

    def plan(self, monitor: StepMonitor, heartbeats: HeartbeatRegistry,
             now: Optional[float] = None) -> dict:
        dead = heartbeats.dead()
        stragglers = monitor.stragglers() if self.evict_stragglers else []
        evict = sorted(set(dead) | set(stragglers))
        action = "none"
        if dead:
            action = self.on_failure(now)
        elif stragglers:
            action = "evict_at_checkpoint"
        return {"action": action, "evict": evict, "dead": dead,
                "stragglers": stragglers}
