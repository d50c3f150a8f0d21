"""Deterministic fault injection (the serving engine's slow-step site).

A guarded code path rots unless its fault can be *forced*.  A site asks
``should_fire(site, target)`` and, when a rule is armed, behaves as the
real fault would; here the one wired site is ``serve_slow`` in
``serve.engine``: one engine step sleeps past the slow-step threshold
(``sleep_if``).  Nothing runs unless a plan is armed: the disarmed fast
path is one module-global ``is None`` check.

Arming is programmatic only: ``with inject("serve_slow:slot0:1"):``
arms a plan of ``site[:target][:count]`` rules for the scope of the
block.  ``target`` filters by the caller-supplied target string
(substring match, empty = any); ``count`` caps how many times the rule
fires (default: unlimited).

Every fired rule emits a ``fault.injected`` obs event (site, target,
fire index).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Iterator, Optional

from repro_torch import obs

__all__ = ["FaultRule", "FaultPlan", "parse_plan", "inject",
           "should_fire", "sleep_if"]


@dataclasses.dataclass
class FaultRule:
    """One armed fault: a site, an optional target filter, a fire cap."""

    site: str
    target: str = ""            # substring of the caller's target; "" = any
    count: Optional[int] = None  # max fires; None = unlimited
    fired: int = 0

    def matches(self, site: str, target: str) -> bool:
        if site != self.site:
            return False
        if self.target and self.target not in target:
            return False
        return self.count is None or self.fired < self.count


# Reentrancy guard: emitting the fault.injected audit event routes
# through the installed collector, which may itself probe should_fire
# again.  Without the guard that re-entry deadlocks on the plan lock.
_emitting = threading.local()


class FaultPlan:
    """A set of armed rules (thread-safe fire accounting)."""

    def __init__(self, rules: list[FaultRule]):
        self.rules = rules
        self._lock = threading.Lock()

    def should_fire(self, site: str, target: str = "") -> bool:
        if getattr(_emitting, "on", False):
            return False
        with self._lock:
            for rule in self.rules:
                if rule.matches(site, target):
                    rule.fired += 1
                    _emitting.on = True
                    try:
                        obs.event("fault.injected", site=site,
                                  target=target, n=rule.fired)
                    finally:
                        _emitting.on = False
                    return True
        return False


def parse_plan(spec: str) -> FaultPlan:
    """Parse a ``site[:target][:count],...`` spec string into a plan.

    Malformed segments raise ``ValueError`` loudly — a run whose fault
    silently failed to arm would green-light untested paths.
    """
    rules = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if len(bits) > 3:
            raise ValueError(f"bad fault rule {part!r} "
                             "(site[:target][:count])")
        site, target = bits[0], (bits[1] if len(bits) > 1 else "")
        count = None
        if len(bits) == 3:
            try:
                count = int(bits[2])
            except ValueError:
                raise ValueError(
                    f"bad fault count in rule {part!r}") from None
            if count < 1:
                raise ValueError(f"bad fault count in rule {part!r}")
        if not site:
            raise ValueError(f"bad fault rule {part!r} (empty site)")
        rules.append(FaultRule(site=site, target=target, count=count))
    return FaultPlan(rules)


# The armed plan.  ``None`` = disarmed (the default): every injection
# point is a single None check.
_plan: Optional[FaultPlan] = None
_lock = threading.Lock()


@contextlib.contextmanager
def inject(spec: str) -> Iterator[FaultPlan]:
    """Scoped fault plan: arm on entry, restore the prior state on exit.

    The test idiom::

        with faults.inject("serve_slow:slot0:1"):
            engine.run()                   # slot 0's first step stalls
    """
    global _plan
    plan = parse_plan(spec)
    with _lock:
        prev, _plan = _plan, plan
    try:
        yield plan
    finally:
        with _lock:
            _plan = prev


# --------------------------------------------------------------- probes

def should_fire(site: str, target: str = "") -> bool:
    """True when an armed rule matches (and consumes one fire)."""
    plan = _plan
    if plan is None:
        return False
    return plan.should_fire(site, target)


def sleep_if(site: str, target: str = "", seconds: float = 0.05) -> float:
    """Sleep ``seconds`` when an armed rule matches; returns the delay
    actually added (0.0 when disarmed) so callers can fold it into
    their own timing if they need to."""
    if should_fire(site, target):
        time.sleep(seconds)
        return seconds
    return 0.0
