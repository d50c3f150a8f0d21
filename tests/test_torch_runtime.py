"""The port's ``RestartPolicy`` against the JAX package's: the three cases
of ``tests/test_runtime.py``, each decision of both policies taken on the
same clock, monitor and heartbeats."""
import pytest

from repro.runtime import fault_tolerance as jft
from repro_torch import runtime
from repro_torch.runtime import fault_tolerance as tft


def _both(**kw):
    return jft.RestartPolicy(**kw), tft.RestartPolicy(**kw)


def test_restart_policy_is_exported():
    assert runtime.RestartPolicy is tft.RestartPolicy
    assert tft.RestartPolicy() == tft.RestartPolicy(
        max_failures_per_hour=6, evict_stragglers=True)


@pytest.mark.parametrize("limit", [0, 1, 2, 6])
def test_restart_policy_halts_after_crash_loop_as_jax(limit):
    jpol, tpol = _both(max_failures_per_hour=limit)
    for now in (0.0, 1.0, 2.0, 3599.0, 3601.5, 4000.0, 7300.0, 7301.0):
        want = jpol.on_failure(now=now)
        assert tpol.on_failure(now=now) == want, now
    if limit == 2:      # the JAX test's decisions
        jpol, tpol = _both(max_failures_per_hour=2)
        got = [tpol.on_failure(now=t) for t in (0.0, 1.0, 2.0, 4000.0)]
        assert got == ["restore_and_remesh"] * 2 + ["halt",
                                                    "restore_and_remesh"]


def _monitors(slow: str, ok: str):
    mons = jft.StepMonitor(window=4), tft.StepMonitor(window=4)
    for mon in mons:
        for _ in range(4):
            mon.record(slow, 9.0)
            mon.record(ok, 1.0)
    return mons


def test_restart_policy_plan_combines_dead_and_stragglers_as_jax():
    now = [0.0]
    hbs = (jft.HeartbeatRegistry(timeout_s=1.0, clock=lambda: now[0]),
           tft.HeartbeatRegistry(timeout_s=1.0, clock=lambda: now[0]))
    for hb in hbs:
        hb.beat("dead_host")
    now[0] = 5.0
    for hb in hbs:
        hb.beat("slow_host")
    jmon, tmon = _monitors("slow_host", "ok_host")
    jpol, tpol = _both()
    want = jpol.plan(jmon, hbs[0], now=5.0)
    got = tpol.plan(tmon, hbs[1], now=5.0)
    assert got == want
    assert got == {"action": "restore_and_remesh",
                   "evict": ["dead_host", "slow_host"],
                   "dead": ["dead_host"], "stragglers": ["slow_host"]}


@pytest.mark.parametrize("evict", [True, False])
def test_restart_policy_straggler_only_evicts_at_checkpoint_as_jax(evict):
    hbs = (jft.HeartbeatRegistry(timeout_s=100.0, clock=lambda: 0.0),
           tft.HeartbeatRegistry(timeout_s=100.0, clock=lambda: 0.0))
    for hb in hbs:
        hb.beat("slow")
        hb.beat("ok")
    jmon, tmon = _monitors("slow", "ok")
    jpol, tpol = _both(evict_stragglers=evict)
    got = tpol.plan(tmon, hbs[1], now=0.0)
    assert got == jpol.plan(jmon, hbs[0], now=0.0)
    if evict:
        assert got["action"] == "evict_at_checkpoint"
        assert got["evict"] == ["slow"]
    else:
        assert got["action"] == "none" and got["evict"] == []
