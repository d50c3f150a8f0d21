"""The port's serving engine: bounded admission queue and shed policies,
per-request deadlines, slow-step/straggler detection and heartbeats,
batched ragged stepping — the behaviours the JAX package's
``tests/test_serve_robustness.py`` and ``tests/test_serve_batched.py``
pin, on a deterministic toy model."""
import json
import time

import pytest
import torch
from torch import nn

from repro_torch import obs
from repro_torch.runtime import faults
from repro_torch.serve import ServeConfig, ServingEngine


class _ToyModel:
    """Deterministic next-token = (token + 1) mod vocab; counts steps."""

    vocab = 7

    def __init__(self):
        self.steps = 0

    def init_cache(self, slots, max_len, device=None):
        return torch.zeros(slots, max_len, device=device)

    def decode_step(self, params, toks, cache, pos, **sharded):
        self.steps += 1
        self.sharded = sharded
        return nn.functional.one_hot((toks[:, 0].long() + 1) % self.vocab,
                                     self.vocab).float(), cache


def _engine(**kw):
    return ServingEngine(_ToyModel(), nn.Linear(1, 1), ServeConfig(**kw))


def test_sharded_serving_gives_the_unsharded_tokens():
    """shards=2 with no ctx (the static split) serves the shards=1 tokens,
    passing ctx and shards to decode_step only when sharded."""
    one = _engine(slots=2, max_new_tokens=3)
    two = _engine(slots=2, max_new_tokens=3, shards=2)
    for eng in (one, two):
        eng.submit(1, [1])
        eng.submit(2, [2, 3])
    assert two.run() == one.run() == {1: [2, 3, 4], 2: [4, 5, 6]}
    assert one.model.sharded == {}
    assert two.model.sharded == {"ctx": None, "shards": 2}


def test_sharded_serving_refuses_a_group_of_the_wrong_size(tmp_path,
                                                           monkeypatch):
    """A process group whose world size is not ``shards`` raises: it would
    serve another split."""
    import torch.distributed as dist
    from repro_torch.serve import serving_ctx
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")     # loopback only
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        with pytest.raises(ValueError, match="2 ranks, not 1"):
            serving_ctx(2)
        assert serving_ctx(1) is None
    finally:
        dist.destroy_process_group()


def test_one_decode_step_and_event_per_round():
    eng = _engine(slots=2, max_new_tokens=3)
    with obs.collect() as col:
        eng.submit(1, [1])
        eng.submit(2, [2])
        results = eng.run()
    assert results == {1: [2, 3, 4], 2: [3, 4, 5]}
    steps = col.named("serve.step")
    assert eng.model.steps == len(steps) == 3
    assert [e.attrs["slots"] for e in steps] == [[0, 1]] * 3


def test_ragged_prompts_prefill_one_token_per_step():
    eng = _engine(slots=2, max_new_tokens=2)
    eng.submit(1, [1, 2, 3])
    eng.submit(2, [4])
    results = eng.run()
    assert results == {1: [4, 5], 2: [5, 6]}
    stats = eng.stats()
    assert stats["prefill_steps"] == 2 and stats["decode_steps"] == 2
    assert stats["tokens_generated"] == 4


def test_bounded_queue_rejects_overflow():
    eng = _engine(slots=1, max_new_tokens=2, max_queue=2)
    with obs.collect() as col:
        assert eng.submit(1, [1]) is True
        assert eng.submit(2, [2]) is True
        assert eng.submit(3, [3]) is False       # queue full: shed
        results = eng.run()
    assert sorted(results) == [1, 2]
    assert eng.stats()["shed_requests"] == 1
    shed = col.named("serve.shed")
    assert len(shed) == 1 and shed[0].attrs["uid"] == 3
    assert shed[0].attrs["policy"] == "reject"
    assert eng.stats()["requests"][3]["shed"] is True


def test_bounded_queue_drop_oldest_favours_freshness():
    eng = _engine(slots=1, max_new_tokens=2, max_queue=1,
                  shed_policy="drop_oldest")
    with obs.collect() as col:
        assert eng.submit(1, [1]) is True
        assert eng.submit(2, [2]) is True        # evicts 1, admits 2
        results = eng.run()
    assert results[2] and results[1] == []       # evicted → empty result
    assert eng.stats()["shed_requests"] == 1
    assert col.named("serve.shed")[0].attrs["uid"] == 1


def test_queued_request_past_deadline_never_prefilled():
    eng = _engine(slots=1, max_new_tokens=2, deadline_s=0.01)
    with obs.collect() as col:
        eng.submit(1, [1])
        eng.submit(2, [2])
        time.sleep(0.05)                          # both deadlines lapse
        results = eng.run()
    assert results == {1: [], 2: []}
    assert eng.stats()["deadline_expired"] == 2
    assert {e.attrs["where"] for e in col.named("serve.deadline")} == {
        "queue"}


def test_in_slot_deadline_returns_partial_output():
    eng = _engine(slots=1, max_new_tokens=100_000, max_len=1_000_000,
                  deadline_s=0.25)
    with obs.collect() as col:
        eng.submit(1, [1])
        results = eng.run()
    assert 0 < len(results[1]) < 100_000          # cut off mid-generation
    evs = col.named("serve.deadline")
    assert len(evs) == 1 and evs[0].attrs["where"] == "slot"
    assert eng.stats()["requests"][1]["deadline_exceeded"]


def test_slow_step_flagged_after_warm_history():
    eng = _engine(slots=1, max_new_tokens=4, slow_step_factor=3.0)
    eng.submit(1, [1])
    eng.run()                                     # warm rolling median
    with obs.collect() as col:
        with faults.inject("serve_slow:slot0:1"):
            eng.submit(2, [2])
            eng.run()                             # first step stalls 50ms
    slow = col.named("serve.slow_step")
    assert slow and slow[0].attrs["slot"] == 0
    assert slow[0].attrs["latency_s"] > 3.0 * slow[0].attrs["median_s"]
    assert eng.stats()["slow_steps"] >= 1
    assert col.named("fault.injected")


def test_straggler_slot_surfaces_in_stats():
    eng = _engine(slots=2, max_new_tokens=8)
    eng.submit(1, [1])
    eng.submit(2, [2])
    with faults.inject("serve_slow:slot1"):      # every slot1 step stalls
        eng.run()
    stats = eng.stats()
    assert stats["straggler_slots"] == ["slot1"]
    assert stats["heartbeat_alive"] is True
    json.dumps(stats)                             # stays json-clean


def test_obs_records_only_inside_a_collector():
    obs.counter("k.calls")                        # disabled: dropped
    with obs.collect() as col:
        assert obs.enabled()
        obs.counter("k.calls")
        obs.counter("k.calls", 2.0)
        obs.event("k.done", n=3)
    assert not obs.enabled()
    assert col.counters() == {"k.calls": 3.0}
    assert [e.attrs for e in col.named("k.done")] == [{"n": 3}]


@pytest.mark.parametrize("spec,ok", [("serve_slow:slot1:2", True),
                                     ("a:b:c:d", False), (":x", False),
                                     ("serve_slow::0", False)])
def test_fault_plan_parsing(spec, ok):
    if ok:
        plan = faults.parse_plan(spec)
        assert plan.should_fire("serve_slow", "slot1")
        assert plan.should_fire("serve_slow", "slot1")
        assert not plan.should_fire("serve_slow", "slot1")   # count cap
    else:
        with pytest.raises(ValueError):
            faults.parse_plan(spec)


def test_fault_plan_is_armed_only_by_inject(monkeypatch):
    # the JAX package's chaos variable must not reach the port's engine
    monkeypatch.setenv("REPRO_FAULTS", "serve_slow")
    assert not faults.should_fire("serve_slow", "slot0")
    assert faults.sleep_if("serve_slow", "slot0") == 0.0
    with faults.inject("serve_slow:slot0:1"):
        assert faults.should_fire("serve_slow", "slot0")
        assert not faults.should_fire("serve_slow", "slot0")
    assert not faults.should_fire("serve_slow", "slot0")
