"""The port's config resolution on the CPU: the tune cache
(``repro_torch.registry.tunecache``), the autotuner on the plain versions
(``repro_torch.registry.autotune``; the counterparts of
``tests/test_registry_autotune.py``), the resolve chain explicit > tuned >
planned > default (``kernels.common.resolve_config``), and every op
wrapper's Traffic and planned config held against its JAX counterpart's
on the same inputs."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import registry as jregistry
from repro.core import planner as jplanner
from repro.kernels import common as jcommon
from repro.registry import tunecache as jtunecache
from repro_torch import obs
from repro_torch import registry as tregistry
from repro_torch.core import dma_model as tdma
from repro_torch.core import layout as tlayout
from repro_torch.core import planner as tplanner
from repro_torch.core.planner import Traffic
from repro_torch.core.striding import SINGLE_STRIDED
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import cuda
from repro_torch.kernels.stream import ops as tsops
from repro_torch.registry import autotune, tunecache
from repro_torch.runtime import faults

CARD = "NVIDIA H100 80GB HBM3"
TPU_MODEL = tdma.StreamModel(
    hbm_bw=819e9, latency=2e-6, stream_bw=205e9, n_streams=16,
    descriptor_overhead=0.3e-6,
    layout=tlayout.Layout(lane=128, unit_rows={4: 8, 2: 16, 1: 32},
                          alias_bits=12))
VMEM = 8 * 1024 * 1024


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """The port's default tune cache at a fresh file, the plan memo
    empty; both reset again after the test."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(path))
    tunecache.reset_default_cache()
    tcommon.reset_plan_memo()
    yield path
    tunecache.reset_default_cache()
    tcommon.reset_plan_memo()


@pytest.fixture
def card(monkeypatch):
    """Device kinds for ``cuda:0`` without a card: the tune cache asks
    ``torch.cuda.get_device_name`` only through ``_card_name``."""
    monkeypatch.setattr(tunecache, "_card_name", lambda index: CARD)
    return torch.device("cuda:0")


def _cache(tmp_path):
    return tunecache.TuneCache(str(tmp_path / "tune.json"))


# ------------------------------------------------------------ tune cache

def test_schema_2_round_trip_and_schema_1_read(tmp_path):
    cache = _cache(tmp_path)
    key = tunecache.cache_key("mxv", (64, 64), torch.float32, "cpu")
    cache.store(key, {"d": 4, "p": 2, "block_rows": 16})
    cache.quarantine(key, TConfig(8, 1), "resource")
    payload = json.loads((tmp_path / "tune.json").read_text())
    assert payload["schema"] == tunecache.SCHEMA_VERSION == 2
    assert set(payload) == {"schema", "entries", "quarantine"}
    again = _cache(tmp_path)                # a new reader of the file
    assert again.lookup(key) == {"d": 4, "p": 2, "block_rows": 16}
    assert again.config_for("mxv", (64, 64), torch.float32, "ref",
                            "cpu") == TConfig(4, 2, block_rows=16)
    assert again.quarantined(key)["8|1|0"]["reason"] == "resource"
    # a flat schema-1 file reads as its entries, rewritten as schema 2
    (tmp_path / "old.json").write_text(json.dumps({key: {"d": 2, "p": 1}}))
    old = tunecache.TuneCache(str(tmp_path / "old.json"))
    assert old.lookup(key) == {"d": 2, "p": 1}
    old.store(key, {"d": 2, "p": 2})
    assert json.loads((tmp_path / "old.json").read_text())["schema"] == 2


@pytest.mark.parametrize("torn", ["file", "fault"])
def test_corrupt_file_is_moved_aside_and_rebuilt(tmp_path, torn):
    cache = _cache(tmp_path)
    key = tunecache.cache_key("mxv", (8, 8), torch.float32, "cpu")
    cache.store(key, {"d": 2, "p": 1})
    good = (tmp_path / "tune.json").read_text()
    fresh_cache = _cache(tmp_path)
    with obs.collect() as col:
        if torn == "file":
            (tmp_path / "tune.json").write_text(good[: len(good) // 2])
            assert fresh_cache.lookup(key) is None
        else:
            with faults.inject("cache_corrupt:tune.json:1"):
                assert fresh_cache.lookup(key) is None
    sidecar = tmp_path / "tune.json.corrupt"
    assert sidecar.exists() and not (tmp_path / "tune.json").exists()
    assert col.counters()["tunecache.corrupt_quarantined"] == 1
    fresh_cache.store(key, {"d": 4, "p": 1})        # rebuilt empty
    assert _cache(tmp_path).entries() == {key: {"d": 4, "p": 1}}


def test_writes_are_atomic(tmp_path, monkeypatch):
    cache = _cache(tmp_path)
    key = tunecache.cache_key("mxv", (8, 8), torch.float32, "cpu")
    cache.store(key, {"d": 2, "p": 1})
    before = (tmp_path / "tune.json").read_text()

    def torn_dump(obj, f, **kw):
        f.write('{"schema": 2, "entr')
        raise OSError("disk full")
    monkeypatch.setattr(tunecache.json, "dump", torn_dump)
    with pytest.raises(OSError, match="disk full"):
        cache.store(key, {"d": 8, "p": 1})
    # the reader's file is the old one, whole; no temporary is left
    assert (tmp_path / "tune.json").read_text() == before
    assert sorted(os.listdir(tmp_path)) == ["tune.json"]


def test_staleness_by_kernel_source_hash_and_versions(tmp_path):
    cache = _cache(tmp_path)
    real = cuda.source_hash("stream")
    assert len(real) == 12
    fresh = {"d": 2, "p": 1,
             "provenance": tunecache.provenance(["stream"])}
    assert fresh["provenance"]["sources"] == {"stream": real}
    assert tunecache.entry_is_fresh(fresh)
    assert tunecache.entry_is_fresh({"d": 2, "p": 1})   # no provenance
    for stale in ({"sources": {"stream": "000000000000"}},
                  {"sources": {"no_such_source": real}},
                  {"torch_version": "0.0.1"},
                  {"cuda_version": "1.0"}):
        prov = dict(fresh["provenance"], **stale)
        assert not tunecache.entry_is_fresh({"d": 2, "p": 1,
                                             "provenance": prov})
    key = tunecache.cache_key("stream_copy", (8, 128), torch.float32, "cpu")
    cache.store(key, {"d": 4, "p": 1, "provenance": dict(
        fresh["provenance"], sources={"stream": "000000000000"})})
    with obs.collect() as col:
        assert cache.config_for("stream_copy", (8, 128), torch.float32,
                                "ref", "cpu") is None
    assert col.counters()["tunecache.stale_rejected"] == 1


def test_quarantined_config_is_never_served(tmp_path):
    cache = _cache(tmp_path)
    key = tunecache.cache_key("mxv", (8, 8), torch.float32, "cpu")
    cache.store(key, {"d": 2, "p": 2})
    assert cache.config_for("mxv", (8, 8), torch.float32) == TConfig(2, 2)
    cache.quarantine(key, TConfig(2, 2), "smoke")
    cache.quarantine(key, TConfig(2, 2), "smoke")
    assert cache.is_quarantined(key, TConfig(2, 2))
    assert cache.quarantined(key)["2|2|0"]["count"] == 2
    assert cache.config_for("mxv", (8, 8), torch.float32) is None
    assert tunecache.config_key(TConfig(2, 2, lookahead=3)) == "2|2|0|3|grouped"


def test_a_ref_entry_never_serves_the_card(tmp_path, card):
    shape, dt = (64, 64), torch.float32
    ref_key = tunecache.cache_key("mxv", shape, dt, card, "ref")
    cuda_key = tunecache.cache_key("mxv", shape, dt, card, "cuda")
    assert ref_key.endswith(f"|{CARD}|ref") and cuda_key.endswith("|cuda")
    cache = _cache(tmp_path)
    cache.store(ref_key, {"d": 8, "p": 1})
    # timings of the plain version never serve the card's kernels
    assert cache.config_for("mxv", shape, dt, "cuda", card) is None
    # a ref lookup on the card takes its own entry first ...
    cache.store(cuda_key, {"d": 2, "p": 2})
    assert cache.config_for("mxv", shape, dt, "ref", card) == TConfig(8, 1)
    assert cache.config_for("mxv", shape, dt, "cuda", card) == TConfig(2, 2)
    # ... and, with none, the card's cuda entry
    cache.store(tunecache.cache_key("mxv_t", shape, dt, card, "cuda"),
                {"d": 4, "p": 2})
    with obs.collect() as col:
        assert cache.config_for("mxv_t", shape, dt, "ref", card) == \
            TConfig(4, 2)
    assert col.counters()["tunecache.sibling_fallback"] == 1
    # the host's entries serve nothing on the card, the card's nothing
    # on the host
    cache.store(tunecache.cache_key("rowstat", shape, dt, "cpu"),
                {"d": 4, "p": 1})
    assert cache.config_for("rowstat", shape, dt, "cuda", card) is None
    assert cache.config_for("rowstat", shape, dt, "ref", card) is None
    assert cache.config_for("rowstat", shape, dt) == TConfig(4, 1)
    assert cache.config_for("mxv_t", shape, dt) is None


def test_the_jax_packages_cache_is_never_read(tmp_path, monkeypatch, fresh):
    """Both caches in one directory: the JAX package's entries (written
    by its own tune) are never read by the port, whose file and keys are
    its own."""
    jpath = fresh.parent / "jax_tune.json"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(jpath))
    jtunecache.reset_default_cache()
    jcommon.reset_plan_memo()
    try:
        jres = jregistry.tune("stream_read", mode="ref", iters=1, warmup=0,
                              max_candidates=2)
        assert jpath.exists() and not jres.from_cache
        assert tunecache.default_path() == str(fresh) != str(jpath)
        x = torch.zeros(32, 256)
        with obs.collect() as col:
            tsops.stream_read(x)
        assert col.named("kernel.resolve")[0].attrs["source"] == "planned"
        assert not fresh.exists()
        jkeys = set(json.loads(jpath.read_text())["entries"])
        monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
        monkeypatch.delenv("REPRO_TUNE_CACHE")
        monkeypatch.setenv("HOME", str(tmp_path))
        assert tunecache.default_path() != jtunecache.default_path()
        assert "repro_torch" in tunecache.default_path()
        tkey = tunecache.cache_key("stream_read", (32, 256), torch.float32)
        assert tkey not in jkeys and tkey.startswith(tunecache.KEY_PREFIX)
    finally:
        jtunecache.reset_default_cache()
        jcommon.reset_plan_memo()


@pytest.mark.parametrize("kernel", ["mxv", "stream_read", "adamw_update"])
def test_no_port_key_equals_a_jax_key(kernel, card):
    jdts = (jnp.float32, jnp.bfloat16)
    tdts = (torch.float32, torch.bfloat16)
    jkeys = {jtunecache.cache_key(kernel, s, dt, backend=b, mode=m)
             for s in ((64, 64), (8, 128)) for dt in jdts
             for b in ("cpu", "gpu", "tpu", "cuda")
             for m in (None, "pallas", "interpret", "ref")}
    tkeys = {tunecache.cache_key(kernel, s, dt, dev, m)
             for s in ((64, 64), (8, 128)) for dt in tdts
             for dev in ("cpu", card) for m in ("cuda", "ref")}
    assert len(tkeys) == 16 and not tkeys & jkeys
    # the fields other than the prefix are the JAX package's
    assert tunecache.cache_key(kernel, (64, 64), torch.float32, "cpu") == \
        tunecache.KEY_PREFIX + jtunecache.cache_key(
            kernel, (64, 64), jnp.float32, backend="cpu", mode="ref")


# ------------------------------------------------ autotune on the CPU

def test_measure_median_is_true_median():
    assert autotune._median([3.0]) == 3.0
    assert autotune._median([1.0, 2.0]) == 1.5
    assert autotune._median([5.0, 1.0, 3.0]) == 3.0
    assert autotune._median([4.0, 1.0, 3.0, 2.0]) == 2.5
    assert autotune._median([2.0, 1.0, 4.0, 3.0]) == 2.5
    assert autotune._median([1.0, 1.0, 3.0, 100.0]) == 2.0


def test_mad_filter_rejects_an_inflated_sample():
    kept, n = autotune._reject_outliers([1.0, 1.1, 0.9, 1.05, 100.0])
    assert n == 1 and 100.0 not in kept
    assert autotune._reject_outliers([2.0, 2.0, 2.0]) == ([2.0] * 3, 0)


def test_tune_writes_then_hits_cache(tmp_path):
    cache = _cache(tmp_path)
    first = autotune.tune("stream_copy", device="cpu", cache=cache,
                          iters=1, warmup=0, max_candidates=3)
    assert not first.from_cache and first.trials and first.mode == "ref"
    second = autotune.tune("stream_copy", device="cpu", cache=cache,
                           iters=1, warmup=0, max_candidates=3)
    assert second.from_cache and second.config == first.config
    assert second.trials == first.trials
    payload = json.loads((tmp_path / "tune.json").read_text())
    (key, val), = payload["entries"].items()
    assert key == first.key and key.startswith("torch:stream_copy|")
    assert key.endswith("|cpu|ref")
    assert val["source"] == "autotune"
    assert val["d"] == first.config.stride_unroll
    prov = val["provenance"]
    assert prov["torch_version"] == torch.__version__
    assert prov["device"] == "cpu" and "sources" not in prov  # no launch


def test_tune_force_remeasures(tmp_path):
    cache = _cache(tmp_path)
    autotune.tune("mxv", device="cpu", cache=cache, iters=1, warmup=0,
                  max_candidates=2)
    again = autotune.tune("mxv", device="cpu", cache=cache, iters=1,
                          warmup=0, max_candidates=2, force=True)
    assert not again.from_cache


def test_tune_without_a_card_raises_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.tune("mxv", cache=_cache(tmp_path))


def test_candidate_configs_come_from_the_planner():
    spec = tregistry.get("mxv")
    sizes = dict(spec.default_sizes)
    cands = autotune.candidate_configs(spec, sizes, torch.float32,
                                       max_candidates=5)
    assert 1 <= len(cands) <= 10
    ranked = tplanner.rank_configs(spec.traffic(sizes, torch.float32),
                                   block_rows_candidates=(0, 4, 16))
    assert [c for c, _ in cands] == [c for c, _, _ in ranked][:len(cands)]
    for cfg, bw in cands:
        assert sizes["m"] % cfg.stride_unroll == 0 and bw > 0


@pytest.mark.parametrize("rows,want", [
    (7, [(1, 1), (1, 2)]),                       # D in {2, 4} clamp to 1
    (48, [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2)]),
])
def test_fallback_candidates_respect_the_rows(rows, want):
    """A row with no Traffic gets the low-D fallback sweep, each D
    lowered to a divisor of the rows and the list deduplicated."""
    import dataclasses
    spec = tregistry.get("mxv")
    bald = dataclasses.replace(spec, traffic=None,
                               cache_shape=lambda s: (rows, s["n"]))
    cands = autotune.candidate_configs(bald, dict(spec.default_sizes),
                                       torch.float32, max_candidates=8)
    assert [(c.stride_unroll, c.portion_unroll) for c, _ in cands] == want


def test_tune_all_sweeps_named_kernels(tmp_path):
    cache = _cache(tmp_path)
    res = autotune.tune_all(["stream_read", "rmsnorm"], device="cpu",
                            cache=cache, iters=1, warmup=0,
                            max_candidates=2)
    assert set(res) == {"stream_read", "rmsnorm"}
    data = json.loads((tmp_path / "tune.json").read_text())
    assert len(data["entries"]) == 2
    assert tregistry.tune_all is autotune.tune_all
    assert tregistry.tune is autotune.tune
    assert tregistry.TuneResult is autotune.TuneResult


class _TrialClock:
    """``autotune``'s clock, stubbed: it reads ``perf_counter`` in pairs
    around each call, and the n-th pair spans ``samples[n]`` seconds
    (cyclically), whatever the host's load."""

    def __init__(self, samples):
        self.samples, self.reads, self.now = samples, 0, 0.0

    def perf_counter(self) -> float:
        if self.reads % 2:
            self.now += self.samples[(self.reads // 2) % len(self.samples)]
        self.reads += 1
        return self.now


def test_fault_sites_of_the_sweep(tmp_path, monkeypatch):
    """tune_trial: the candidate raises and is quarantined; tune_outlier:
    one inflated sample is rejected by the MAD filter (the trial clock
    stubbed to five samples within 2% of each other, so the injected one
    is the only outlier); tune_slow past the trial time limit: every
    candidate is abandoned and the sweep returns the floor without
    writing."""
    cache = _cache(tmp_path)
    with faults.inject("tune_trial:stream_copy:1"), obs.collect() as col:
        res = autotune.tune("stream_copy", device="cpu", cache=cache,
                            iters=1, warmup=0, max_candidates=3)
    assert col.counters()["tune.candidate_failed"] == 1
    (qkey, rec), = json.loads(
        (tmp_path / "tune.json").read_text())["quarantine"].items()
    assert qkey == res.key and list(rec.values())[0]["reason"] == \
        "InjectedFault"
    clock = _TrialClock([1.0, 1.02, 0.98, 1.01, 0.99])
    with monkeypatch.context() as m, faults.inject(
            "tune_outlier:stream_read:1"), obs.collect() as col:
        m.setattr(autotune, "time", clock)
        autotune.tune("stream_read", device="cpu", cache=cache, iters=5,
                      warmup=0, max_candidates=1)
    assert clock.reads == 10
    assert col.counters()["tune.outlier_rejected"] == 1
    with faults.inject("tune_slow:mxv"), obs.collect() as col:
        res = autotune.tune("mxv", device="cpu", cache=cache, iters=1,
                            warmup=0, max_candidates=2,
                            trial_timeout_s=0.01)
    assert res.config == SINGLE_STRIDED and not res.from_cache
    assert col.counters()["tune.trial_timeout"] >= 1
    assert col.named("tune.exhausted")
    assert res.key not in cache.entries()


def test_trials_emit_events(tmp_path):
    with obs.collect() as col:
        autotune.tune("mxv", device="cpu", cache=_cache(tmp_path), iters=1,
                      warmup=0, max_candidates=2)
        autotune.tune("mxv", device="cpu", cache=_cache(tmp_path), iters=1,
                      warmup=0, max_candidates=2)
    trials = col.named("tune.trial")
    assert trials and all(e.attrs["measured_gibs"] > 0 for e in trials)
    assert [e.attrs["from_cache"] for e in col.named("tune.result")] == \
        [False, True]
    assert col.counters()["tune.cache.hit"] == 1


# --------------------------------------------------------- resolve chain

def _resolve_events(fn):
    with obs.collect() as col:
        fn()
    return [e.attrs for e in col.named("kernel.resolve")]


def test_explicit_beats_tuned_beats_planned_beats_default(fresh):
    x = torch.zeros(32, 256)
    (ev,) = _resolve_events(lambda: tsops.stream_read(x))
    planned = tplanner.plan(Traffic(32, 256)).config
    assert ev["source"] == "planned"
    assert (ev["d"], ev["p"]) == (planned.stride_unroll,
                                  planned.portion_unroll)
    key = tunecache.cache_key("stream_read", x.shape, x.dtype, "cpu")
    tunecache.default_cache().store(key, {"d": 8, "p": 1})
    assert tsops.stream_read(x).shape == (8,)              # tuned
    (ev,) = _resolve_events(lambda: tsops.stream_read(x))
    assert (ev["source"], ev["d"]) == ("tuned", 8)
    out = tsops.stream_read(x, config=TConfig(4, 1))       # explicit
    assert out.shape == (4,)
    (ev,) = _resolve_events(
        lambda: tsops.stream_read(x, config=TConfig(4, 1)))
    assert ev["source"] == "explicit"
    # an op whose wrapper passes no Traffic: tuned > default
    from repro_torch.kernels.rmsnorm import ops as trops
    xr, w = torch.ones(8, 256), torch.ones(256)
    (ev,) = _resolve_events(lambda: trops.rmsnorm(xr, w))
    assert (ev["source"], ev["d"], ev["p"]) == ("default", 4, 1)
    tunecache.default_cache().store(
        tunecache.cache_key("rmsnorm", xr.shape, xr.dtype, "cpu"),
        {"d": 2, "p": 1})
    (ev,) = _resolve_events(lambda: trops.rmsnorm(xr, w))
    assert (ev["source"], ev["d"]) == ("tuned", 2)


def test_a_fresh_tune_wins_over_the_plan_memo(fresh):
    x = torch.zeros(32, 256)
    assert tsops.stream_read(x).shape == (2,)               # planned
    autotune.tune("stream_read", {"rows": 32, "cols": 256}, device="cpu",
                  iters=1, warmup=0, max_candidates=2)
    tuned = tunecache.cached_config("stream_read", (32, 256), torch.float32)
    assert tsops.stream_read(x).shape == (tuned.stride_unroll,)


def test_quarantined_planned_config_resolves_the_next_ranked(fresh):
    x = torch.zeros(32, 256)
    ranked = [c for c, _, _ in tplanner.rank_configs(Traffic(32, 256))]
    key = tunecache.cache_key("stream_read", x.shape, x.dtype, "cpu")
    tunecache.default_cache().quarantine(key, ranked[0], "smoke")
    with obs.collect() as col:
        out = tsops.stream_read(x)
    ev = col.named("kernel.resolve")[0].attrs
    assert ev["source"] == "quarantine_alt"
    assert (ev["d"], ev["p"]) == (ranked[1].stride_unroll,
                                  ranked[1].portion_unroll)
    assert out.shape == (ranked[1].stride_unroll,)
    assert col.counters()["kernel.quarantine_skip"] == 1


def test_plan_memo_is_keyed_by_device_type_and_resettable(fresh, card):
    """The plan memo is keyed by (kernel, shape, dtype, device type): a
    second resolution of the shape (other rows) hits it, the card's
    misses; a repeated call is served whole by the resolution memo (no
    tune-cache lookup, no plan memo); both reset."""
    traffic = Traffic(4096, 4096, torch.float32)
    with obs.collect() as col:
        for dev, rows in (("cpu", 4096), ("cpu", 2048), (card, 4096),
                          ("cpu", 4096)):
            tcommon.resolve_config("memo_probe", (4096, 4096),
                                   torch.float32, None, rows, TConfig(1, 1),
                                   traffic=traffic, mode="ref", device=dev)
    keys = sorted(k for k in tcommon._plan_memo if k[0] == "memo_probe")
    assert [k[-1] for k in keys] == ["cpu", "cuda"]
    assert col.counters() == {"kernel.plan_memo.miss": 2,
                              "kernel.plan_memo.hit": 1,
                              "tunecache.miss": 3}
    assert len(col.named("kernel.resolve")) == 4
    tcommon.reset_plan_memo()
    assert not tcommon._plan_memo and not tcommon._resolved


def test_resolution_memo_sees_stores_at_once_and_other_writers_later(
        fresh, monkeypatch):
    """A store through the cache shows at the next call; a write by
    another process (here: another TuneCache on the same file) shows once
    the file's time is looked at again, at most RECHECK_S later."""
    x = torch.zeros(32, 256)
    key = tunecache.cache_key("stream_read", x.shape, x.dtype, "cpu")
    assert tsops.stream_read(x).shape == (2,)                # planned
    tunecache.default_cache().store(key, {"d": 8, "p": 1})
    assert tsops.stream_read(x).shape == (8,)                # at once
    other = tunecache.TuneCache(str(fresh))
    other.store(key, {"d": 4, "p": 1})
    os.utime(fresh, (0, 12345))              # a distinct modification time
    assert tsops.stream_read(x).shape == (8,)                # not yet
    monkeypatch.setattr(tunecache, "RECHECK_S", 0.0)
    assert tsops.stream_read(x).shape == (4,)


def test_infeasible_traffic_falls_back_to_the_default(fresh):
    """doitgen at its bench problem: the resident C4 (256 KiB f32) is
    over one block's shared memory, so the planner ranks nothing and
    the op keeps its static default."""
    traffic = Traffic(4096, 256, torch.float32, 1, 1,
                      resident_bytes=256 * 256 * 4)
    with pytest.raises(ValueError):
        tplanner.plan(traffic)
    cfg = tcommon.resolve_config("doitgen", (16, 256, 256), torch.float32,
                                 None, 4096, TConfig(4, 1), traffic=traffic,
                                 mode="ref", device="cpu")
    assert cfg == TConfig(4, 1)


# ------------------------------ every wrapper's Traffic against JAX's

def _spy(monkeypatch, module, calls):
    """Record (kernel, Traffic) of every resolution given no config."""
    real = module.resolve_config

    def spy(kernel, shape, dtype, config, rows, default, traffic=None,
            **kw):
        if config is None:
            calls.append((kernel, traffic))
        return real(kernel, shape, dtype, config, rows, default,
                    traffic=traffic, **kw)
    monkeypatch.setattr(module, "resolve_config", spy)


def _fields(t):
    if t is None:
        return None
    return (t.rows, t.cols, jnp.dtype(t.dtype).name if not isinstance(
        t.dtype, torch.dtype) else str(t.dtype).removeprefix("torch."),
            t.read_arrays, t.write_arrays, t.rw_arrays, t.resident_bytes)


# JAX wrappers that resolve with no Traffic (tuned > default); the port's
# keep that, and its gemver_sum resolves through resolve_config where the
# JAX one reads the tune cache itself
NO_TRAFFIC = {"rmsnorm", "jacobi2d", "conv3x3", "gemver_sum"}


@pytest.mark.parametrize("name", sorted(jregistry.names()))
def test_wrapper_traffic_and_planned_config_match_jax(monkeypatch, fresh,
                                                      tmp_path, name):
    """Each registry row run with no config: the (kernel, Traffic) its
    wrappers hand the resolve chain equal the JAX wrappers', field by
    field, on the same sizes; none where the JAX wrapper passes none; and
    under the TPU-valued model the port plans the JAX package's config."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.delenv("REPRO_DMA_DESCRIPTOR_NS", raising=False)
    jtunecache.reset_default_cache()
    jcommon.reset_plan_memo()
    jcalls, tcalls = [], []
    _spy(monkeypatch, jcommon, jcalls)
    _spy(monkeypatch, tcommon, tcalls)
    jrow, trow = jregistry.get(name), tregistry.get(name)
    sizes = dict(jrow.default_sizes)
    try:
        jrow.run(jrow.make_inputs(sizes, jnp.float32), None, "ref")
        trow.run(trow.make_inputs(sizes, torch.float32, "cpu"), None, None)
    finally:
        jtunecache.reset_default_cache()
        jcommon.reset_plan_memo()
    jt = [(k, _fields(t)) for k, t in jcalls]
    tt = [(k, _fields(t)) for k, t in tcalls
          if not (t is None and k in NO_TRAFFIC and
                  (k, None) not in jt)]
    assert tt == jt
    assert {k for k, t in tcalls if t is None} <= NO_TRAFFIC
    for (k, t), (_, j) in zip(tcalls, jcalls):
        if t is None:
            continue
        tp = tplanner.plan(t, model=TPU_MODEL, budget=VMEM).config
        jp = jplanner.plan(j).config
        assert (tp.stride_unroll, tp.portion_unroll, tp.block_rows) == (
            jp.stride_unroll, jp.portion_unroll, jp.block_rows), k


def test_wrappers_resolve_the_card_models_config(fresh):
    """With no config, the stream, mxv, decode and adamw wrappers run
    the H100 model's plan (D = 2, P = 2 at these shapes), as chip_smoke's
    serve and train phases print."""
    from repro_torch.kernels.adamw import ops as taops
    from repro_torch.kernels.decode_attn import ops as tdops
    from repro_torch.kernels.mxv import ops as tmops
    a, v = torch.zeros(64, 256), torch.zeros(256)
    q, kv = torch.zeros(1, 4, 64), torch.zeros(1, 256, 2, 64)
    p = torch.zeros(64, 512)
    evs = (_resolve_events(lambda: tmops.mxv(a, v))
           + _resolve_events(lambda: tmops.mxv_t(a, torch.zeros(64)))
           + _resolve_events(lambda: tdops.decode_attn(q, kv, kv))
           + _resolve_events(lambda: taops.adamw_update(p, p, p, p, 1e-3))
           + _resolve_events(lambda: tsops.stream_copy(a)))
    assert [(e["source"], e["d"], e["p"]) for e in evs] == \
        [("planned", 2, 2)] * 5


def test_ops_outputs_follow_the_resolved_config(fresh):
    """A tuned stream_read D changes the output shape; the result's total
    stays the same sum."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (32, 256)).astype(np.float32))
    base = tsops.stream_read(x)
    tunecache.default_cache().store(
        tunecache.cache_key("stream_read", x.shape, x.dtype, "cpu"),
        {"d": 8, "p": 1})
    out = tsops.stream_read(x)
    assert out.shape == (8,)
    np.testing.assert_allclose(out.sum().item(), base.sum().item(),
                               rtol=1e-4)
