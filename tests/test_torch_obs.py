"""repro_torch.obs: record kinds, spans, collectors, the JSONL sink and
``REPRO_TORCH_OBS`` — the counterparts of ``tests/test_obs.py`` and
``tests/test_faults.py``'s sink tests — and, where both packages emit the
same event in a session, the port's names and attribute keys against
the JAX package's.

The disabled-mode contract matters most: with no collector installed
every emit call returns after a single None check.
"""
import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as JK
from repro import analysis as janalysis
from repro import obs as jobs
from repro.analysis import fixtures as jfixtures
from repro.kernels import common as jcommon
from repro.obs import core as jobs_core
from repro.registry import tunecache as jtunecache
from repro.runtime import faults as jfaults
from repro_torch import analysis as tanalysis
from repro_torch import obs
from repro_torch.analysis import fixtures as tfixtures
from repro_torch.core.striding import SINGLE_STRIDED
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import gen as tgen
from repro_torch.obs import core as obs_core
from repro_torch.registry import tunecache
from repro_torch.runtime import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_ambient_collector():
    """Tests drive collectors explicitly; neutralize $REPRO_TORCH_OBS."""
    prev, jprev = obs_core._collector, jobs_core._collector
    obs_core._collector = jobs_core._collector = None
    yield
    obs_core._collector, jobs_core._collector = prev, jprev


# ------------------------------------------------------------- semantics

def test_event_counter_span_record_kinds():
    with obs.collect() as col:
        obs.event("e.one", kernel="k", d=4)
        obs.counter("c.one")
        obs.counter("c.one", value=2.5, tag="x")
        with obs.span("s.one", phase="work") as sp:
            sp.set(rows=7)
    kinds = [(e.kind, e.name) for e in col.events]
    assert kinds == [("event", "e.one"), ("counter", "c.one"),
                     ("counter", "c.one"), ("span", "s.one")]
    ev = col.named("e.one")[0]
    assert ev.attrs == {"kernel": "k", "d": 4} and ev.ts > 0
    assert col.counter_value("c.one") == 3.5
    sp = col.named("s.one")[0]
    assert sp.attrs == {"phase": "work", "rows": 7} and sp.value >= 0.0


def test_span_times_the_region():
    with obs.collect() as col:
        with obs.span("s.timed"):
            time.sleep(0.02)
    assert col.named("s.timed")[0].value >= 0.015


def test_span_records_on_an_exception_and_into_the_current_collector():
    with obs.collect() as col:
        with pytest.raises(KeyError):
            with obs.span("s.raised"):
                raise KeyError("x")
    assert [e.name for e in col.events] == ["s.raised"]


def test_counters_aggregate_and_clear():
    with obs.collect() as col:
        for _ in range(3):
            obs.counter("hits", kernel="a")
        obs.counter("misses")
    assert col.counters() == {"hits": 3.0, "misses": 1.0}
    assert col.counter_value("absent") == 0.0
    col.clear()
    assert col.events == [] and col.counters() == {}
    col.close()


def test_collect_restores_previous_collector():
    outer = obs.MemoryCollector()
    obs.install(outer)
    try:
        with obs.collect() as inner:
            obs.event("inner.only")
        obs.event("outer.only")
        assert [e.name for e in inner.events] == ["inner.only"]
        assert [e.name for e in outer.events] == ["outer.only"]
    finally:
        obs.uninstall()


def test_install_uninstall_toggle_enabled_and_close():
    closed = []

    class Closing(obs.MemoryCollector):
        def close(self):
            closed.append(self)
    assert not obs.enabled() and obs.active_collector() is None
    first, second = Closing(), Closing()
    obs.install(first)
    assert obs.enabled() and obs.active_collector() is first
    obs.install(second)                 # replacing closes the first
    assert closed == [first]
    obs.uninstall()
    assert closed == [first, second]
    assert not obs.enabled() and obs.active_collector() is None


# ---------------------------------------------------------- disabled mode

def test_disabled_emission_is_noop():
    assert not obs.enabled()
    obs.event("never", a=1)
    obs.counter("never")
    with obs.span("never") as sp:
        sp.set(b=2)
    with obs.collect() as col:
        pass
    assert col.events == []


def test_disabled_overhead_is_negligible():
    """200k disabled emits must be cheap (a single None check a call);
    the bound is loose: an Event built on the disabled path is an order
    of magnitude slower and fails it clearly."""
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        obs.event("hot.path", kernel="k", d=4)
        obs.counter("hot.counter")
    assert time.perf_counter() - t0 < 2.0


# ------------------------------------------------------------- JSONL sink

def test_jsonl_sink_round_trip(tmp_path):
    path = str(tmp_path / "obs.jsonl")
    sink = obs.JsonlSink(path)
    obs.install(sink)
    try:
        obs.event("resolve", kernel="mxv", source="tuned")
        obs.counter("hits", value=2)
        with obs.span("sweep", kernel="mxv"):
            pass
    finally:
        obs.uninstall()      # closes the sink
    records = obs.read_jsonl(path)
    assert [r["name"] for r in records] == ["resolve", "hits", "sweep"]
    assert records[0]["kind"] == "event"
    assert records[0]["attrs"] == {"kernel": "mxv", "source": "tuned"}
    assert records[1]["value"] == 2
    assert records[2]["kind"] == "span" and records[2]["value"] >= 0.0
    assert set(records[0]) == {"kind", "name", "value", "ts", "attrs"}


def test_jsonl_records_have_the_jax_sinks_layout(tmp_path):
    tpath, jpath = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    for mod, path in ((obs, tpath), (jobs, jpath)):
        mod.install(mod.JsonlSink(path))
        try:
            mod.event("x", a=1)
            mod.counter("y")
            with mod.span("z"):
                pass
        finally:
            mod.uninstall()
    t, j = obs.read_jsonl(tpath), jobs.read_jsonl(jpath)
    assert [(r["kind"], r["name"], sorted(r)) for r in t] == \
        [(r["kind"], r["name"], sorted(r)) for r in j]


@pytest.mark.parametrize("value", ["off", "", "0", "none", "disabled"])
def test_configure_from_env_off(value):
    obs.install(obs.MemoryCollector())
    obs.configure_from_env(value)
    assert not obs.enabled()


def test_configure_from_env_variants(tmp_path, monkeypatch):
    obs.configure_from_env("memory")
    try:
        assert isinstance(obs.active_collector(), obs.MemoryCollector)
    finally:
        obs.uninstall()
    for value in (f"jsonl:{tmp_path / 'a.jsonl'}", str(tmp_path / "b.jsonl")):
        obs.configure_from_env(value)
        try:
            obs.event("x")
        finally:
            obs.uninstall()
    assert obs.read_jsonl(str(tmp_path / "a.jsonl"))[0]["name"] == "x"
    assert obs.read_jsonl(str(tmp_path / "b.jsonl"))[0]["name"] == "x"
    monkeypatch.setenv("REPRO_TORCH_OBS", "memory")
    monkeypatch.setenv("REPRO_OBS", "off")
    obs.configure_from_env()
    try:
        assert isinstance(obs.active_collector(), obs.MemoryCollector)
    finally:
        obs.uninstall()


def test_env_is_read_when_the_package_is_imported(tmp_path):
    """``REPRO_TORCH_OBS`` (not the JAX package's ``REPRO_OBS``) installs
    the sink at import: a fresh process writes an op's events."""
    path = tmp_path / "run.jsonl"
    code = ("import torch; import repro_torch.kernels as K; "
            "from repro_torch import obs; "
            "K.mxv_gen(torch.ones(8, 128), torch.ones(128)); "
            "obs.uninstall()")
    env = dict(os.environ, REPRO_TORCH_OBS=f"jsonl:{path}",
               REPRO_TORCH_TUNE_CACHE=str(tmp_path / "tune.json"),
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_OBS", None)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300)
    names = {r["name"] for r in obs.read_jsonl(str(path))}
    assert {"kernel.resolve", "codegen.spec_memo.miss"} <= names


def test_read_jsonl_tolerates_truncated_tail(tmp_path):
    path = str(tmp_path / "obs.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "event", "name": "a"}) + "\n")
        f.write(json.dumps({"kind": "event", "name": "b"}) + "\n")
        f.write('{"kind": "event", "na')          # killed mid-write
    recs = obs.read_jsonl(path)
    assert [r["name"] for r in recs] == ["a", "b"]
    assert obs.read_jsonl.skipped == 1
    with pytest.raises(json.JSONDecodeError):
        obs.read_jsonl(path, strict=True)


def test_jsonl_sink_survives_io_faults(tmp_path):
    path = str(tmp_path / "obs.jsonl")
    sink = obs.JsonlSink(path)
    obs.install(sink)
    try:
        with faults.inject("sink_io::2"):
            obs.event("x", i=0)     # dropped
            obs.event("x", i=1)     # dropped
            obs.event("x", i=2)     # lands
    finally:
        obs.uninstall()
    assert sink.dropped == 2
    recs = obs.read_jsonl(path)
    # the dropped events never land; their fault.injected audit lines
    # do (the reentrancy guard lets them through), as does the third
    assert [r["attrs"]["i"] for r in recs if r["name"] == "x"] == [2]
    assert sum(r["name"] == "fault.injected" for r in recs) == 2


def test_jsonl_sink_counts_a_real_oserror(tmp_path):
    sink = obs.JsonlSink(str(tmp_path / "obs.jsonl"))
    sink.close()
    sink._f = open(os.devnull)           # read-only: write raises OSError
    try:
        sink.record(obs_core.Event("event", "x", {}))
    finally:
        sink._f.close()
    assert sink.dropped == 1


def test_sink_io_fault_site_is_documented_with_lower():
    assert "``sink_io``" in faults.__doc__ and "``lower``" in faults.__doc__
    assert not faults.enabled()
    with faults.inject("sink_io"):
        assert faults.enabled()
    assert not faults.enabled()


# ------------------------------- the same events from both packages

def _keys(col, name):
    return [sorted(e.attrs) for e in col.named(name)]


@pytest.fixture
def both_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "j.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    for tc, c in ((jtunecache, jcommon), (tunecache, tcommon)):
        tc.reset_default_cache()
        c.reset_plan_memo()
    yield
    for tc, c in ((jtunecache, jcommon), (tunecache, tcommon)):
        tc.reset_default_cache()
        c.reset_plan_memo()


def test_an_op_call_emits_the_jax_names_and_keys(both_caches):
    # a shape no other test calls, so both spec memos miss
    a = np.random.default_rng(0).standard_normal((72, 384)).astype(
        np.float32)
    x = np.ones(384, np.float32)
    with jobs.collect() as jcol:
        JK.mxv_gen(jnp.asarray(a), jnp.asarray(x), mode="ref")
    with obs.collect() as tcol:
        tgen.mxv_gen(torch.from_numpy(a), torch.from_numpy(x))
    assert [e.name for e in tcol.events] == [e.name for e in jcol.events]
    for name in {e.name for e in jcol.events}:
        assert _keys(tcol, name) == _keys(jcol, name), name


def test_the_verifier_emits_the_jax_names_and_keys():
    for fx_name in ("race", "halo"):
        jfx, tfx = jfixtures.build(fx_name), tfixtures.build(fx_name)
        with jobs.collect() as jcol:
            with pytest.raises(janalysis.AnalysisError):
                janalysis.ensure_valid("k", jfx.spec, jfx.config)
        with obs.collect() as tcol:
            with pytest.raises(tanalysis.AnalysisError):
                tanalysis.ensure_valid("k", tfx.spec, tfx.config)
        assert _keys(tcol, "analysis.violation") == \
            _keys(jcol, "analysis.violation")
    jspec = jfixtures.build("reassoc").spec
    tspec = tfixtures.build("reassoc").spec
    from repro.core.striding import StridingConfig as JC
    from repro_torch.core.striding import StridingConfig as TC
    with jobs.collect() as jcol:
        janalysis.ensure_valid("k", jspec, JC(2, 4))
    with obs.collect() as tcol:
        tanalysis.ensure_valid("k", tspec, TC(2, 4))
    assert _keys(tcol, "analysis.pass") == _keys(jcol, "analysis.pass")


def test_the_guard_emits_the_jax_names_and_keys(both_caches):
    """One failure served by an alt config, through each package's
    guard with a fake run: kernel.fallback, its counter, the quarantine
    and the fault's audit event carry the same names and keys."""
    from repro.core.planner import Traffic as JT
    from repro.core.striding import SINGLE_STRIDED as JSS
    from repro_torch.core.planner import Traffic as TT

    def run(cfg, mode):
        return 1
    with jobs.collect() as jcol:
        with jfaults.inject("lower:fake:1"):
            jcommon.guarded_run("fake", run, JSS, "interpret",
                                shape=(64, 256), dtype=jnp.float32, rows=64,
                                traffic=JT(64, 256))
    with obs.collect() as tcol:
        with faults.inject("lower:fake:1"):
            tcommon.guarded_run("fake", run, SINGLE_STRIDED, "cuda",
                                shape=(64, 256), dtype=torch.float32,
                                device=torch.device("cpu"), rows=64,
                                traffic=TT(64, 256))
    names = ["fault.injected", "tunecache.quarantine",
             "kernel.fallback.count", "kernel.fallback"]
    assert [e.name for e in tcol.events] == [e.name for e in jcol.events] \
        == names
    for name in names:
        assert _keys(tcol, name) == _keys(jcol, name), name
    assert tcol.named("kernel.fallback")[0].attrs["tier"] == \
        jcol.named("kernel.fallback")[0].attrs["tier"] == "alt_config"
