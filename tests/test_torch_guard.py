"""Guarded dispatch on the port (``kernels.common.guarded_run``), the
counterpart of ``tests/test_faults.py``'s chain tests.

``guarded_run`` takes ``run`` as a Python callable, so its ``cuda`` mode
needs no card: the chain's tests call it directly, and the ops' tests
(``*_gen`` through ``make_kernel_op`` and the composites) dispatch CPU
tensors as if they lay on the card, with the emitter's launch
(``codegen.emit.emit_spec``) replaced by a stand-in kernel that counts
its launches.

Where the port deliberately differs from the JAX package:

  * no tier ever runs the plain version (``loopir.evaluate`` is made to
    raise in the chain's tests): the chain is up to two next-ranked
    configs of the same kernel, then the original exception;
  * a kernel source that does not build and a CUDA error that poisons
    the context re-raise at once, with nothing quarantined;
  * JAX's ``test_invalid_explicit_config_degrades_to_ref_no_emission``
    (``tests/test_analysis.py:329``) ends at the ref oracle; here a
    statically rejected explicit config ends at an alt config (where the
    planner finds one the checker passes) or at the ``AnalysisError``
    (where it finds none), with no launch of the rejected config.
"""
import pytest
import torch

from repro_torch import obs
from repro_torch import registry as tregistry
from repro_torch.analysis import AnalysisError, findings as F, fixtures
from repro_torch.codegen import emit, loopir
from repro_torch.core.striding import SINGLE_STRIDED, StridingConfig
from repro_torch.kernels import common, cuda
from repro_torch.kernels import gen as tgen
from repro_torch.kernels.mxv import specs as mspecs
from repro_torch.registry import tunecache
from repro_torch.runtime import faults
from repro_torch.runtime.faults import InjectedFault

CPU = torch.device("cpu")


@pytest.fixture
def fresh(tmp_path, monkeypatch):
    """The port's default tune cache at a fresh file, the plan memo
    empty; both reset again after the test."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    tunecache.reset_default_cache()
    common.reset_plan_memo()
    yield tunecache.default_cache()
    tunecache.reset_default_cache()
    common.reset_plan_memo()


class _Card:
    """CPU tensors dispatched as on the card: ``kernel_mode`` answers
    ``cuda`` unless ``mode="ref"`` is asked for, and the emitter's launch
    is a stand-in kernel that records (spec name, config) and computes
    the spec's result (with the plain version saved before the test made
    ``loopir.evaluate`` raise)."""

    def __init__(self, monkeypatch, forbid_plain: bool):
        self.launches = []
        real_mode = common.kernel_mode
        self._evaluate = loopir.evaluate

        def kernel_mode(x, mode=None):
            m = real_mode(x, mode)
            return "cuda" if m == "ref" and mode is None else m

        def emit_spec(spec, inputs, config, device=None):
            self.launches.append((spec.name, config))
            return self._evaluate(spec, inputs, device=device)

        monkeypatch.setattr(common, "kernel_mode", kernel_mode)
        monkeypatch.setattr(emit, "emit_spec", emit_spec)
        if forbid_plain:
            def plain(*a, **k):
                raise AssertionError("a tier ran the plain version")
            monkeypatch.setattr(loopir, "evaluate", plain)


@pytest.fixture
def card(monkeypatch, fresh):
    return _Card(monkeypatch, forbid_plain=True)


def _mxv_inputs(m=64, n=256):
    g = torch.Generator().manual_seed(0)
    return torch.randn(m, n, generator=g), torch.randn(n, generator=g)


def _cfg_of(rec) -> tuple:
    return (rec["d"], rec["p"], rec["block_rows"])


# ------------------------------------------------------------ the classes

def test_classify_failure_classes():
    assert common.classify_failure(InjectedFault("x")) == "injected"
    fx = fixtures.build("smem")
    with pytest.raises(AnalysisError) as ei:
        from repro_torch import analysis
        analysis.ensure_valid("k", fx.spec, fx.config)
    assert common.classify_failure(ei.value) == "analysis"
    assert common.classify_failure(NotImplementedError()) == "unsupported"
    assert common.classify_failure(ValueError("bad D")) == "invalid_config"
    assert common.classify_failure(TypeError("dtype")) == "invalid_config"
    assert common.classify_failure(RuntimeError("boom")) == "backend"
    assert common.classify_failure(cuda.LaunchError(
        "rowdot: launch failed with CUDA error 1 (invalid argument)",
        1)) == "backend"


# the card's own messages, as its runtime and PyTorch give them
# (chip_smoke.py's guard phase prints them from the card)
CARD_RESOURCE_MESSAGES = [
    cuda.LaunchError("rowdot: launch failed with CUDA error 701 (too many "
                     "resources requested for launch)", 701),
    torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 1024.00 GiB. GPU 0 has a "
        "total capacity of 79.18 GiB of which 78.18 GiB is free. Process 1 "
        "has 1010.00 MiB memory in use. Of the allocated memory 224.00 MiB "
        "is allocated by PyTorch, and 38.00 MiB is reserved by PyTorch but "
        "unallocated."),
    ValueError("K4 ring does not fit shared memory: 393472 bytes for a "
               "128-column step (lookahead 4 x D 16 stages of 8 rows for "
               "each input (element bytes (4,)), 2 x D for each full-row "
               "output ((4,)), and the barriers) against a limit of 232448 "
               "bytes"),
]


@pytest.mark.parametrize("exc", CARD_RESOURCE_MESSAGES,
                         ids=["launch_resources", "oom", "ring_no_tile"])
def test_card_resource_messages_classify_as_resource(exc):
    """All three are ``resource``; the card out of device memory is also
    one no config can fix (what a call allocates does not depend on its
    config), so the guard re-raises it with nothing quarantined."""
    assert common.classify_failure(exc) == "resource"
    assert common.unrecoverable(exc) == isinstance(exc,
                                                   torch.OutOfMemoryError)


def test_ring_opt_in_refusals_classify_as_resource():
    """The ring launcher's own refusals, as its geometry raises them: no
    tile fits (the smem fixture), and a tile asked for above the opt-in."""
    from repro_torch.codegen.transforms import plan_blocks
    from repro_torch.kernels import manual
    fx = fixtures.build("smem")
    bp = plan_blocks(fx.spec, fx.config)
    for tile in (None, 4096):
        cfg = fx.config if tile is None else StridingConfig(2, 1, 4)
        with pytest.raises(ValueError) as ei:
            manual.ring_plan("stream_copy", torch.float32,
                             bp if tile is None else plan_blocks(fx.spec, cfg),
                             cfg, 132, tile=tile)
        assert common.classify_failure(ei.value) == "resource"
    assert str(ei.value).endswith("the most one block may opt into")


POISONED = [
    cuda.LaunchError("decode_attn: launch failed with CUDA error 700 (an "
                     "illegal memory access was encountered)", 700),
    cuda.LaunchError("doitgen: launch failed with CUDA error 719 "
                     "(unspecified launch failure)", 719),
    RuntimeError("CUDA error: an illegal memory access was encountered\n"
                 "CUDA kernel errors might be asynchronously reported at "
                 "some other API call"),
    RuntimeError("CUDA error: misaligned address"),
    cuda.BuildError("nvcc failed for stream.cu (exit 2):\nerror"),
    CARD_RESOURCE_MESSAGES[1],
]


@pytest.mark.parametrize("exc", POISONED, ids=["launch_700", "launch_719",
                                               "torch_700", "torch_716",
                                               "build", "oom"])
def test_unrecoverable_failures(exc):
    assert common.unrecoverable(exc)


def test_recoverable_failures():
    for exc in (InjectedFault("x"), ValueError("x"), NotImplementedError(),
                RuntimeError("boom"),
                cuda.LaunchError("x: CUDA error 1 (invalid argument)", 1)):
        assert not common.unrecoverable(exc)


# ---------------------------------------- the chain through mxv_gen

def test_single_fault_lands_on_the_alt_config_tier(card, fresh):
    a, x = _mxv_inputs()
    with obs.collect() as col:
        with faults.inject("lower:mxv_gen:1"):
            out = tgen.mxv_gen(a, x)
    torch.testing.assert_close(out, a @ x, rtol=1e-5, atol=1e-5)
    evs = col.named("kernel.fallback")
    assert len(evs) == 1
    ev = evs[0].attrs
    assert ev["tier"] == "alt_config" and ev["failure"] == "injected"
    assert ev["from_mode"] == ev["to_mode"] == "cuda"
    assert (ev["d"], ev["p"]) != (ev["failed_d"], ev["failed_p"])
    assert col.counter_value("kernel.fallback.count") == 1
    # the alt tier launched once, at its config; the failed one never
    assert [(c.stride_unroll, c.portion_unroll) for _, c in card.launches] \
        == [(ev["d"], ev["p"])]
    qkey = tunecache.cache_key("mxv_gen", a.shape, a.dtype, CPU, "cuda")
    q = fresh.quarantined(qkey)
    assert [r["reason"] for r in q.values()] == ["injected"]
    assert [_cfg_of(r)[:2] for r in q.values()] == [(ev["failed_d"],
                                                     ev["failed_p"])]


def test_quarantined_config_is_not_resolved_again(card, fresh):
    a, x = _mxv_inputs()
    with faults.inject("lower:mxv_gen:1"):
        tgen.mxv_gen(a, x)
    qkey = tunecache.cache_key("mxv_gen", a.shape, a.dtype, CPU, "cuda")
    (bad,) = fresh.quarantined(qkey).values()
    with obs.collect() as col:
        out = tgen.mxv_gen(a, x)
    torch.testing.assert_close(out, a @ x, rtol=1e-5, atol=1e-5)
    (ev,) = col.named("kernel.resolve")
    assert ev.attrs["source"] == "quarantine_alt"
    assert (ev.attrs["d"], ev.attrs["p"], ev.attrs["block_rows"]) != \
        _cfg_of(bad)
    assert not col.named("kernel.fallback")


def test_every_tier_failing_reraises_the_original(card, fresh):
    a, x = _mxv_inputs()
    with obs.collect() as col:
        with faults.inject("lower:mxv_gen") as plan:
            with pytest.raises(InjectedFault):
                tgen.mxv_gen(a, x)
    assert plan.rules[0].fired == 3          # the config and two alts
    assert card.launches == []
    assert not col.named("kernel.fallback")
    qkey = tunecache.cache_key("mxv_gen", a.shape, a.dtype, CPU, "cuda")
    assert len(fresh.quarantined(qkey)) == 3


def test_ref_has_no_guard(fresh):
    """A ref-mode (or CPU) failure re-raises untouched: no fault site, no
    quarantine, one call."""
    calls = []

    def run(cfg, mode):
        calls.append(mode)
        raise RuntimeError("oracle bug")
    with faults.inject("lower"):
        with pytest.raises(RuntimeError, match="oracle bug"):
            common.guarded_run("fake_kernel", run, SINGLE_STRIDED, "ref",
                               shape=(4, 4), dtype=torch.float32,
                               device=CPU, traffic=None)
    assert calls == ["ref"]
    assert fresh.quarantined(tunecache.cache_key(
        "fake_kernel", (4, 4), torch.float32, CPU, "ref")) == {}
    # an op on CPU tensors runs the plain version, the fault site unarmed
    a, x = _mxv_inputs()
    with faults.inject("lower:mxv_gen") as plan:
        torch.testing.assert_close(tgen.mxv_gen(a, x), a @ x, rtol=1e-5,
                                   atol=1e-5)
    assert plan.rules[0].fired == 0


def test_no_tier_left_reraises_the_original_object(fresh):
    from repro_torch.core.planner import Traffic
    calls = []
    first = NotImplementedError("no tier works")

    def run(cfg, mode):
        calls.append(cfg)
        raise first if len(calls) == 1 else NotImplementedError("alt")
    with pytest.raises(NotImplementedError) as ei:
        common.guarded_run("fake_kernel", run, SINGLE_STRIDED, "cuda",
                           shape=(64, 256), dtype=torch.float32, device=CPU,
                           rows=64, traffic=Traffic(64, 256))
    assert ei.value is first
    assert len(calls) == 3 and len({(c.stride_unroll, c.portion_unroll)
                                    for c in calls}) == 3


@pytest.mark.parametrize("exc", POISONED[::2] + POISONED[1::4],
                         ids=["launch_700", "torch_700", "build",
                              "launch_719", "oom"])
def test_unfixable_failures_reraise_with_nothing_quarantined(fresh, exc):
    from repro_torch.core.planner import Traffic
    calls = []

    def run(cfg, mode):
        calls.append(cfg)
        raise exc
    with obs.collect() as col:
        with pytest.raises(type(exc)) as ei:
            common.guarded_run("fake_kernel", run, SINGLE_STRIDED, "cuda",
                               shape=(64, 256), dtype=torch.float32,
                               device=CPU, rows=64, traffic=Traffic(64, 256))
    assert ei.value is exc and len(calls) == 1
    assert fresh.quarantined(tunecache.cache_key(
        "fake_kernel", (64, 256), torch.float32, CPU, "cuda")) == {}
    assert not col.counters()


def test_a_poisoned_context_in_an_alt_tier_stops_the_chain(fresh):
    from repro_torch.core.planner import Traffic
    calls = []
    sticky = POISONED[1]

    def run(cfg, mode):
        calls.append(cfg)
        raise sticky
    with faults.inject("lower:fake_kernel:1"):
        with pytest.raises(cuda.LaunchError) as ei:
            common.guarded_run("fake_kernel", run, SINGLE_STRIDED, "cuda",
                               shape=(64, 256), dtype=torch.float32,
                               device=CPU, rows=64, traffic=Traffic(64, 256))
    assert ei.value is sticky and len(calls) == 1
    q = fresh.quarantined(tunecache.cache_key(
        "fake_kernel", (64, 256), torch.float32, CPU, "cuda"))
    assert [r["reason"] for r in q.values()] == ["injected"]


def test_exact_config_reraises_with_nothing_quarantined(fresh):
    """Under ``exact_config`` the config asked for is the only one run: a
    recoverable failure re-raises untouched, with no tier, no quarantine
    and no fallback counted."""
    from repro_torch.core.planner import Traffic
    calls = []
    first = ValueError("bad D")

    def run(cfg, mode):
        calls.append(cfg)
        raise first
    with obs.collect() as col:
        with common.exact_config():
            with pytest.raises(ValueError) as ei:
                common.guarded_run("fake_kernel", run, SINGLE_STRIDED,
                                   "cuda", shape=(64, 256),
                                   dtype=torch.float32, device=CPU, rows=64,
                                   traffic=Traffic(64, 256))
    assert ei.value is first and calls == [SINGLE_STRIDED]
    assert fresh.quarantined(tunecache.cache_key(
        "fake_kernel", (64, 256), torch.float32, CPU, "cuda")) == {}
    assert not col.counters() and not col.named("kernel.fallback")


def test_tune_trial_of_a_failing_config_raises(card, fresh):
    """The autotuner times the candidate it names and nothing else: a
    candidate whose launch fails raises out of the trial (for the
    tuner's own failure path) instead of being served, and timed, at
    another config by the guard."""
    from repro_torch.registry import autotune
    row = tregistry.get("mxv_gen")
    inputs = _mxv_inputs()
    cfg = StridingConfig(2, 2)
    with obs.collect() as col:
        with faults.inject("lower:mxv_gen:1"):
            with pytest.raises(InjectedFault):
                autotune._measure(row, [inputs], cfg, "cuda", iters=1,
                                  warmup=1)
    assert card.launches == []
    assert not col.named("kernel.fallback")
    a = inputs[0]
    assert fresh.quarantined(tunecache.cache_key(
        "mxv_gen", a.shape, a.dtype, CPU, "cuda")) == {}


def test_success_opens_no_tune_cache(monkeypatch):
    def boom():
        raise AssertionError("the tune cache was opened")
    monkeypatch.setattr(tunecache, "default_cache", boom)
    out = common.guarded_run("fake_kernel", lambda c, m: 7, SINGLE_STRIDED,
                             "cuda", shape=(4,), dtype=torch.float32,
                             device=CPU)
    assert out == 7


# --------------------------------------------- the composite wrappers

_COMPOSITES = ["bicg_gen", "gemver_mxv1_gen", "gemver_mxv1_sum_gen",
               "conv3x3_gen", "decode_attn_gen", "rmsnorm_gen",
               "adamw_update_gen"]


@pytest.mark.parametrize("name", _COMPOSITES)
def test_composite_wrappers_are_gated_and_guarded(monkeypatch, fresh, name):
    row = tregistry.get(name)
    inputs = row.make_inputs(dict(row.default_sizes), torch.float32, CPU)
    want = row.run(inputs, None, "ref")
    card = _Card(monkeypatch, forbid_plain=False)
    with obs.collect() as col:
        with faults.inject(f"lower:{name}:1"):
            got = row.run(inputs, None, None)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        torch.testing.assert_close(g, w, rtol=row.rtol, atol=row.atol)
    (ev,) = col.named("kernel.fallback")
    assert ev.attrs["kernel"] == name and ev.attrs["tier"] == "alt_config"
    assert col.named("analysis.pass")            # the gate ran
    assert card.launches
    assert {c for _, c in card.launches} == {StridingConfig(
        ev.attrs["d"], ev.attrs["p"])} or name == "adamw_update_gen"


# ------------------------------ a statically rejected explicit config

def test_rejected_explicit_config_without_alternative_raises(card, fresh):
    """The race fixture rejects every config (RACE001): the gate raises
    before any launch, the config is quarantined as ``analysis``, the
    planner ranks no alternative, and the ``AnalysisError`` is raised."""
    fx = fixtures.build("race")
    op = emit.make_kernel_op("t_clobber_gen", lambda tok: fx.spec,
                             default=fx.config)
    tok = torch.arange(4 * 256, dtype=torch.float32).reshape(4, 256) / 64
    with obs.collect() as col:
        with pytest.raises(AnalysisError):
            op(tok, config=fx.config)
    assert card.launches == []
    assert {e.attrs["rule"] for e in col.named("analysis.violation")} == \
        {F.RACE001}
    qkey = tunecache.cache_key("t_clobber_gen", tok.shape, tok.dtype, CPU,
                               "cuda")
    assert [r["reason"] for r in fresh.quarantined(qkey).values()] == \
        ["analysis"]


def test_repeated_rejected_config_raises_fresh_and_quarantines_once(card,
                                                                    fresh):
    """A caller that repeats a config the checker rejects gets a new
    ``AnalysisError`` each call (the gate memoizes findings, not the
    error and its traceback), and the tune cache records the config
    once."""
    fx = fixtures.build("race")
    op = emit.make_kernel_op("t_clobber_gen", lambda tok: fx.spec,
                             default=fx.config)
    tok = torch.arange(4 * 256, dtype=torch.float32).reshape(4, 256) / 64
    errs = []
    for _ in range(3):
        with pytest.raises(AnalysisError) as ei:
            op(tok, config=fx.config)
        errs.append(ei.value)
    assert len({id(e) for e in errs}) == 3
    assert {e.findings for e in errs} == {errs[0].findings}
    assert card.launches == []
    qkey = tunecache.cache_key("t_clobber_gen", tok.shape, tok.dtype, CPU,
                               "cuda")
    assert [r["count"] for r in fresh.quarantined(qkey).values()] == [1]


def test_rejected_explicit_config_lands_on_an_alt_config(card, fresh):
    """The stream copy at D = 16, lookahead 4: a K4 ring that does not fit
    a block (RES001), rejected before any launch and served by the
    next-ranked config the checker passes (a K1 one)."""
    from repro_torch.kernels.stream import specs as sspecs
    op = emit.make_kernel_op("t_copy_gen", sspecs.copy_spec)
    x = torch.randn(128, 128, generator=torch.Generator().manual_seed(1))
    bad = StridingConfig(16, 1, lookahead=4, block_rows=8)
    with obs.collect() as col:
        out = op(x, config=bad)
    assert torch.equal(out, x)
    (ev,) = col.named("kernel.fallback")
    assert ev.attrs["failure"] == "analysis"
    assert ev.attrs["tier"] == "alt_config"
    assert {e.attrs["rule"] for e in col.named("analysis.violation")} == \
        {F.RES001}
    (launch,) = card.launches
    assert launch[1].lookahead == 2 and (launch[1].stride_unroll,
                                         launch[1].portion_unroll) == (
        ev.attrs["d"], ev.attrs["p"])


def test_gate_verdicts_are_memoized_and_ref_skips_the_gate(monkeypatch,
                                                            card, fresh):
    from repro_torch import analysis
    calls = []
    real = analysis.ensure_valid

    def counting(*a, **k):
        calls.append(a[0])
        return real(*a, **k)
    monkeypatch.setattr(analysis, "ensure_valid", counting)
    op = emit.make_kernel_op("t_mxv_gen", mspecs.mxv_spec)
    a, x = _mxv_inputs()
    for _ in range(3):
        op(a, x, config=StridingConfig(2, 2))
    assert calls == ["t_mxv_gen"]
    op(a, x, config=StridingConfig(2, 1))
    assert calls == ["t_mxv_gen"] * 2
    monkeypatch.setattr(loopir, "evaluate", card._evaluate)
    op(a, x, config=StridingConfig(4, 4), mode="ref")
    assert len(calls) == 2
