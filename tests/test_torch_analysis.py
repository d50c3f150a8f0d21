"""The port's static verifier (``repro_torch.analysis``) held against the
JAX package's (``repro.analysis``) on shared specs, its card rule RES001
against each launcher's own geometry, its wiring (``ensure_valid``'s
events, the planner's gate) and ``tools/torch_speclint.py`` in its
three modes.

The RACE, BOUNDS and NUM rules are the JAX checker's: on every ``*_gen``
registry row at every config ``tools/speclint.py``'s sweep visits, on the
four shared fixtures and on the hand-made specs of
``tests/test_analysis.py`` both checkers must give the same rule ids,
severities and loci.  RES001 is the card's own (shared memory, not
VMEM), so it is tested on its own.
"""
import importlib.util
import json
import os

import jax.numpy as jnp
import pytest
import torch

from repro import registry as jregistry
from repro.analysis import checker as jchecker
from repro.analysis import fixtures as jfixtures
from repro.codegen import loopir as jloopir
from repro.codegen import transforms as jtransforms
from repro.core import planner as jplanner
from repro.core import striding as jstriding
from repro_torch import analysis, obs
from repro_torch import registry as tregistry
from repro_torch.analysis import checker, findings as F, fixtures
from repro_torch.codegen import emit as temit
from repro_torch.codegen import transforms as ttransforms
from repro_torch.codegen.loopir import Access, Axis, TraversalSpec, tap
from repro_torch.core import planner as tplanner
from repro_torch.core.planner import Traffic
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels import manual
from repro_torch.kernels.common import placeholder
from repro_torch.kernels.decode_attn import kernel as dkernel
from repro_torch.kernels.doitgen import kernel as dgkernel
from repro_torch.kernels.mxv import kernel as mkernel
from repro_torch.kernels.rmsnorm import kernel as rkernel
from repro_torch.kernels.stream import specs as sspecs
from repro_torch.roofline.hw import H100_HW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = H100_HW.block_smem


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jspeclint():
    return _load("speclint", "tools/speclint.py")


@pytest.fixture(scope="module")
def speclint():
    return _load("torch_speclint", "tools/torch_speclint.py")


def _tcfg(c) -> StridingConfig:
    return StridingConfig(c.stride_unroll, c.portion_unroll, c.lookahead,
                          c.arrangement, c.block_rows)


def _jcfg(c) -> jstriding.StridingConfig:
    return jstriding.StridingConfig(c.stride_unroll, c.portion_unroll,
                                    c.lookahead, c.arrangement,
                                    c.block_rows)


def _shared(fs):
    """(rule, severity, locus) of every finding but RES001 (the one rule
    that differs between the TPU and the card), sorted."""
    return sorted((f.rule, f.severity, f.locus) for f in fs
                  if f.rule != F.RES001)


def _error_rules(fs):
    return sorted({f.rule for f in fs if f.severity == "error"})


# ------------------------------------ the registry sweep, both checkers

_GEN_ROWS = [r.name for r in jregistry.all_specs()
             if r.traversal is not None]


@pytest.mark.parametrize("which", ["default_sizes", "aliased_sizes"])
@pytest.mark.parametrize("name", _GEN_ROWS)
def test_checker_matches_jax_on_every_swept_config(jspeclint, name, which):
    """Every ``*_gen`` row at ``tools/speclint.py``'s sizes and at every
    config its sweep visits: the same findings from both checkers (a
    clean sweep today: none)."""
    jrow, trow = jregistry.get(name), tregistry.get(name)
    sizes = dict(getattr(jrow, which))
    jt = jrow.traversal(sizes, jnp.float32)
    tt = trow.traversal(sizes, torch.float32)
    assert _shared(checker.check(tt)) == _shared(jchecker.check(jt))
    cfgs = jspeclint._candidate_configs(jrow.traffic(sizes, jnp.float32))
    assert 10 <= len(cfgs) <= 30
    for c in cfgs:
        got = checker.check(tt, _tcfg(c), static=False)
        assert _shared(got) == _shared(jchecker.check(jt, c, static=False))
        assert not [f for f in got if f.rule == F.RES001]


# ----------------------------------------------------- shared fixtures

@pytest.mark.parametrize("name", ["race", "redsplit", "halo", "reassoc"])
def test_shared_fixtures_match_jax(name):
    jfx, tfx = jfixtures.build(name), fixtures.build(name)
    assert tfx.rule == jfx.rule
    assert _tcfg(jfx.config) == tfx.config
    for kw in ({}, tfx.check_kwargs):
        got = checker.check(tfx.spec, tfx.config, **kw)
        assert _shared(got) == _shared(jchecker.check(jfx.spec, jfx.config,
                                                      **kw))
        assert tfx.rule in {f.rule for f in got}
    # the config-independent pass alone, as in JAX
    assert _shared(checker.check(tfx.spec)) == _shared(
        jchecker.check(jfx.spec))


def test_num001_severity_split_matches_jax():
    tfx, jfx = fixtures.build("reassoc"), jfixtures.build("reassoc")
    default = checker.check(tfx.spec, tfx.config)
    assert [(f.rule, f.severity) for f in default] == [(F.NUM001,
                                                        "warning")]
    strict = checker.check(tfx.spec, tfx.config, assume_grouped_fold=False)
    assert [(f.rule, f.severity) for f in strict] == [(F.NUM001, "error")]
    grouped = StridingConfig(2, 4)
    assert checker.check(tfx.spec, grouped,
                         assume_grouped_fold=False) == []
    assert _shared(strict) == _shared(jchecker.check(
        jfx.spec, jfx.config, assume_grouped_fold=False))
    assert jchecker.check(jfx.spec, jstriding.StridingConfig(2, 4),
                          assume_grouped_fold=False) == []


# --------------------------------------- hand-made specs of test_analysis

def _pair(name, axes, reads, writes, tbody, jbody, **kw):
    """The same spec in both packages: ``axes``, ``reads``, ``writes`` as
    (name, extent[, kind]), (array, index[, halo]) tuples."""
    def build(mod, body, extra):
        return mod.TraversalSpec(
            name=name, axes=tuple(mod.Axis(*a) for a in axes),
            reads=tuple(mod.Access(*r) for r in reads),
            writes=tuple(mod.Access(*w) for w in writes),
            body=body, **kw, **extra)
    out_t = kw.pop("out_dtype", None)
    textra = {} if out_t is None else {"out_dtype": torch.float32}
    jextra = {} if out_t is None else {"out_dtype": jnp.float32}
    from repro.codegen import loopir as jl
    from repro_torch.codegen import loopir as tl
    return build(tl, tbody, textra), build(jl, jbody, jextra)


def _stride_red(rows):
    return _pair("t_sred", [("i", rows, "reduction"), ("j", 256)],
                 [("x", ("i", "j"))], [("y", ("j",))],
                 lambda env: env["x"].float().sum(dim=0),
                 lambda env: env["x"].astype(jnp.float32).sum(axis=0),
                 out_dtype=True)


def _vec_max(cols, name):
    return _pair(name, [("i", 16), ("j", cols, "reduction")],
                 [("a", ("i", "j"))], [("y", ("i",))],
                 lambda env: env["a"].float().amax(dim=-1),
                 lambda env: env["a"].astype(jnp.float32).max(axis=-1),
                 reduce="max", out_dtype=True)


HAND_CASES = {
    # RACE004: a permuted store into the array it reads; the same store
    # into another array is a plain transpose
    "self_alias": (_pair("t_perm", [("i", 64), ("j", 64)],
                         [("x", ("i", "j"))], [("x", ("j", "i"))],
                         lambda env: env["x"] * 1.0,
                         lambda env: env["x"] * 1.0), None, [F.RACE004]),
    "transpose": (_pair("t_transpose", [("i", 64), ("j", 64)],
                        [("x", ("i", "j"))], [("xt", ("j", "i"))],
                        lambda env: env["x"] * 1.0,
                        lambda env: env["x"] * 1.0), None, []),
    "copy_clean": (_pair("t_copy", [("i", 16), ("j", 256)],
                         [("x", ("i", "j"))], [("y", ("i", "j"))],
                         lambda env: env["x"] * 2.0,
                         lambda env: env["x"] * 2.0), (4, 2), []),
    "bounds003_d4": (_stride_red(6), (4, 1), [F.BOUNDS003]),
    "bounds003_d2": (_stride_red(6), (2, 1), []),
    "bounds004": (_vec_max(100, "t_vmax"), (2, 1), [F.BOUNDS004]),
    "bounds004_aligned": (_vec_max(128, "t_vmax128"), (2, 1), []),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_hand_made_specs_match_jax(case):
    (tspec, jspec), cfg, want = HAND_CASES[case]
    tc = None if cfg is None else StridingConfig(*cfg)
    jc = None if cfg is None else jstriding.StridingConfig(*cfg)
    got = checker.check(tspec, tc)
    assert _error_rules(got) == want
    assert _shared(got) == _shared(jchecker.check(jspec, jc))


def test_bounds001_within_halo_is_clean_in_both():
    halo = ((1, 1), (1, 1))

    def body(env, t):
        x = env["x"]
        return (t(x, halo, -1, 0) + t(x, halo, 1, 0) + t(x, halo, 0, -1)
                + t(x, halo, 0, 1)) * 0.25
    tspec, jspec = _pair("t_stencil", [("i", 30), ("j", 128)],
                         [("x", ("i", "j"), halo)], [("y", ("i", "j"))],
                         lambda env: body(env, tap),
                         lambda env: body(env, jloopir.tap))
    assert checker.check(tspec, StridingConfig(2, 1)) == []
    assert jchecker.check(jspec, jstriding.StridingConfig(2, 1)) == []


def _domain_cases(mod, tr):
    """(label, schedule) pairs of tests/test_analysis.py's domain proof,
    built with one package's ``loopir`` and ``transforms``."""
    n = 1 << 30
    huge = mod.TraversalSpec(
        name="t_huge", axes=(mod.Axis("i", n), mod.Axis("j", 128)),
        reads=(mod.Access("x", ("i", "j")),),
        writes=(mod.Access("y", ("i", "j")),), body=lambda env: env["x"])
    copy = mod.TraversalSpec(
        name="t_copy", axes=(mod.Axis("i", 16), mod.Axis("j", 8)),
        reads=(mod.Access("x", ("i", "j")),),
        writes=(mod.Access("y", ("i", "j")),), body=lambda env: env["x"])
    L, G = tr.LoopAxis, tr.GRID
    j8 = L("j", 8, 1, G)
    return [
        ("huge", tr.Schedule(huge, (L("i", n >> 10, 1 << 10, G),
                                    L("i", 1 << 5, 1 << 5, G),
                                    L("i", 1 << 5, 1, G),
                                    L("j", 128, 1, G)))),
        ("gap", tr.Schedule(copy, (L("i", 8, 2, G), j8))),
        ("overlap", tr.Schedule(copy, (L("i", 2, 8, G), L("i", 16, 1, G),
                                       j8))),
        ("undeclared", tr.Schedule(copy, (L("i", 16, 1, G), j8,
                                          L("k", 2, 1, G)))),
        ("missing", tr.Schedule(copy, (L("i", 16, 1, G),))),
        ("exact", tr.Schedule(copy, (L("i", 2, 8, G), L("i", 8, 1, G), j8))),
    ]


def test_domain_proof_matches_jax_at_2_pow_30_and_on_gaps_and_overlaps():
    from repro_torch.codegen import loopir as tl
    tcases = _domain_cases(tl, ttransforms)
    jcases = _domain_cases(jloopir, jtransforms)
    got = {label: ttransforms.preserves_domain(s) for label, s in tcases}
    assert got == {label: jtransforms.preserves_domain(s)
                   for label, s in jcases}
    assert got == {"huge": True, "gap": False, "overlap": False,
                   "undeclared": False, "missing": False, "exact": True}


# --------------------------------------------------------------- RES001

def test_ring_figure_is_the_launchers_and_fits_a_block():
    """The K4 ring's RES001 figure is ``ring_plan``'s shared memory at
    the stream phase's [8192, 4096] for the copy, triad and fill bodies
    at lookahead 1, 3, 4, in f32 and bf16, all within a block."""
    for dtype in (torch.float32, torch.bfloat16):
        x = placeholder((8192, 4096), dtype)
        for build in (lambda: sspecs.copy_spec(x),
                      lambda: sspecs.triad_spec(x, x, 2.0),
                      lambda: sspecs.init_spec(x.shape, dtype, 1.0)):
            spec = build()
            for la in (1, 3, 4):
                cfg = StridingConfig(2, 1, lookahead=la)
                assert temit.template_of(spec, cfg) == "K4"
                bp = ttransforms.plan_blocks(spec, cfg)
                smem = checker.dynamic_smem(spec, cfg, dtype)
                plan = manual.ring_plan(spec.name, dtype, bp, cfg,
                                        H100_HW.sms)
                assert smem == plan.smem <= BUDGET
                assert checker.check(spec, cfg, dtype=dtype) == []


def test_smem_fixture_flagged_and_refused_by_the_ring_launcher():
    fx = fixtures.build("smem")
    fs = checker.check(fx.spec, fx.config, **fx.check_kwargs)
    assert _error_rules(fs) == [F.RES001]
    assert "shared memory" in fs[0].message
    assert temit.template_of(fx.spec, fx.config) == "K4"
    bp = ttransforms.plan_blocks(fx.spec, fx.config)
    with pytest.raises(ValueError, match="does not fit shared memory"):
        manual.ring_plan(fx.spec.name, torch.float32, bp, fx.config,
                         H100_HW.sms, BUDGET, H100_HW.sm_smem)
    # the narrowest tile's ring, over the budget
    need = manual.ring_smem(*manual.ring_sizes("stream_copy",
                                               torch.float32)[:2],
                            bp.d, bp.bm, 128, 4)
    assert need > BUDGET
    # the same copy at lookahead 2 (K1, no dynamic shared memory) or on
    # 2 streams (a ring that fits) is clean
    assert checker.check(fx.spec, StridingConfig(16, 1)) == []
    assert checker.check(fx.spec, StridingConfig(2, 1, lookahead=4)) == []


def test_row_dot_figure_is_its_staged_x():
    """The K2 row-dot stages x in shared memory up to 64 KiB a block
    (``rowdot_geometry``); the column-dot takes none."""
    for (m, n), dtype, want in (((4096, 4096), torch.float32, 16384),
                                ((4096, 4096), torch.bfloat16, 8192),
                                ((64, 16384), torch.float32, 65536),
                                ((64, 32768), torch.float32, 0)):
        from repro_torch.kernels.mxv import specs as mspecs
        a = placeholder((m, n), dtype)
        spec = mspecs.mxv_spec(a, placeholder((n,), dtype))
        cfg = StridingConfig(2, 2)
        assert checker.dynamic_smem(spec, cfg, dtype) == want
        bp = ttransforms.plan_blocks(spec, cfg)
        assert want == mkernel.rowdot_geometry(bp.rows, bp.cols,
                                               dtype.itemsize, 2, 132).smem
        t = mspecs.mxv_t_spec(a, placeholder((m,), dtype))
        assert checker.dynamic_smem(t, cfg, dtype) == 0


def test_doitgen_figure_by_hand():
    """csrc/doitgen.cu: 4 stages of [tile][40] + [32][72] 16-bit elements
    on the tensor cores, 3 stages of [bk][tile + 4] + [bk][tile] f32 on
    FFMA (bk 8 at tile 128, 16 at 64)."""
    assert dgkernel.smem(64, 2) == 38912
    assert dgkernel.smem(128, 2) == 59392
    assert dgkernel.smem(128, 4) == 24960
    assert dgkernel.smem(64, 4) == 25344
    from repro_torch.kernels.doitgen import specs as dspecs
    for dtype in (torch.float32, torch.bfloat16):
        spec = dspecs.doitgen_spec(placeholder((16, 256, 256), dtype),
                                   placeholder((256, 256), dtype))
        cfg = StridingConfig(4, 1)
        bp = ttransforms.plan_blocks(spec, cfg)
        geo = dgkernel.geometry(bp, 16, 256, 256, dtype.itemsize, (), 132)
        assert checker.dynamic_smem(spec, cfg, dtype) == dgkernel.smem(
            geo.tile, dtype.itemsize) <= BUDGET


def test_decode_figure_by_hand():
    """csrc/decode_attn.cu Cfg::SMEM: bf16 dh 128, g 4 (one 8-head mma
    tile): 1024 + 3 stages x 2 x 16 KiB + 4 x (16 x 12 + 8) x 4; f32 dh
    128, g 16 (two tiles): 2 stages of 32 KiB tiles and the f32 query
    heads."""
    assert dkernel.split_smem(2, 128, 4) == 1024 + 3 * 2 * 16384 + 3200
    assert dkernel.split_smem(4, 128, 16) == (1024 + 2 * 2 * 32768
                                              + 4 * (16 * 20 + 16) * 4
                                              + 16 * 128 * 4)
    from repro_torch.kernels.decode_attn.specs import decode_spec
    spec = decode_spec(8, 128)(placeholder((8, 8192, 1024), torch.bfloat16),
                               placeholder((8, 8192, 1024), torch.bfloat16),
                               placeholder((8, 4096), torch.bfloat16))
    cfg = StridingConfig(4, 1)
    assert checker.dynamic_smem(spec, cfg, torch.bfloat16) == \
        dkernel.split_smem(2, 128, 4) <= BUDGET


def test_rmsnorm_takes_none_but_refuses_a_row_no_cluster_holds():
    from repro_torch.kernels.rmsnorm import specs as rspecs
    cfg = StridingConfig(2, 1)
    ok = rspecs.rmsnorm_spec(placeholder((8, 4096)), placeholder((4096,)))
    assert checker.dynamic_smem(ok, cfg) == 0
    assert checker.check(ok, cfg) == []
    # a cluster of 8 blocks holds 8 x 256 threads x 8 vectors of 16 bytes
    # (256 KiB) of a row in registers: one f32 vector more is refused
    wide = (rkernel.MAX_CLUSTER * rkernel.THREADS * rkernel.HOLD * 4 + 4)
    big = rspecs.rmsnorm_spec(placeholder((8, wide)), placeholder((wide,)))
    bp = ttransforms.plan_blocks(big, cfg)
    with pytest.raises(ValueError, match="cluster"):
        rkernel.geometry(bp.rows, bp.cols, 4, bp.d, 132)
    fs = checker.check(big, cfg)
    assert _error_rules(fs) == [F.RES001]


def test_no_res001_at_any_registry_point(speclint):
    """Every row with a traversal at its default, aliased and bench
    sizes in f32 and bf16, over the conformance points and the planner's
    candidates: nothing found (the points chip_smoke's registry phase
    runs are among them)."""
    report = speclint.sweep()
    assert report["errors"] == 0 and report["findings"] == 0
    assert len(report["kernels"]) == 17
    assert report["configs"] > 3000


# ---------------------------------------------- ensure_valid + telemetry

def test_ensure_valid_raises_and_emits_violations():
    fx = fixtures.build("race")
    with obs.collect() as col:
        with pytest.raises(analysis.AnalysisError) as ei:
            analysis.ensure_valid("t_kernel", fx.spec, fx.config)
    assert "t_kernel" in str(ei.value) and F.RACE001 in str(ei.value)
    evs = col.named("analysis.violation")
    assert evs and all(e.attrs["kernel"] == "t_kernel" for e in evs)
    assert F.RACE001 in {e.attrs["rule"] for e in evs}
    assert set(evs[0].attrs) == {"kernel", "rule", "severity", "spec",
                                 "locus", "message"}


def test_ensure_valid_pass_event_and_no_event_when_disabled():
    spec = sspecs.copy_spec(placeholder((16, 256)))
    with obs.collect() as col:
        assert analysis.ensure_valid("t_kernel", spec,
                                     StridingConfig(4, 1)) == []
    evs = col.named("analysis.pass")
    assert len(evs) == 1 and evs[0].attrs["kernel"] == "t_kernel"
    assert evs[0].attrs["specs"] == ["stream_copy"]


def test_classify_failure_analysis_beats_resource_markers():
    fx = fixtures.build("smem")
    with pytest.raises(analysis.AnalysisError) as ei:
        analysis.ensure_valid("t_kernel", fx.spec, fx.config)
    assert "does not fit shared memory" in str(ei.value)
    assert common.classify_failure(ei.value) == "analysis"


def test_rules_match_the_jax_vocabulary():
    from repro.analysis import findings as jfindings
    assert set(F.RULES) == set(jfindings.RULES)
    assert {k: v[1] for k, v in F.RULES.items()} == {
        k: v[1] for k, v in jfindings.RULES.items()}
    assert "VMEM" not in F.RULES[F.RES001][0]


# ------------------------------------------------- the planner's gate

def test_rank_configs_filters_rejected_candidates():
    """A reduced extent of 6 under a Traffic of 16 rows offers D in {1,
    2, 4, 8, 16}; BOUNDS003 drops every D that does not divide 6, as the
    JAX planner's gate does."""
    from repro_torch.kernels.mxv import specs as mspecs
    # the port's gate also drops what its emitter has no kernel for, so
    # the spec is a stride-axis reduction with one: mxv_t over 6 rows
    tspec = mspecs.mxv_t_spec(placeholder((6, 256)), placeholder((6,)))
    _, jspec = _stride_red(6)
    traffic = Traffic(rows=16, cols=256, read_arrays=1, write_arrays=1)
    with obs.collect() as col:
        ranked = tplanner.rank_configs(traffic, spec=tspec)
    assert {c.stride_unroll for c, _, _ in ranked} <= {1, 2}
    assert col.counter_value("analysis.rejected_candidates") > 0
    for cfg, _, _ in ranked:
        assert _error_rules(checker.check(tspec, cfg)) == []
    jranked = jplanner.rank_configs(
        jplanner.Traffic(rows=16, cols=256, read_arrays=1, write_arrays=1),
        spec=jspec)
    assert ({c.stride_unroll for c, _, _ in ranked}
            == {c.stride_unroll for c, _, _ in jranked} == {1, 2})


def test_rank_configs_all_rejected_raises_valueerror():
    fx = fixtures.build("redsplit")     # RACE003 at every D
    traffic = Traffic(rows=16, cols=256, read_arrays=1, write_arrays=2)
    with obs.collect() as col:
        with pytest.raises(ValueError):
            tplanner.rank_configs(traffic, spec=fx.spec)
    assert col.counter_value("analysis.rejected_candidates") > 0


def test_gate_runs_the_static_rules_once_per_spec(monkeypatch):
    calls = []
    real = checker.check

    def counting(spec, config=None, **kw):
        calls.append((config, kw.get("static", True)))
        return real(spec, config, **kw)
    monkeypatch.setattr(checker, "check", counting)
    spec = sspecs.copy_spec(placeholder((64, 256)))
    tplanner.rank_configs(Traffic(64, 256, torch.float32, 1, 1), spec=spec)
    static = [c for c in calls if c[1]]
    assert static == [(None, True)]
    assert len(calls) > 1 and all(c[0] is not None for c in calls[1:])


# -------------------------------------------------- tools/torch_speclint

def test_speclint_sweep_green(speclint, capsys):
    assert speclint.main([]) == 0
    assert "findings: 0 (0 errors)" in capsys.readouterr().out


@pytest.mark.parametrize("name", fixtures.FIXTURES)
def test_speclint_fixture_exits_1_with_its_rule(speclint, name, capsys):
    assert speclint.main(["--fixture", name]) == 1
    assert fixtures.build(name).rule in capsys.readouterr().out


def test_speclint_unknown_fixture_is_usage_error(speclint):
    assert speclint.main(["--fixture", "vmem"]) == 2


def test_speclint_repo_lint_green(speclint, capsys):
    assert speclint.main(["--repo-lint"]) == 0
    assert "0 jax/repro imports, 0 problem(s)" in capsys.readouterr().out


def test_speclint_repo_lint_finds_a_planted_import_and_name(speclint,
                                                            tmp_path):
    """The lint's rules on a tree of one module that imports jax and
    repro (but not repro_torch) and emits an undocumented name."""
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "m.py").write_text(
        "import jax.numpy\nfrom repro.core import planner\n"
        "import repro_torch.obs as obs\nfrom repro_torch import obs\n"
        "obs.event('not.documented')\n")
    (tmp_path / "README.md").write_text(
        "| port name | layer | payload |\n|---|---|---|\n"
        "| `kernel.{resolve,fallback}` | x | y |\n")
    assert len(speclint._lint_imports(str(tmp_path))) == 2
    assert speclint.documented_names(str(tmp_path / "README.md")) == {
        "kernel.resolve", "kernel.fallback"}
    assert [p.split(": ", 1)[1] for p in
            speclint._lint_obs_names(str(tmp_path))] == [
        "obs name 'not.documented' is not in the README's port "
        "observability table"]


def test_speclint_json_report(speclint, tmp_path):
    out = tmp_path / "report.json"
    assert speclint.main(["--kernel", "mxv_gen", "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["errors"] == 0 and len(rep["kernels"]["mxv_gen"]) == 6
