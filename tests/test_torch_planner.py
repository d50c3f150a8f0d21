"""The port's planner, layout rules and stream model held against the JAX
package's (``repro.core.{planner,layout,dma_model}``) on the same
inputs, with the TPU's constants given to the port from this file (the
port's package states no TPU number); then the planner's edge cases
(the counterparts of ``tests/test_planner_configs.py``) and the card's
own model against the port's emitter."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import registry as jregistry
from repro.core import dma_model as jdma
from repro.core import layout as jlayout
from repro.core import planner as jplanner
from repro.core import striding as jstriding
from repro_torch import obs
from repro_torch import registry as tregistry
from repro_torch.codegen import emit as temit
from repro_torch.core import dma_model as tdma
from repro_torch.core import layout as tlayout
from repro_torch.core import planner as tplanner
from repro_torch.core import striding as tstriding
from repro_torch.core.planner import Traffic

# The TPU v5e's constants, as the JAX package states them
# (src/repro/core/layout.py, src/repro/core/dma_model.py): the port is
# given them here and must then rank as the JAX package does.
TPU_LAYOUT = tlayout.Layout(lane=128, unit_rows={4: 8, 2: 16, 1: 32},
                            alias_bits=12)
TPU_MODEL = tdma.StreamModel(hbm_bw=819e9, latency=2e-6, stream_bw=205e9,
                             n_streams=16, descriptor_overhead=0.3e-6,
                             layout=TPU_LAYOUT)
VMEM = 8 * 1024 * 1024          # the JAX planner's default VMEM budget
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
BLOCKS = [(0,), (0, 4, 16)]     # the planner's default; the autotuner's
RTOL = 1e-12


def test_tpu_constants_of_this_file_are_the_jax_packages():
    j = jdma.TPU_V5E
    assert (TPU_MODEL.hbm_bw, TPU_MODEL.latency, TPU_MODEL.stream_bw,
            TPU_MODEL.n_streams, TPU_MODEL.descriptor_overhead) == (
        j.hbm_bw, j.dma_latency, j.engine_bw, j.n_engines,
        j.descriptor_overhead)
    assert TPU_LAYOUT.lane == jlayout.LANE
    assert dict(TPU_LAYOUT.unit_rows) == jlayout._SUBLANE
    assert TPU_LAYOUT.alias_bits == jlayout.ALIAS_BITS
    assert tplanner.DEFAULT_BUDGET != VMEM   # the port budgets the card's
    assert jplanner.DEFAULT_VMEM_BUDGET == VMEM


# ------------------------------------------------------------ layout

SPACINGS = [0, 1, 512, 4095, 4096, 6144, 8192, 3 * 4096, 2 ** 14,
            2 ** 20, 2 ** 20 + 512, 2 ** 26, 2 ** 31, 2 ** 31 + 128]


@pytest.mark.parametrize("spacing", SPACINGS)
def test_collides_and_aliasing_exponent_match_jax(spacing):
    assert tlayout.aliasing_exponent(spacing) == \
        jlayout.aliasing_exponent(spacing)
    assert tlayout.collides(spacing, TPU_LAYOUT) == jlayout.collides(spacing)
    assert not tlayout.collides(spacing)     # the card: nothing collides


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("rows", [1, 7, 8, 48, 64, 96, 1000, 4096, 16384])
def test_conflict_free_cols_match_jax(jdt, tdt, rows):
    for cols in (1, 100, 128, 256, 1000, 1024, 4096, 16384):
        for d in (1, 2, 3, 4, 8, 16):
            for pad in (0, 1, 8):
                assert tlayout.conflict_free_cols(
                    rows, cols, d, tdt, TPU_LAYOUT, max_pad_tiles=pad) == \
                    jlayout.conflict_free_cols(rows, cols, d, jdt,
                                               max_pad_tiles=pad)


@pytest.mark.parametrize("d", [1, 2, 4, 8, 16])
def test_stream_stagger_matches_jax(d):
    for spacing in SPACINGS:
        for block in (128, 512, 4096):
            assert tlayout.stream_stagger(d, spacing, block, TPU_LAYOUT) == \
                jlayout.stream_stagger(d, spacing, block)


@pytest.mark.parametrize("jdt,tdt", DTYPES + [(jnp.int8, torch.int8)])
def test_unit_tile_pad_and_buffers_match_jax(jdt, tdt):
    assert tlayout.unit_tile(tdt, TPU_LAYOUT) == jlayout.sublane_tile(jdt)
    for n in (0, 1, 127, 128, 129, 1000, 4096):
        assert tlayout.pad_to_lane(n, TPU_LAYOUT) == jlayout.pad_to_lane(n)
    for shape in ((8, 128), (16, 256), (3, 5, 7)):
        for nb in (1, 2, 3):
            assert tlayout.buffer_bytes(shape, tdt, nb) == \
                jlayout.vmem_bytes(shape, jdt, nb)
    # the card's unit: a warp of 16-byte lanes, 512 bytes in every type
    rows, lane = tlayout.unit_tile(tdt)
    assert rows * lane * tlayout.itemsize(tdt) == 512


# ------------------------------------------------------- stream model

@pytest.mark.parametrize("d", [1, 2, 3, 4, 8, 16, 32])
def test_stream_model_matches_tpu_dma_model(d):
    j = jdma.TpuDmaModel()
    for p in (1, 2, 4, 8):
        for la in (1, 2, 3, 4):
            cfg = tstriding.StridingConfig(d, p, lookahead=la)
            jcfg = jstriding.StridingConfig(d, p, lookahead=la)
            for bb in (512, 4096, 16384, 65536):
                assert TPU_MODEL.stream_bandwidth(bb * p, la) == \
                    j.stream_bandwidth(bb * p, la)
                for spacing in (None, 4096, 4096 + 512, 2 ** 20):
                    for nw in (0, d, 3 * d):
                        assert TPU_MODEL.throughput(cfg, bb, spacing, nw) \
                            == j.throughput(jcfg, bb, spacing, nw)


@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 24, 32])
def test_cpu_prefetch_model_is_the_jax_one(d):
    t, j = tdma.COFFEE_LAKE, jdma.COFFEE_LAKE
    for on in (True, False):
        assert t.lines_in_flight(d, on) == j.lines_in_flight(d, on)
        assert t.stall_cycles_per_line(d, prefetch_on=on) == \
            j.stall_cycles_per_line(d, prefetch_on=on)
        for lvl in ("l1", "l2", "l3"):
            assert t.hit_ratio(d, lvl, on) == j.hit_ratio(d, lvl, on)
        for aliased in (True, False):
            for wf in (0.0, 0.5, 1.0):
                assert t.throughput(d, on, aliased, wf) == \
                    j.throughput(d, on, aliased, wf)


def test_default_model_takes_its_descriptor_term_as_an_argument():
    assert tdma.default_model() == tdma.H100_STREAMS
    m = tdma.default_model(495.1e-9)
    assert m.descriptor_overhead == pytest.approx(495.1e-9)
    assert dataclasses.replace(m, descriptor_overhead=0.0) == \
        dataclasses.replace(tdma.H100_STREAMS, descriptor_overhead=0.0)


# ------------------------------------------- ranking against the JAX one

def _key(c):
    """A config of either package as a tuple of its fields."""
    return (c.stride_unroll, c.portion_unroll, c.lookahead, c.arrangement,
            c.block_rows)


def _same_ranking(jr, tr):
    assert [_key(c) for c, _, _ in jr] == [_key(c) for c, _, _ in tr]
    for (_, jb, jc), (_, tb, tc) in zip(jr, tr):
        assert tb == pytest.approx(jb, rel=RTOL)
        assert tc == jc


def _traffic_fields(t):
    return (t.rows, t.cols, t.read_arrays, t.write_arrays, t.rw_arrays,
            t.resident_bytes)


def _signatures():
    """(label, JAX Traffic, port Traffic): every registry row's at its
    bench problem in f32 and bf16, then the aliased and ragged extents of
    tests/test_planner_configs.py."""
    out = []
    for row in jregistry.all_specs():
        trow = tregistry.get(row.name)
        for jdt, tdt in DTYPES:
            sizes = dict(row.bench_problem)
            out.append((f"{row.name}-{tdt}", row.traffic(sizes, jdt),
                        trow.traffic(sizes, tdt)))
    for rows, cols in ((7, 256), (64, 256), (64, 128), (4096, 4096),
                       (1000, 1000), (30, 130)):
        for jdt, tdt in DTYPES:
            out.append((f"extent-{rows}x{cols}-{tdt}",
                        jplanner.Traffic(rows, cols, jdt),
                        Traffic(rows, cols, tdt)))
    return out


SIGNATURES = _signatures()


@pytest.mark.parametrize("label,jt,tt", SIGNATURES,
                         ids=[s[0] for s in SIGNATURES])
def test_rank_configs_and_plan_match_jax(monkeypatch, label, jt, tt):
    monkeypatch.delenv("REPRO_DMA_DESCRIPTOR_NS", raising=False)
    assert _traffic_fields(tt) == _traffic_fields(jt)
    assert tlayout.itemsize(tt.dtype) == jnp.dtype(jt.dtype).itemsize
    assert tplanner.traffic_bytes(tt) == jplanner.traffic_bytes(jt)
    for blocks in BLOCKS:
        jr = jplanner.rank_configs(jt, block_rows_candidates=blocks)
        tr = tplanner.rank_configs(tt, model=TPU_MODEL, budget=VMEM,
                                   block_rows_candidates=blocks)
        _same_ranking(jr, tr)
    jp = jplanner.plan(jt)
    tp = tplanner.plan(tt, model=TPU_MODEL, budget=VMEM)
    assert (_key(tp.config), tp.padded_cols, tp.buffer_bytes) == (
        _key(jp.config), jp.padded_cols, jp.vmem_bytes)
    assert tp.predicted_bw == pytest.approx(jp.predicted_bw, rel=RTOL)


# Candidates the JAX checker's gate and the port's emitter gate keep
# differently, by (row, sizes label): rmsnorm_gen at its bench problem
# (4096 rows of 4096) loses D = 16 to the JAX checker's RES001 (the TPU
# emitter's VMEM blocks: 16 streams of a full 4096-wide row block,
# double-buffered, reach the 8 MiB budget); the port's rmsnorm kernel
# holds a row in registers in every geometry and takes any D, so its
# emitter keeps them.
GATE_DIFFERENCES = {
    ("rmsnorm_gen", "bench"): {(16, 1), (16, 2)},
}


@pytest.mark.parametrize("which", ["default", "bench"])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_gated_ranking_matches_the_jax_checker_but_for_listed_candidates(
        monkeypatch, which, jdt, tdt):
    monkeypatch.delenv("REPRO_DMA_DESCRIPTOR_NS", raising=False)
    for row in jregistry.all_specs():
        if row.traversal is None:
            continue
        trow = tregistry.get(row.name)
        sizes = dict(row.default_sizes if which == "default"
                     else row.bench_problem)
        jr = jplanner.rank_configs(row.traffic(sizes, jdt),
                                   spec=row.traversal(sizes, jdt))
        tr = tplanner.rank_configs(trow.traffic(sizes, tdt),
                                   model=TPU_MODEL, budget=VMEM,
                                   spec=trow.traversal(sizes, tdt))
        js = {(c.stride_unroll, c.portion_unroll) for c, _, _ in jr}
        ts = {(c.stride_unroll, c.portion_unroll) for c, _, _ in tr}
        assert ts - js == GATE_DIFFERENCES.get((row.name, which), set())
        assert not js - ts
        kept = [t for t in tr if (t[0].stride_unroll, t[0].portion_unroll)
                in js]
        _same_ranking(jr, kept)


# ------------------------------------- tests/test_planner_configs.py

class _FlatModel:
    """Constant-bandwidth model: every config ties, exposing tie-breaks."""

    layout = tlayout.H100_LAYOUT

    def throughput(self, config, block_bytes, spacing_bytes=None,
                   n_write_streams=0):
        return 1.0


def test_non_divisible_extent_restricts_stride_unrolls():
    ranked = tplanner.rank_configs(Traffic(rows=7, cols=256))
    assert {cfg.stride_unroll for cfg, _, _ in ranked} <= {1, 7}
    for cfg, _, _ in ranked:
        assert 7 % cfg.stride_unroll == 0


@pytest.mark.parametrize("traffic,budget", [
    (Traffic(rows=64, cols=256), 1),
    # the resident operands count against the budget: 10 MiB > 8 MiB
    (Traffic(rows=64, cols=256, resident_bytes=10 * 2 ** 20), 8 * 2 ** 20),
    # and against the card's per-block shared memory
    (Traffic(rows=64, cols=256, resident_bytes=tplanner.DEFAULT_BUDGET),
     tplanner.DEFAULT_BUDGET),
])
def test_budget_exhaustion_raises(traffic, budget):
    with pytest.raises(ValueError, match="no feasible striding config"):
        tplanner.rank_configs(traffic, budget=budget)


def test_tie_break_prefers_smaller_d_then_smaller_p():
    ranked = tplanner.rank_configs(Traffic(rows=64, cols=256),
                                   model=_FlatModel())
    assert ranked[0][0] == tstriding.SINGLE_STRIDED.replace(lookahead=2)
    order = [(c.stride_unroll, c.portion_unroll) for c, _, _ in ranked]
    assert order == sorted(order)


@pytest.mark.parametrize("lay,want", [(TPU_LAYOUT, 384),
                                      (tlayout.H100_LAYOUT, 256)])
def test_aliased_pow2_spacing_pads_columns_when_possible(lay, want):
    # rows=64, d=4 → 16-row segments; 256 f32 cols = 16 KiB spacing:
    # under the TPU's rules one lane tile of padding de-aliases it; on
    # the card no spacing collides, so nothing is padded
    cols, aliased = tlayout.conflict_free_cols(64, 256, 4, torch.float32,
                                               lay)
    assert not aliased and cols == want
    assert not tlayout.collides((64 // 4) * cols * 4, lay)


def test_unpaddable_alias_triggers_column_stagger():
    cols, aliased = tlayout.conflict_free_cols(64, 128, 8, torch.float32,
                                               TPU_LAYOUT, max_pad_tiles=1)
    assert aliased and cols == 128
    spacing = (64 // 8) * cols * 4
    stag = tlayout.stream_stagger(8, spacing, 512, TPU_LAYOUT)
    assert stag > 0
    assert not tlayout.collides(spacing + stag * 512, TPU_LAYOUT)


@pytest.mark.parametrize("model", [TPU_MODEL, None])
def test_rank_configs_scores_staggered_spacing_for_aliased_layouts(model):
    ranked = tplanner.rank_configs(Traffic(rows=64, cols=128), model=model,
                                   budget=VMEM)
    assert 8 in {cfg.stride_unroll for cfg, _, _ in ranked}


def test_descriptor_overhead_ranks_block_rows():
    """A dominant per-step descriptor term (``default_model``'s argument)
    makes every (D, P) point's block candidates rank by size, and the
    gain of big blocks grows with it."""
    t = Traffic(rows=4096, cols=4096)

    def ranked_bw(seconds):
        out = tplanner.rank_configs(t, model=tdma.default_model(seconds),
                                    block_rows_candidates=(1, 32))
        return {(c.stride_unroll, c.portion_unroll, c.block_rows): bw
                for c, bw, _ in out}

    heavy, light = ranked_bw(50e-6), ranked_bw(0.0)
    for (d, p, bm), bw in heavy.items():
        if bm == 32:
            assert bw > heavy[(d, p, 1)]
    gain_heavy = heavy[(2, 1, 32)] / heavy[(2, 1, 1)]
    gain_light = light[(2, 1, 32)] / light[(2, 1, 1)]
    assert gain_heavy > gain_light > 1.0


def test_plan_returns_best_and_full_ranking():
    p = tplanner.plan(Traffic(rows=64, cols=256))
    assert p.config == p.ranked[0][0]
    bws = [bw for _, bw in p.ranked]
    assert bws == sorted(bws, reverse=True)
    assert p.buffer_bytes > 0


# --------------------------------------------- the card's own model

def test_card_model_plans_two_streams_of_two_portions():
    """The fitted H100 model: one stream stays under the card's rate
    (``stream_bw`` < ``hbm_bw``), two streams of one portion too, two of
    two reach it; so the stream kernels' Traffic plans D = 2, P = 2."""
    m = tdma.H100_STREAMS
    assert m.stream_bw < m.hbm_bw
    assert tdma.predict(m, 1, 8, 4) < m.hbm_bw
    assert tdma.predict(m, 2, 1, 4) < m.hbm_bw
    assert tdma.predict(m, 2, 2, 4) == m.hbm_bw
    for t in (Traffic(8192, 4096, torch.float32, 1, 1),
              Traffic(8192, 4096, torch.bfloat16, 1, 0),
              Traffic(16384, 16384, torch.float32, 2, 0),
              Traffic(4096, 512, torch.bfloat16, 2, 0),
              Traffic(512000, 512, torch.float32, 4, 3)):
        assert tplanner.plan(t).config == tstriding.StridingConfig(2, 2)


def _row_specs(row, sizes, dtype):
    if row.traversal is None:
        return ()
    trav = row.traversal(sizes, dtype)
    return trav if isinstance(trav, tuple) else (trav,)


@pytest.mark.parametrize("which", ["default", "aliased", "bench"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_model_ranks_nothing_the_emitter_refuses(which, dtype):
    """Every config the H100 model ranks for a row (the autotuner's block
    candidates included) passes the port's emitter on the row's own
    traversal: no candidate needs the gate.  One signature ranks nothing:
    doitgen's at its bench problem, whose resident C4 (256 x 256 f32,
    256 KiB) exceeds one block's shared memory, so the planner finds no
    feasible config and the op keeps its static default."""
    infeasible = set()
    for row in tregistry.all_specs():
        sizes = dict({"default": row.default_sizes,
                      "aliased": row.aliased_sizes,
                      "bench": row.bench_problem}[which])
        specs = _row_specs(row, sizes, dtype)
        try:
            ranked = tplanner.rank_configs(row.traffic(sizes, dtype),
                                           block_rows_candidates=(0, 4, 16))
        except ValueError:
            infeasible.add(row.name)
            continue
        for cfg, _, _ in ranked:
            for spec in specs:
                temit.check_config(spec, cfg)
    # doitgen's wrapper counts C4 at 4 bytes an element, as the JAX one;
    # doitgen_gen's Traffic (the spec's, ``loopir.traffic_of``) at the
    # operands' itemsize, so in bf16 it fits
    want = {"doitgen"} | ({"doitgen_gen"} if dtype == torch.float32
                          else set())
    assert infeasible == (want if which == "bench" else set())


def test_gate_drops_what_the_emitter_refuses_and_counts_it():
    """A stride-axis reduction over 6 rows refuses every D that does not
    divide them; a Traffic of 8 rows offers D = 4 and 8, which the gate
    drops, ticking ``analysis.rejected_candidates`` once each."""
    from repro_torch.kernels.common import placeholder
    from repro_torch.kernels.mxv import specs as mspecs
    spec = mspecs.mxv_t_spec(placeholder((6, 256)), placeholder((6,)))
    with pytest.raises(ValueError, match="stride-axis reduction"):
        temit.check_config(spec, tstriding.StridingConfig(4, 1))
    t = Traffic(rows=8, cols=256, read_arrays=2)
    free = tplanner.rank_configs(t)
    with obs.collect() as col:
        gated = tplanner.rank_configs(t, spec=spec)
    dropped = [c for c, _, _ in free if 6 % c.stride_unroll]
    assert dropped and all(6 % c.stride_unroll == 0 for c, _, _ in gated)
    assert col.counters()["analysis.rejected_candidates"] == len(dropped)


def test_valid_stride_unrolls_and_divisors_match_jax():
    for n in (1, 2, 7, 12, 48, 64, 96, 1000, 4096, 512000):
        assert tstriding.divisors(n) == jstriding.divisors(n)
        for m in (1, 4, 16, 32):
            assert tstriding.valid_stride_unrolls(n, m) == \
                jstriding.valid_stride_unrolls(n, m)
    with pytest.raises(ValueError):
        tstriding.divisors(0)
