"""The port's roofline terms (``repro_torch.roofline.analysis``) against
the JAX package's: the analytic model on all 10 archs × 4 shapes, the
parameter counts, and the dot FLOPs that ``count_flops`` counts on the
port against those the JAX HLO parser reads from the compiled prefill.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.lm import CausalLM as JCausalLM
from repro.roofline import analysis as janalysis
from repro.roofline.hw import HwSpec as JHwSpec
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced
from repro_torch.models.lm import build_model, params_from_numpy
from repro_torch.roofline import analysis
from repro_torch.roofline.hw import H100_HW

CELLS = [(a, s) for a in JARCHS for s in JSHAPES]


def test_archs_and_shapes_are_the_jax_packages():
    assert ARCHS == JARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", JARCHS)
def test_parameter_counts_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    assert (cfg.sub_quadratic, cfg.has_decoder) == (jcfg.sub_quadratic,
                                                    jcfg.has_decoder)


@pytest.mark.parametrize("n_chips", [1, 256])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_terms_match_jax(arch, shape, n_chips):
    cfg, jcfg = get_config(arch), jget_config(arch)
    s, js = SHAPES[shape], JSHAPES[shape]
    assert analysis.analytic_memory_bytes(cfg, s, n_chips) == \
        janalysis.analytic_memory_bytes(jcfg, js, n_chips)
    assert analysis.model_flops(cfg, s) == janalysis.model_flops(jcfg, js)
    assert analysis._kv_cache_bytes(cfg, s) == \
        janalysis._kv_cache_bytes(jcfg, js)


def _carried_f32(seed=0):
    jcfg = dataclasses.replace(jreduced(jget_config("yi-9b")),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config("yi-9b")),
                               compute_dtype="float32")
    jmodel = JCausalLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    return jmodel, jparams, build_model(tcfg), params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _dots(cfg, b, s) -> int:
    """The prefill's matrix products by hand: q, k, v, o and the FFN per
    token and layer, the full S×S scores and their product with V (the
    masked half computed, as both packages do), the head at the last
    position."""
    d, dh, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    per_tok = 2 * d * dh * (hq + 2 * hkv) + 2 * hq * dh * d + 2 * 3 * d * f
    attn = 2 * 2 * b * hq * s * s * dh
    return (cfg.n_layers * (b * s * per_tok + attn)
            + 2 * b * d * cfg.padded_vocab)


@pytest.mark.parametrize("b,s", [(4, 8), (2, 16), (1, 33)])
def test_count_flops_of_prefill_equals_jax_parsed_dots(monkeypatch, b, s):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")
    jmodel, jparams, tmodel, tparams = _carried_f32()
    toks = np.random.default_rng(b).integers(
        0, tmodel.cfg.vocab_size, (b, s)).astype(np.int32)
    compiled = jax.jit(jmodel.prefill, static_argnames="max_len").lower(
        jparams, {"tokens": jnp.asarray(toks)}, max_len=s).compile()
    want = janalysis.analyze_hlo(compiled.as_text())["flops"]
    got = analysis.count_flops(tmodel.prefill, tparams,
                               {"tokens": torch.from_numpy(toks)},
                               max_len=s)
    assert got["flops"] == want == _dots(tmodel.cfg, b, s)
    assert got["collective_operand_bytes"] == {}
    assert got["total_wire_bytes"] == 0.0
    assert sum(got["by_op"].values()) == got["flops"]


def test_bmm_formula_counts_both_overloads():
    """``bmm(a, b)`` and ``bmm.dtype(a, b, out_dtype)`` (the f32 scores of
    16-bit operands on the card, which has no CPU kernel): 2·b·m·n·k."""
    assert analysis._bmm_flop((3, 5, 7), (3, 7, 11)) == 2 * 3 * 5 * 11 * 7
    assert analysis._bmm_flop((3, 5, 7), (3, 7, 11), torch.float32,
                              out_shape=(3, 5, 11)) == 2 * 3 * 5 * 11 * 7
    with pytest.raises(ValueError):
        analysis._bmm_flop((3, 5, 7), (3, 8, 11))
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 11)
    assert analysis.count_flops(torch.bmm, a, b)["flops"] == 2 * 3 * 5 * 11 * 7


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", list(JSHAPES))
def test_roofline_terms_use_the_card(shape, compute_dtype):
    """The JAX terms under an HwSpec holding the card's numbers, with the
    card's peak for the compute dtype; no collective on one card."""
    cfg = dataclasses.replace(get_config("yi-9b"),
                              compute_dtype=compute_dtype)
    jcfg = dataclasses.replace(jget_config("yi-9b"),
                               compute_dtype=compute_dtype)
    counts = {"flops": 3.2e14, "total_wire_bytes": 0.0}
    got = analysis.roofline_terms(cfg, SHAPES[shape], 1, counts)
    hw = JHwSpec(name=H100_HW.name,
                 peak_flops_bf16=H100_HW.peak_flops[compute_dtype],
                 hbm_bw=H100_HW.hbm_bw, ici_link_bw=1.0,
                 hbm_bytes=H100_HW.hbm_bytes)
    want = janalysis.roofline_terms(jcfg, JSHAPES[shape], 1, counts, hw=hw)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["collective_s"] == 0.0
    assert got["compute_s"] == 3.2e14 / H100_HW.peak_flops[compute_dtype]


def test_roofline_terms_refuse_several_cards():
    """Fewer than one card is refused.  Several cards are no longer
    refused: their collective term is the counted wire bytes of one
    rank over the card's measured link bandwidth (``H100_HW.link_bw``),
    where the JAX package divides by its TPU's ICI links."""
    cfg = get_config("yi-9b")
    with pytest.raises(ValueError):
        analysis.roofline_terms(cfg, SHAPES["train_4k"], 0,
                                {"flops": 1.0, "total_wire_bytes": 0.0})
    counts = {"flops": 3.2e14, "total_wire_bytes": 5.3e10}
    got = analysis.roofline_terms(cfg, SHAPES["train_4k"], 4, counts)
    assert H100_HW.link_bw > 0
    assert got["collective_s"] == 5.3e10 / H100_HW.link_bw > 0
    assert got["wire_bytes_per_device"] == 5.3e10
    assert got["memory_bytes_per_device"] == \
        analysis.analytic_memory_bytes(cfg, SHAPES["train_4k"], 4)
    hw = JHwSpec(name=H100_HW.name, peak_flops_bf16=H100_HW.peak_flops[
        cfg.compute_dtype], hbm_bw=H100_HW.hbm_bw,
        ici_link_bw=H100_HW.link_bw, hbm_bytes=H100_HW.hbm_bytes)
    want = janalysis.roofline_terms(jget_config("yi-9b"),
                                    JSHAPES["train_4k"], 4, counts, hw=hw,
                                    n_links=1)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_collective_term_by_axis():
    """``collective_s_by_axis`` splits ``roofline_terms``' collective term
    by the mesh axis each recorded byte went over: ZeRO-3's over data,
    tensor parallelism's over model; the parts sum to the term."""
    from repro_torch.sharding import collectives
    log = [collectives.Record("all-gather", 8, 2, 4.0e9, "bfloat16", "data"),
           collectives.Record("reduce-scatter", 8, 2, 3.0e9, "float32",
                              "model"),
           collectives.Record("all-reduce", 8, 2, 1.0e9, "float32", "model")]
    counts = dict(collectives.summarize(log), flops=3.2e14)
    cfg = get_config("yi-9b")
    terms = analysis.roofline_terms(cfg, SHAPES["train_4k"], 4, counts)
    by_axis = analysis.collective_s_by_axis(counts)
    assert by_axis == {"data": 4.0e9 / H100_HW.link_bw,
                       "model": 4.0e9 / H100_HW.link_bw}
    assert sum(by_axis.values()) == pytest.approx(terms["collective_s"],
                                                  rel=1e-12)
