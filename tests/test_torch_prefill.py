"""The port's single-pass prefill (``CausalLM.prefill``,
``blocks.stack_prefill``) against the JAX package's on carried weights,
and against the port's own full forward through a decode step.

Weights: the JAX ``CausalLM.init`` tree as numpy, loaded with
``params_from_numpy``; tokens from seeded numpy.  The JAX path runs in
``ref`` mode, as its own tests run on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import attention as jattention
from repro.models.lm import CausalLM as JCausalLM
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention as tattention
from repro_torch.models.lm import build_model, params_from_numpy


@pytest.fixture(autouse=True)
def _jax_ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


def _carried(arch, compute_dtype, seed=0):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype=compute_dtype)
    jmodel = JCausalLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, build_model(tcfg), params_from_numpy(
        tcfg, tree, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# the decode tests' tolerances (tests/test_torch_model.py): bf16
# activations round at other points in the two packages
@pytest.mark.parametrize("compute_dtype,tol",
                         [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("arch", ["yi-9b", "chatglm3-6b"])
def test_prefill_matches_jax(arch, compute_dtype, tol):
    """Last-position logits and every layer's K/V cache, zeros past S."""
    jmodel, jparams, tmodel, tparams = _carried(arch, compute_dtype)
    cfg = tmodel.cfg
    b, s, max_len = 3, 11, 16
    toks = _tokens(cfg, b, s, seed=1)
    jlogits, jcache = jax.jit(jmodel.prefill, static_argnames="max_len")(
        jparams, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    tlogits, tcache = tmodel.prefill(tparams,
                                     {"tokens": torch.from_numpy(toks)},
                                     max_len=max_len)
    assert tlogits.shape == (b, cfg.vocab_size)
    assert tlogits.dtype == cfg.cdtype()
    np.testing.assert_allclose(tlogits.float().numpy(),
                               np.asarray(jlogits, np.float32),
                               rtol=tol, atol=tol)
    assert len(tcache) == cfg.n_layers
    for i, layer in enumerate(tcache):
        for name in ("k", "v"):
            got = layer[name]
            assert got.shape == (b, max_len, cfg.n_kv_heads, cfg.head_dim)
            assert got.dtype == cfg.cdtype()
            want = np.asarray(jcache["pos0"]["attn"][name][i], np.float32)
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=tol, atol=tol)
            assert not got[:, s:].any()


@pytest.mark.parametrize("arch", ["yi-9b", "mistral-large-123b",
                                  "chatglm3-6b", "starcoder2-7b"])
def test_prefill_then_decode_matches_full_forward(arch):
    """The serving invariant, as ``tests/test_serve_consistency.py``
    holds the JAX package to it: prefill's logits are the full forward's
    at position S-1, and one decode step from its cache gives the full
    forward's at S (f32 compute)."""
    _, _, model, params = _carried(arch, "float32", seed=2)
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(model.cfg, b, s + 1, seed=2))
    full = model.logits(params, {"tokens": toks})
    logits, cache = model.prefill(params, {"tokens": toks[:, :s]},
                                  max_len=s + 4)
    np.testing.assert_allclose(logits.numpy(), full[:, s - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    with torch.inference_mode():
        step, _ = model.decode_step(params, toks[:, s:s + 1], cache,
                                    torch.tensor(s))
    np.testing.assert_allclose(step.numpy(), full[:, s].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_chunked_attention_equals_unchunked(monkeypatch, compute_dtype):
    """A score budget small enough to cut the query axis into chunks
    changes memory, not values: the prefill is the same bit for bit."""
    _, _, model, params = _carried("yi-9b", compute_dtype, seed=3)
    cfg = model.cfg
    b, s = 2, 512
    toks = {"tokens": torch.from_numpy(_tokens(cfg, b, s, seed=3))}
    whole = model.prefill(params, toks, max_len=s)
    # 128 query rows of f32 scores a chunk
    budget = 4 * b * cfg.n_heads * s * 128
    assert tattention._pick_q_chunk(b, cfg.n_heads, s, s) == s
    monkeypatch.setattr(tattention, "SCORE_BUDGET_BYTES", budget)
    assert tattention._pick_q_chunk(b, cfg.n_heads, s, s) == 128
    chunked = model.prefill(params, toks, max_len=s)
    assert torch.equal(chunked[0], whole[0])
    for cw, cc in zip(whole[1], chunked[1]):
        assert torch.equal(cw["k"], cc["k"]) and torch.equal(cw["v"],
                                                             cc["v"])


@pytest.mark.parametrize("b,s,jax_qc,qc", [
    (2, 4096, 4096, 4096),       # the train phase: one chunk, unchanged
    (4, 4032, 4032, 4032),       # chip_smoke's prefill: one chunk
    (4, 64, 64, 64),             # the short prompt it is held against
    (1, 32768, 8192, 2048),      # prefill_32k at B=1: 34 GB -> 8.6 GB
])
def test_q_chunk_at_the_card_shapes(b, s, jax_qc, qc):
    """Yi-9B's 32 heads: the JAX budget (2**33 elements, a TPU mesh's)
    and the port's (an eighth of the card's memory in f32 scores)."""
    assert jattention._pick_q_chunk(b, 32, s, s) == jax_qc
    assert tattention._pick_q_chunk(b, 32, s, s) == qc
    assert 4 * b * 32 * qc * s <= tattention.SCORE_BUDGET_BYTES


def test_prefill_runs_without_gradients_and_in_ref_mode():
    """Under ``torch.no_grad()`` even with trainable weights; ``mode``
    reaches every rms_norm (on the CPU both modes run the plain
    version, so the results are equal)."""
    cfg = reduced(get_config("yi-9b"))
    model = build_model(cfg)
    params = model.init(seed=4, device="cpu", trainable=True)
    toks = {"tokens": torch.from_numpy(_tokens(cfg, 2, 8, seed=4))}
    logits, cache = model.prefill(params, toks)
    assert not logits.requires_grad
    assert cache[0]["k"].shape[1] == cfg.max_seq
    ref, _ = model.prefill(params, toks, mode="ref")
    assert torch.equal(ref, logits)
