"""The port's Mamba-2 block (``repro_torch.models.mamba2``) against the
JAX package's ``repro.models.mamba2`` on the same numpy inputs and
carried weights: the causal conv, the chunked SSD scan (chunk 8, chunk 1
and an odd length), the forward pass with its decode state, and the
recurrent decode step.

Weights: the JAX ``init_mamba`` tree as numpy, loaded into
``mamba2.Mamba``; activations from seeded numpy.  Reduced mamba2 config
(d_model 64, 8 heads of 16, d_state 16, chunk 8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import mamba2 as jmamba
from repro_torch.configs import get_config, reduced
from repro_torch.models import mamba2

ARCH = "mamba2-2.7b"
KEYS = ("in_proj", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "norm",
        "out_proj")
# bf16: the packages round at other points (the conv's taps, the gated
# product, the norm), a few bf16 ulps of the output scale
BF16_TOL = 5e-2


@pytest.fixture(autouse=True)
def _jax_ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jreduced(jget_config(ARCH)),
                                compute_dtype=dtype),
            dataclasses.replace(reduced(get_config(ARCH)),
                                compute_dtype=dtype))


def _carried(jcfg, tcfg, seed=0):
    jp = jmamba.init_mamba(jax.random.PRNGKey(seed), jcfg)
    dt = tcfg.cdtype()
    return jp, mamba2.Mamba(*(
        torch.tensor(np.asarray(jp[k])).to(
            torch.float32 if k in mamba2.F32_PARAMS else dt) for k in KEYS))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            .astype(np.float32) * scale)


def _both(a, dtype):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _tol(dtype, f32=2e-4):
    return BF16_TOL if dtype == "bfloat16" else f32


def test_init_shapes_and_f32_leaves_match_jax():
    """Shapes as the JAX init's; dt_bias, a_log, d_skip f32 whatever the
    weights' dtype, the JAX package's values of a_log and d_skip, and
    softplus(dt_bias) within [dt_min, dt_max]."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), jcfg)
    p = mamba2.init_mamba(torch.Generator().manual_seed(0), tcfg,
                          torch.bfloat16, "cpu")
    for k in KEYS:
        got = getattr(p, k)
        assert tuple(got.shape) == jp[k].shape, k
        want = torch.float32 if k in mamba2.F32_PARAMS else torch.bfloat16
        assert got.dtype == want, k
    np.testing.assert_allclose(p.a_log.numpy(), np.asarray(jp["a_log"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(p.d_skip.numpy(), np.asarray(jp["d_skip"]))
    sp = torch.nn.functional.softplus(p.dt_bias)
    s = tcfg.ssm
    assert bool((sp >= s.dt_min * 0.999).all() and
                (sp <= s.dt_max * 1.001).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [1, 2, 13])
def test_causal_conv_matches_jax(dtype, length):
    _, tcfg = _cfgs(dtype)
    c = 96
    jx, tx = _both(_rand((2, length, c), 1), dtype)
    jw, tw = _both(_rand((tcfg.ssm.d_conv, c), 2, 0.3), dtype)
    jb, tb = _both(_rand((c,), 3, 0.1), dtype)
    got = mamba2._causal_conv(tx, tw, tb)
    want = jmamba._causal_conv(jx, jw, jb)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=_tol(dtype, 1e-6),
                               atol=_tol(dtype, 1e-6))


def _ssd_inputs(b, length, h, p, g, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, length, h)))).astype(
        np.float32) * 0.1
    a = -np.arange(1, h + 1, dtype=np.float32)
    bm = rng.standard_normal((b, length, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, length, g, n)).astype(np.float32)
    jin = (*_both(x, dtype)[:1], jnp.asarray(dt), jnp.asarray(a),
           _both(bm, dtype)[0], _both(cm, dtype)[0])
    tin = (_both(x, dtype)[1], torch.from_numpy(dt), torch.from_numpy(a),
           _both(bm, dtype)[1], _both(cm, dtype)[1])
    return jin, tin


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length,chunk,groups", [
    (16, 8, 1),          # two chunks of 8, the state passed between them
    (16, 1, 1),          # chunk 1: the recurrence, step by step
    (13, 1, 1),          # an odd length (the chunk rule's gcd gives 1)
    (24, 8, 2),          # two groups of B, C shared by 4 heads each
    (8, 8, 1),           # one chunk
])
def test_ssd_chunked_matches_jax(dtype, length, chunk, groups):
    """y and the final state, both f32; bf16 operands give f32 products
    in both packages (``preferred_element_type`` in JAX, widened first
    here), so the limit is f32's."""
    jin, tin = _ssd_inputs(2, length, 8, 16, groups, 16, dtype, seed=4)
    jy, jh = jmamba._ssd_chunked(*jin, chunk)
    ty, th = mamba2._ssd_chunked(*tin, chunk)
    assert ty.dtype == th.dtype == torch.float32
    assert ty.shape == (2, length, 8, 16) and th.shape == (2, 8, 16, 16)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4,
                               atol=2e-4)


def test_ssd_chunk_size_does_not_change_the_result():
    """The same sequence in chunks of 8, 4, 2 and 1 (the chunk changes the
    sum order only)."""
    _, tin = _ssd_inputs(1, 16, 8, 16, 1, 16, "float32", seed=5)
    y8, h8 = mamba2._ssd_chunked(*tin, 8)
    for chunk in (4, 2, 1):
        y, h = mamba2._ssd_chunked(*tin, chunk)
        np.testing.assert_allclose(y.numpy(), y8.numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(h.numpy(), h8.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("length,chunk", [
    (1, 1), (7, 7), (8, 8), (16, 8), (12, 4), (13, 1), (17, 1), (1024, 256),
    (1025, 1), (4096, 256), (1000, 8), (255, 255), (256, 256)])
def test_chunk_rule_is_the_jax_package_s(length, chunk):
    """``min(chunk, L)``, then ``gcd(L, chunk)`` where L is not a multiple
    (at the full config's chunk 256 where L is 255 or more)."""
    cfg = reduced(get_config(ARCH)) if length < 255 else get_config(ARCH)
    assert mamba2.chunk_size(cfg, length) == chunk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [16, 13, 2])
def test_mamba_forward_with_state_matches_jax(dtype, length):
    """The output, and the decode state: the last d_conv - 1 conv inputs
    (zeros on the left where L is shorter: L = 2) and the SSM state."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _carried(jcfg, tcfg)
    jx, tx = _both(_rand((2, length, tcfg.d_model), 6), dtype)
    jout, jst = jmamba.mamba_forward(jp, jx, jcfg, return_state=True)
    tout, tst = mamba2.mamba_forward(tp, tx, tcfg, return_state=True)
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=tol, atol=tol)
    assert tst["conv"].dtype == tx.dtype and tst["ssm"].dtype == torch.float32
    np.testing.assert_allclose(_np(tst["conv"]), _np(jst["conv"]), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_np(tst["ssm"]), _np(jst["ssm"]),
                               rtol=_tol(dtype), atol=_tol(dtype))
    if length < tcfg.ssm.d_conv - 1:
        assert not tst["conv"][:, :tcfg.ssm.d_conv - 1 - length].any()
    np.testing.assert_array_equal(
        _np(mamba2.mamba_forward(tp, tx, tcfg)), _np(tout))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_jax(dtype):
    """Three recurrent steps from a forward pass's state, output and state
    each step; the given state is left as it was."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _carried(jcfg, tcfg, seed=1)
    jx, tx = _both(_rand((3, 5, tcfg.d_model), 7), dtype)
    _, jst = jmamba.mamba_forward(jp, jx, jcfg, return_state=True)
    _, tst = mamba2.mamba_forward(tp, tx, tcfg, return_state=True)
    tol = _tol(dtype, 2e-3)
    for step in range(3):
        jy, ty = _both(_rand((3, 1, tcfg.d_model), 8 + step), dtype)
        jout, jst = jmamba.mamba_decode(jp, jy, jcfg, jst)
        before = {k: v.clone() for k, v in tst.items()}
        tout, new = mamba2.mamba_decode(tp, ty, tcfg, tst)
        assert all(torch.equal(before[k], tst[k]) for k in tst)
        tst = new
        assert tout.shape == (3, 1, tcfg.d_model) and tout.dtype == ty.dtype
        np.testing.assert_allclose(_np(tout), _np(jout), rtol=tol, atol=tol)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), rtol=tol,
                                       atol=tol)


def test_decode_continues_the_forward_pass():
    """The serving invariant at the block: a forward pass over L tokens
    then one decode step gives the forward pass over L + 1 at its last
    position (f32, the JAX package's decode limit)."""
    _, tcfg = _cfgs()
    p = mamba2.init_mamba(torch.Generator().manual_seed(2), tcfg,
                          torch.float32, "cpu")
    x = torch.from_numpy(_rand((2, 17, tcfg.d_model), 9))
    full = mamba2.mamba_forward(p, x, tcfg)
    _, st = mamba2.mamba_forward(p, x[:, :16], tcfg, return_state=True)
    step, _ = mamba2.mamba_decode(p, x[:, 16:], tcfg, st)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 16].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_init_state_matches_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    want = jmamba.init_state(jcfg, 3, jnp.bfloat16)
    got = mamba2.init_state(tcfg, 3, torch.bfloat16, "cpu")
    assert set(got) == set(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
        assert not got[k].any()
