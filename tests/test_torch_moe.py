"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the same numpy inputs and carried
weights: the router (ties included), the aux loss, ``moe_dense``, and the
grouped path the port runs against ``moe_dense``.

Weights: the JAX ``init_moe`` tree as numpy, loaded into ``moe.MoE``;
activations from seeded numpy.  Configs at ``reduced()`` size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import moe as jmoe
from repro_torch.configs import get_config, reduced
from repro_torch.models import ffn, moe

ARCHS = ["qwen3-moe-30b-a3b", "arctic-480b", "jamba-1.5-large-398b"]
# bf16: both packages round the same products once to bf16, but at other
# points (the SwiGLU's product, the sum over experts: f32 in the grouped
# path, a bf16 einsum in moe_dense), a few bf16 ulps of the output scale
BF16_TOL = 3e-2


def _cfgs(arch, compute_dtype="float32", **moe_kw):
    jcfg, tcfg = (dataclasses.replace(f(g(arch)), compute_dtype=compute_dtype)
                  for f, g in ((jreduced, jget_config), (reduced, get_config)))
    if moe_kw:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return jcfg, tcfg


def _carried(jcfg, tcfg, seed=0):
    """(JAX params, port ``MoE``): the JAX init's f32 leaves cast to the
    compute dtype, as ``params_from_numpy`` stores serving weights."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    dt = tcfg.cdtype()

    def t(a):
        return torch.tensor(np.asarray(a)).to(dt)
    dense = None
    if "dense" in jp:
        d = jp["dense"]
        dense = ffn.FFN(t(d["w_in"]), t(d["w_out"]), t(d["w_gate"]))
    return jp, moe.MoE(t(jp["router"]), t(jp["w_in"]), t(jp["w_gate"]),
                       t(jp["w_out"]), dense)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(a, dtype):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_match_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, tcfg, tcfg.cdtype(), "cpu")
    got = {k: tuple(v.shape) for k, v in p.named_parameters()}
    want = {".".join(str(getattr(k, "key", k)) for k in path): v.shape
            for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got == want
    assert {v.dtype for v in p.parameters()} == {tcfg.cdtype()}
    # the fan-in of an expert's weights is its input axis (in_axis=1)
    lim = 2.0 / np.sqrt(tcfg.d_model) + 1e-6
    assert float(p.w_in.float().abs().max()) <= lim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _carried(jcfg, tcfg)
    jx, tx = _both(_x((37, tcfg.d_model), 1), dtype)
    jprobs, jgates, jidx = jmoe._route(jx, jp["router"], jcfg.moe)
    tprobs, tgates, tidx = moe._route(tx, tp.router, tcfg.moe)
    assert tidx.shape == (37, tcfg.moe.top_k) and tgates.dtype == tx.dtype
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tgates), _np(jgates), rtol=1e-2 if
                               dtype == "bfloat16" else 1e-5, atol=1e-6)


@pytest.mark.parametrize("tie", ["pairs", "all"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_breaks_ties_as_jax_top_k(tie, dtype):
    """Equal probabilities go to the lower expert id first, as
    ``jax.lax.top_k`` orders them: planted by giving experts equal router
    columns (the logits then tie exactly in both packages)."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", dtype, n_experts=16, top_k=8)
    r = _x((tcfg.d_model, 16), 2)
    if tie == "all":
        r[:] = r[:, :1]
    else:                 # expert 2j + 1 copies expert 2j: 8 tied pairs
        r[:, 1::2] = r[:, 0::2]
    x = _x((29, tcfg.d_model), 3)
    jr, tr = _both(r, dtype)
    jx, tx = _both(x, dtype)
    _, jgates, jidx = jmoe._route(jx, jr, jcfg.moe)
    probs, tgates, tidx = moe._route(tx, tr, tcfg.moe)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(tgates), _np(jgates), rtol=1e-5)
    if tie == "all":
        assert (tidx == torch.arange(8)).all()
    else:
        # each tied pair is picked together, the lower id first
        assert (tidx[:, 0::2] % 2 == 0).all()
        assert (tidx[:, 1::2] == tidx[:, 0::2] + 1).all()
    assert bool((probs[:, 1::2] == probs[:, 0::2]).all())


@pytest.mark.parametrize("tokens", [1, 41])
@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_matches_jax(arch, tokens):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _carried(jcfg, tcfg)
    jx, tx = _both(_x((tokens, tcfg.d_model), 4), "float32")
    jprobs, _, jidx = jmoe._route(jx, jp["router"], jcfg.moe)
    tprobs, _, tidx = moe._route(tx, tp.router, tcfg.moe)
    want = jmoe._aux_loss(jprobs, jidx, jcfg.moe)
    got = moe._aux_loss(tprobs, tidx, tcfg.moe)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_jax(arch, dtype):
    """The literal plain version (every expert on every token; Arctic's
    dense residual branch included)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _carried(jcfg, tcfg)
    jx, tx = _both(_x((2, 9, tcfg.d_model), 5), dtype)
    jy, jaux = jmoe.moe_dense(jp, jx, jcfg)
    ty, taux = moe.moe_dense(tp, tx, tcfg)
    assert ty.shape == tx.shape and ty.dtype == tx.dtype
    tol = BF16_TOL if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_path_matches_moe_dense(arch, dtype):
    """``moe_forward`` (each expert on its own tokens) against the port's
    ``moe_dense`` and the JAX package's: the same function, summed in
    another order."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _carried(jcfg, tcfg, seed=1)
    jx, tx = _both(_x((3, 11, tcfg.d_model), 6), dtype)
    y, aux = moe.moe_forward(tp, tx, tcfg)
    yd, auxd = moe.moe_dense(tp, tx, tcfg)
    jy, jaux = jmoe.moe_dense(jp, jx, jcfg)
    assert y.shape == tx.shape and y.dtype == tx.dtype
    tol = BF16_TOL if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(y), _np(yd), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=tol, atol=tol)
    assert float(aux) == float(auxd)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_grouped_path_skips_experts_no_token_chose():
    """With most experts unchosen (a router that prefers two experts),
    only the chosen ones run, and the output is still moe_dense's."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", n_experts=8, top_k=2)
    _, tp = _carried(jcfg, tcfg, seed=2)
    with torch.no_grad():
        tp.router[:, 2:] = -4.0 * tp.router[:, :1].abs()
        tp.router[:, :2] = 4.0 * tp.router[:, :2].abs()
    x = torch.from_numpy(_x((2, 5, tcfg.d_model), 7)).abs()
    _, _, idx = moe._route(x.reshape(-1, tcfg.d_model), tp.router, tcfg.moe)
    assert set(idx.unique().tolist()) <= {0, 1}
    y, _ = moe.moe_forward(tp, x, tcfg)
    yd, _ = moe.moe_dense(tp, x, tcfg)
    np.testing.assert_allclose(y.numpy(), yd.numpy(), rtol=1e-5, atol=1e-5)


def test_grouped_path_has_gradients():
    """``CausalLM.loss`` runs through it on the CPU: the gradient of the
    output reaches the input and the chosen experts' weights."""
    _, tcfg = _cfgs("qwen3-moe-30b-a3b")
    gen = torch.Generator().manual_seed(3)
    p = moe.init_moe(gen, tcfg, torch.float32, "cpu").requires_grad_(True)
    x = torch.from_numpy(_x((2, 4, tcfg.d_model), 8)).requires_grad_()
    y, aux = moe.moe_forward(p, x, tcfg)
    (y.square().sum() + aux).backward()
    assert x.grad is not None and bool(x.grad.abs().sum() > 0)
    assert bool(p.w_in.grad.abs().sum() > 0)
    assert bool(p.router.grad.abs().sum() > 0)
