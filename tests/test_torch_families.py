"""The MoE, SSM, hybrid and VLM model families in the port (qwen3-moe,
arctic, mamba2, jamba, internvl2) against the JAX package's ``CausalLM``
on carried weights, at ``reduced()`` size: logits, the loss with the MoE
aux loss, single-pass prefill (logits and every cache and state leaf),
decode steps (a ragged position vector for the attention families), the
serving invariant, the serving engine, the builders and the refusals.
Training these families: ``tests/test_torch_family_train.py``.

Weights: the JAX ``CausalLM.init`` tree as numpy, loaded with
``params_from_numpy``; tokens and prefix embeds from seeded numpy.  The
JAX path runs in ``ref`` mode, as its own tests run on the CPU.  f32
compute at the JAX package's own limits (``tests/test_serve_consistency.py``:
2e-4 for prefill, 2e-3 for decode); bf16 at the limits of ``_close``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models.lm import CausalLM as JCausalLM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models import blocks, common, mamba2
from repro_torch.models.lm import build_model, norm_calls, params_from_numpy
from repro_torch.serve import ServeConfig, ServingEngine

ARCHS = ["qwen3-moe-30b-a3b", "arctic-480b", "mamba2-2.7b",
         "jamba-1.5-large-398b", "internvl2-2b"]
WITH_ATTN = [a for a in ARCHS if a != "mamba2-2.7b"]
WITH_SSM = ["mamba2-2.7b", "jamba-1.5-large-398b"]
F32_PREFILL, F32_DECODE = 2e-4, 2e-3
# bf16: the packages round the same f32 weights to bf16 alike, but their
# bf16 activations round at other points (matmul accumulation, silu,
# the SSD's f32 results cast back, the MoE's sum over experts), which
# after a few layers and the head moves logits by a few bf16 ulps of the
# logit scale (the dense tests' limit, tests/test_torch_model.py)
BF16_TOL = 5e-2
# bf16 with a router: the router's logits are bf16 products, so two
# experts' probabilities can tie or lie an ulp apart, and an ulp of
# difference in the layer's input then picks the other expert in one
# package: an O(1) change to that token (and, through attention and the
# SSM state, to the later ones of its row).  Reduced arctic (1 token of
# 24 routed apart) and jamba (5) reach 4.3e-2 and 5.5e-2 in
# ||port - jax|| / ||jax|| where no router gives 1.2e-2 at most; a wrong
# function gives about 1.4 (two unrelated logit tensors).
BF16_ROUTED_REL = 0.1


@pytest.fixture(autouse=True)
def _jax_ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


def _cfgs(arch, compute_dtype):
    return (dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                                compute_dtype=compute_dtype),
            dataclasses.replace(configs.reduced(configs.get_config(arch)),
                                compute_dtype=compute_dtype))


@functools.lru_cache(maxsize=None)
def _carried(arch, compute_dtype, seed=0):
    """(JAX model, JAX params, port model, port params), made once per
    module run: no test changes the params."""
    jcfg, tcfg = _cfgs(arch, compute_dtype)
    jmodel = JCausalLM(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, build_model(tcfg), params_from_numpy(
        tcfg, tree, device="cpu")


@functools.lru_cache(maxsize=None)
def _jit(jmodel, method, static=()):
    """The JAX model's method, jitted once per model."""
    return jax.jit(getattr(jmodel, method), static_argnames=static)


def _batch(cfg, b, s, seed):
    """numpy {tokens [B, S] int32, and for a VLM prefix_embeds [B, Np, D]
    f32}."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, cfg, f32, what=""):
    """f32: element-wise at ``f32``.  bf16: element-wise at ``BF16_TOL``,
    or, for a model with a MoE router, ||got - want|| / ||want|| at most
    ``BF16_ROUTED_REL``."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if cfg.compute_dtype == "bfloat16" and cfg.moe is not None:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= BF16_ROUTED_REL, (what, rel)
        return
    tol = BF16_TOL if cfg.compute_dtype == "bfloat16" else f32
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _jentry(jcache, cfg, layer, name):
    """The stacked leaf ``name`` of layer ``layer``'s position in a JAX
    cache tree (``pos{l % P}``, leading axis the period)."""
    descs = blocks.layer_descriptors(cfg)
    desc = descs[layer % len(descs)]
    return jcache[f"pos{layer % len(descs)}"][
        "attn" if desc.mixer == "attn" else "mamba"][name]


def _jleaf(jcache, cfg, layer, name):
    """Layer ``layer``'s leaf ``name`` (period ``l // P``)."""
    period = len(blocks.layer_descriptors(cfg))
    return _jentry(jcache, cfg, layer, name)[layer // period]


def _check_cache(tcache, jcache, cfg, f32, filled=None):
    """Every layer's every leaf against the JAX cache (``_close`` at
    ``f32``); attention rows past ``filled`` are zero."""
    assert len(tcache) == cfg.n_layers
    for layer, entry in enumerate(tcache):
        want_keys = ({"k", "v"} if "k" in entry else {"conv", "ssm"})
        assert set(entry) == want_keys
        for name, got in entry.items():
            want = _jleaf(jcache, cfg, layer, name)
            assert tuple(got.shape) == want.shape, (layer, name)
            dt = torch.float32 if name == "ssm" else cfg.cdtype()
            assert got.dtype == dt, (layer, name)
            _close(got, want, cfg, f32, f"layer {layer} {name}")
            if filled is not None and name in ("k", "v"):
                assert not got[:, filled:].any()


# ------------------------------------------------------ forward and loss

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_jax(arch, compute_dtype):
    """The full forward's logits over the tokens (the VLM's prefix sliced
    off), and the loss: NLL with the z-loss plus the MoE layers' summed
    aux loss at its weight."""
    jmodel, jparams, tmodel, tparams = _carried(arch, compute_dtype)
    cfg = tmodel.cfg
    batch = _batch(cfg, 2, 12, seed=1)
    jlogits = _jit(jmodel, "logits")(jparams, _j(batch))
    tlogits = tmodel.logits(tparams, _t(batch))
    assert tlogits.shape == (2, 12, cfg.vocab_size)
    _close(tlogits, jlogits, cfg, F32_PREFILL)
    jloss, jm = _jit(jmodel, "loss")(jparams, _j(batch))
    tloss, tm = tmodel.loss(tparams, _t(batch))
    ltol = 1e-5 if compute_dtype == "float32" else 1e-2
    for got, want in ((tloss, jloss), (tm["nll"], jm["nll"]),
                      (tm["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=ltol,
                                   atol=ltol)
    assert (float(tm["aux"]) > 0) == (cfg.moe is not None)


# ------------------------------------------------------------- prefill

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, compute_dtype):
    """Last-position logits and every layer's cache: attention's K/V with
    zeros past Np + S, Mamba-2's conv window and f32 SSM state."""
    jmodel, jparams, tmodel, tparams = _carried(arch, compute_dtype)
    cfg = tmodel.cfg
    b, s, max_len = 3, 11, 16
    batch = _batch(cfg, b, s, seed=2)
    jlogits, jcache = _jit(jmodel, "prefill", ("max_len",))(
        jparams, _j(batch), max_len=max_len)
    tlogits, tcache = tmodel.prefill(tparams, _t(batch), max_len=max_len)
    assert tlogits.shape == (b, cfg.vocab_size)
    assert tlogits.dtype == cfg.cdtype()
    _close(tlogits, jlogits, cfg, F32_PREFILL)
    _check_cache(tcache, jcache, cfg, F32_PREFILL,
                 filled=cfg.n_prefix_embeds + s)


# -------------------------------------------------------------- decode

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch, compute_dtype):
    """Three decode steps from an empty cache, logits each step and the
    whole cache after; a ragged position vector (each row at its own
    length) where the model has attention."""
    jmodel, jparams, tmodel, tparams = _carried(arch, compute_dtype)
    cfg = tmodel.cfg
    rng = np.random.default_rng(3)
    b = 3
    pos = (np.array([0, 3, 7], np.int32) if arch in WITH_ATTN
           else np.int32(5))
    jcache = jmodel.init_cache(b, 16)
    tcache = tmodel.init_cache(b, 16, device="cpu")
    jstep = _jit(jmodel, "decode_step")
    for step in range(3):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jlogits, jcache = jstep(jparams, jnp.asarray(toks), jcache,
                                jnp.asarray(pos + step))
        with torch.inference_mode():
            tlogits, tcache = tmodel.decode_step(
                tparams, torch.from_numpy(toks), tcache,
                torch.as_tensor(pos + step))
        assert tlogits.shape == (b, cfg.vocab_size)
        _close(tlogits, jlogits, cfg, F32_DECODE, f"step {step}")
    _check_cache(tcache, jcache, cfg, F32_DECODE)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_prefill_matches_jax(arch):
    """Prefill, then three decode steps from its cache at Np + S onward
    (f32): each package from its own prefill."""
    jmodel, jparams, tmodel, tparams = _carried(arch, "float32", seed=1)
    cfg = tmodel.cfg
    b, s, max_len = 2, 9, 16
    batch = _batch(cfg, b, s, seed=4)
    _, jcache = _jit(jmodel, "prefill", ("max_len",))(
        jparams, _j(batch), max_len=max_len)
    _, tcache = tmodel.prefill(tparams, _t(batch), max_len=max_len)
    jstep = _jit(jmodel, "decode_step")
    start = cfg.n_prefix_embeds + s
    rng = np.random.default_rng(4)
    for step in range(3):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jlogits, jcache = jstep(jparams, jnp.asarray(toks), jcache,
                                jnp.int32(start + step))
        with torch.inference_mode():
            tlogits, tcache = tmodel.decode_step(
                tparams, torch.from_numpy(toks), tcache, start + step)
        np.testing.assert_allclose(_np(tlogits), _np(jlogits),
                                   rtol=F32_DECODE, atol=F32_DECODE)
    _check_cache(tcache, jcache, cfg, F32_DECODE)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    """The serving invariant, as ``tests/test_serve_consistency.py`` holds
    the JAX package to it (mamba2 and jamba there): prefill's logits are
    the full forward's at position S - 1, and one decode step from its
    cache, at position Np + S, gives the full forward's at S (f32)."""
    _, _, model, params = _carried(arch, "float32", seed=2)
    cfg = model.cfg
    b, s = 2, 16
    batch = _t(_batch(cfg, b, s + 1, seed=5))
    full = model.logits(params, batch)
    prompt = dict(batch, tokens=batch["tokens"][:, :s])
    logits, cache = model.prefill(params, prompt,
                                  max_len=cfg.n_prefix_embeds + s + 4)
    np.testing.assert_allclose(logits.numpy(), full[:, s - 1].numpy(),
                               rtol=F32_PREFILL, atol=F32_PREFILL)
    with torch.inference_mode():
        step, _ = model.decode_step(params, batch["tokens"][:, s:s + 1],
                                    cache,
                                    torch.tensor(cfg.n_prefix_embeds + s))
    np.testing.assert_allclose(step.numpy(), full[:, s].numpy(),
                               rtol=F32_DECODE, atol=F32_DECODE)


@pytest.mark.parametrize("arch", WITH_SSM)
def test_ssm_state_is_replaced_not_written_in_place(arch):
    """A Mamba-2 layer's cache entry after a decode step is a new state;
    the entry before it is left as it was (attention's K/V are written
    in place)."""
    _, _, model, params = _carried(arch, "float32", seed=3)
    cfg = model.cfg
    _, cache = model.prefill(params, _t(_batch(cfg, 2, 8, seed=6)),
                             max_len=12)
    before = [dict(c) for c in cache]
    snap = [{k: v.clone() for k, v in c.items()} for c in cache]
    with torch.inference_mode():
        _, cache = model.decode_step(params, torch.ones(2, 1,
                                                        dtype=torch.long),
                                     cache, torch.tensor(8))
    for old, new, sn in zip(before, cache, snap):
        if "ssm" in old:
            assert new["ssm"] is not old["ssm"]
            assert torch.equal(old["ssm"], sn["ssm"])
            assert torch.equal(new["conv"][:, :-1], sn["conv"][:, 1:])
        else:
            assert new["k"] is old["k"] and new["k"][:, 8].any()


# -------------------------------------------------------------- params

@pytest.mark.parametrize("arch", ARCHS)
def test_serving_params_keep_mamba_scalars_in_f32(arch):
    """bf16 serving weights (``params_from_numpy`` and ``init``) and f32
    training weights; Mamba-2's dt_bias, a_log and d_skip f32 in all."""
    _, _, tmodel, tparams = _carried(arch, "bfloat16")
    for params, dt in ((tparams, torch.bfloat16),
                       (tmodel.init(seed=0, device="cpu"), torch.bfloat16),
                       (tmodel.init(seed=0, device="cpu", trainable=True),
                        torch.float32)):
        for name, p in params.named_parameters():
            f32 = name.rsplit(".", 1)[-1] in mamba2.F32_PARAMS
            assert p.dtype == (torch.float32 if f32 else dt), name
    n_f32 = sum(1 for n, _ in tparams.named_parameters()
                if n.rsplit(".", 1)[-1] in mamba2.F32_PARAMS)
    n_mamba = sum(1 for d in blocks.stack_descriptors(tmodel.cfg)
                  if d.mixer == "mamba")
    assert n_f32 == 3 * n_mamba


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_descriptors_match_jax(arch):
    from repro.models import blocks as jblocks
    for cfg_of in (lambda m: m.get_config(arch),
                   lambda m: m.reduced(m.get_config(arch))):
        want = jblocks.layer_descriptors(cfg_of(jconfigs))
        got = blocks.layer_descriptors(cfg_of(configs))
        assert [(d.mixer, d.ffn) for d in got] == \
            [(d.mixer, d.ffn) for d in want]
        assert not any(d.cross for d in want)
        assert blocks.n_periods(cfg_of(configs)) == \
            jblocks.n_periods(cfg_of(jconfigs))


def test_jamba_period_layout():
    """One 8-layer period: attention at offset 4, MoE every 2nd layer."""
    descs = blocks.layer_descriptors(configs.get_config(
        "jamba-1.5-large-398b"))
    assert [d.mixer for d in descs] == ["mamba"] * 4 + ["attn"] + \
        ["mamba"] * 3
    assert [d.ffn for d in descs] == ["dense", "moe"] * 4
    assert {d.ffn for d in blocks.layer_descriptors(
        configs.get_config("mamba2-2.7b"))} == {"none"}


def _port_name(path, cfg):
    """A JAX param path (``blocks/pos{j}/...`` with a leading period axis
    dropped by the caller) as the port's parameter names, one per layer."""
    keys = [str(getattr(k, "key", k)) for k in path]
    if keys[0] != "blocks":
        return [".".join(keys)]
    period = len(blocks.layer_descriptors(cfg))
    j = int(keys[1].removeprefix("pos"))
    return [".".join(["blocks", str(p * period + j)] + keys[2:])
            for p in range(blocks.n_periods(cfg))]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax_eval_shape(arch):
    """Full-size serving weights on meta: the JAX package's shapes,
    every leaf in the compute dtype but Mamba-2's three f32 scalars."""
    cfg = configs.get_config(arch)
    jmodel = JCausalLM(jconfigs.get_config(arch))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jsteps.abstract_params(jmodel))[0]:
        stacked = path[0].key == "blocks"     # a leading period axis
        for n in _port_name(path, cfg):
            want[n] = tuple(leaf.shape[1:] if stacked else leaf.shape)
    params = steps.abstract_params(build_model(cfg))
    got = {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert got == want
    for n, p in params.named_parameters():
        f32 = n.rsplit(".", 1)[-1] in mamba2.F32_PARAMS
        assert p.dtype == (torch.float32 if f32 else cfg.cdtype()), n
        assert p.device.type == "meta"


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_matches_jax_eval_shape(arch, shape):
    """The full-size cache on meta: K/V for attention layers, the conv
    window (compute dtype) and the f32 SSM state for Mamba-2 layers."""
    cfg = configs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    jcache = jsteps.abstract_cache(JCausalLM(jcfg), jcfg,
                                   jconfigs.get_shape(shape))
    cache = steps.abstract_cache(build_model(cfg), cfg,
                                 configs.get_shape(shape))
    assert len(cache) == cfg.n_layers
    for layer, entry in enumerate(cache):
        for name, t in entry.items():
            want = _jentry(jcache, cfg, layer, name)
            assert tuple(t.shape) == want.shape[1:]
            assert str(t.dtype).removeprefix("torch.") == str(want.dtype)
            assert t.device.type == "meta"


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "internvl2-2b"])
def test_serving_engine_matches_jax_greedy_tokens(arch):
    """MoE and VLM (tokens only) are served as dense models are: the
    same greedy tokens and step counts as the JAX engine (f32)."""
    jmodel, jparams, tmodel, tparams = _carried(arch, "float32", seed=1)
    rng = np.random.default_rng(1)
    prompts = {uid: rng.integers(0, 512, int(rng.integers(2, 7)))
               for uid in range(5)}
    kw = dict(slots=2, max_len=32, max_new_tokens=6)
    jeng = JServingEngine(jmodel, jparams, JServeConfig(**kw))
    teng = ServingEngine(tmodel, tparams, ServeConfig(**kw))
    for uid, p in prompts.items():
        jeng.submit(uid, p)
        teng.submit(uid, p)
    jres, tres = jeng.run(), teng.run()
    assert tres == jres
    assert all(len(v) == 6 for v in tres.values())
    js, ts = jeng.stats(), teng.stats()
    assert (ts["decode_steps"], ts["prefill_steps"],
            ts["tokens_generated"]) == (js["decode_steps"],
                                        js["prefill_steps"],
                                        js["tokens_generated"])


@pytest.mark.parametrize("arch", WITH_SSM)
def test_serving_engine_refuses_ssm_state(arch):
    """The engine's pad steps and slot reuse would corrupt SSM state."""
    model = build_model(configs.reduced(configs.get_config(arch)))
    params = model.init(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="SSM state"):
        ServingEngine(model, params, ServeConfig(slots=2, max_len=16))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b",
                                  "internvl2-2b"])
def test_serve_launcher_runs_the_family_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    results = serve.main(["--arch", arch, "--device", "cpu",
                          "--requests", "2", "--max-new", "3"])
    assert sorted(results) == [0, 1]
    assert all(len(v) == 3 for v in results.values())
    assert "req 1: 3 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", WITH_SSM)
def test_serve_launcher_refuses_ssm_state(arch):
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="SSM state"):
        serve.main(["--arch", arch, "--device", "cpu", "--requests", "1"])


# ------------------------------------------------------------ builders

def test_build_prefill_step_draws_prefix_embeds():
    """A VLM's prefill batch holds ``prefix_embeds`` [B, Np, D] f32 as
    ``abstract_batch`` declares them, and its cache holds Np + S rows."""
    cfg = configs.reduced(configs.get_config("internvl2-2b"))
    shape = dataclasses.replace(configs.get_shape("prefill_32k"),
                                global_batch=2, seq_len=8)
    prefill, (params, batch) = steps.build_prefill_step(cfg, shape,
                                                        device="cpu")
    pre = batch["prefix_embeds"]
    assert pre.shape == (2, cfg.n_prefix_embeds, cfg.d_model)
    assert pre.dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        k: tuple(v.shape) for k, v in steps.abstract_batch(
            cfg, shape).items()}
    logits, cache = prefill(params, batch)
    assert logits.shape == (2, cfg.vocab_size)
    assert cache[0]["k"].shape[1] == 8 + cfg.n_prefix_embeds
    assert cache[0]["k"][:, 8 + cfg.n_prefix_embeds - 1].any()


@pytest.mark.parametrize("arch", WITH_SSM)
def test_build_decode_step_gives_ssm_layers_their_state(arch):
    cfg = configs.reduced(configs.get_config(arch))
    shape = dataclasses.replace(configs.get_shape("decode_32k"),
                                global_batch=2, seq_len=8)
    decode, (params, tokens, cache, pos) = steps.build_decode_step(
        cfg, shape, device="cpu")
    kinds = ["ssm" in c for c in cache]
    assert kinds == [d.mixer == "mamba"
                     for d in blocks.stack_descriptors(cfg)]
    with torch.inference_mode():
        logits, cache = decode(params, tokens, cache, pos)
    assert bool(torch.isfinite(logits).all())
    assert all(c["ssm"].any() for c in cache if "ssm" in c)


@pytest.mark.parametrize("arch", ARCHS)
def test_family_inits_and_decodes_on_cpu(arch):
    """Random weights from the port's own init (bf16): prefill and a
    decode step give finite logits."""
    model = build_model(configs.reduced(configs.get_config(arch)))
    params = model.init(seed=0, device="cpu")
    cfg = model.cfg
    logits, cache = model.prefill(params, _t(_batch(cfg, 2, 5, seed=7)),
                                  max_len=16)
    with torch.inference_mode():
        step, _ = model.decode_step(params, torch.ones(2, 1,
                                                       dtype=torch.long),
                                    cache,
                                    torch.tensor(cfg.n_prefix_embeds + 5))
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()


@pytest.mark.parametrize("arch", ARCHS + ["yi-9b", "whisper-medium"])
def test_norm_calls_counts_every_rmsnorm_of_a_forward(arch):
    """``lm.norm_calls`` (the launch count chip_smoke and the gpu tests
    expect of the rmsnorm kernel) is the number of rmsnorm calls one
    forward makes, and ``blocks.norm_calls`` of the decoder plus the
    final norm those of one decode step."""
    from unittest import mock
    cfg = configs.reduced(configs.get_config(arch))
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    calls = []
    norm = common.rms_norm

    def counted(*a, **kw):
        calls.append(1)
        return norm(*a, **kw)
    batch = _t(_batch(cfg, 2, 5, seed=3))
    if cfg.encdec:
        batch["frames"] = torch.zeros(2, cfg.enc_seq, cfg.d_model)
    with mock.patch.object(common, "rms_norm", counted), torch.no_grad():
        logits, cache = model.prefill(params, batch,
                                      max_len=8 + cfg.n_prefix_embeds)
        assert len(calls) == norm_calls(params)
        calls.clear()
        model.decode_step(params, logits.argmax(-1, keepdim=True), cache,
                          torch.tensor(5 + cfg.n_prefix_embeds))
    assert len(calls) == blocks.norm_calls(params.blocks) + 1
