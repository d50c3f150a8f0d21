"""Whisper (the encoder-decoder ``EncDecLM``) in the port against the JAX
package's ``repro.models.whisper.EncDecLM`` and its pieces, on carried
weights at ``reduced()`` size (2 encoder and 2 decoder layers, d_model
64, 16 frames): the encoder, the cross K/V, the loss, the logits,
prefill (logits, and the self cache against the JAX package's own
``blocks.stack_prefill`` with ``cross_kv``), decode steps from one
cache, prefill plus decode against the full forward, the params tree,
the abstract shapes, the step builders' ``frames`` and the serving
refusals.

The JAX ``EncDecLM`` has no function for the full forward's logits with
cross-attention (its inherited ``logits`` runs the decoder without the
encoder, ``test_jax_logits_leave_out_the_encoder``), so the reference
for the port's ``logits`` is ``_jax_full``, made of the JAX package's
own ``encode``, ``cross_kv``, ``blocks.stack_forward`` and head.  The
JAX prefill returns a zero self cache
(``test_jax_prefill_returns_an_empty_self_cache``); the port fills it.

Weights: the JAX ``EncDecLM.init`` tree as numpy, loaded with
``params_from_numpy``; tokens and frames from seeded numpy.  The JAX
path runs in ``ref`` mode, as its own tests run on the CPU.  Limits as
``tests/test_torch_families.py``'s: f32 at the JAX package's own
serving limits (``tests/test_serve_consistency.py``: 2e-4 for prefill,
2e-3 for decode), bf16 at 5e-2 (the packages round activations at
other points).
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
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models.whisper import EncDecLM as JEncDecLM
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models import blocks, common, whisper
from repro_torch.models.lm import EncDecParams, build_model, params_from_numpy
from repro_torch.serve import ServeConfig, ServingEngine

ARCH = "whisper-medium"
F32_PREFILL, F32_DECODE = 2e-4, 2e-3
BF16_TOL = 5e-2
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _jax_ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


def _cfgs(compute_dtype):
    return (dataclasses.replace(jconfigs.reduced(jconfigs.get_config(ARCH)),
                                compute_dtype=compute_dtype),
            dataclasses.replace(configs.reduced(configs.get_config(ARCH)),
                                compute_dtype=compute_dtype))


@functools.lru_cache(maxsize=None)
def _carried(compute_dtype, seed=0):
    """(JAX model, JAX params, port model, port serving params), made once
    per module run: no test changes the params."""
    jcfg, tcfg = _cfgs(compute_dtype)
    jmodel = JEncDecLM(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, build_model(tcfg), params_from_numpy(
        tcfg, tree, device="cpu")


@functools.lru_cache(maxsize=None)
def _jit(jmodel, method, static=()):
    return jax.jit(getattr(jmodel, method), static_argnames=static)


def _batch(cfg, b, s, seed):
    """numpy {tokens [B, S] int32, frames [B, enc_seq, D] f32}."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32),
        "frames": rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(
            np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, cfg, f32, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = BF16_TOL if cfg.compute_dtype == "bfloat16" else f32
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _jax_context(jmodel, params, batch):
    """The JAX package's pieces before the decoder: (embedded tokens, rope,
    cross K/V of the encoded frames)."""
    cfg = jmodel.cfg
    enc = jmodel.encode(params, batch["frames"], remat=False)
    kv = jmodel.cross_kv(params, enc)
    x = jlm._embed_tokens(params, batch["tokens"], cfg)
    rope = jcommon.make_rope(jnp.arange(x.shape[1]), cfg.head_dim,
                             cfg.rope_theta, cfg.rope_style)
    return x, rope, kv


@functools.lru_cache(maxsize=None)
def _jax_full(jmodel):
    """The full forward's logits [B, S, vocab] with cross-attention, from
    the JAX package's own pieces (jitted once per model)."""
    cfg = jmodel.cfg

    def full(params, batch):
        x, rope, kv = _jax_context(jmodel, params, batch)
        x, _ = jblocks.stack_forward(params["blocks"], x, cfg, rope, None,
                                     causal=True, cross_kv=kv, remat=False)
        x = jcommon.rms_norm(x, params["final_norm"].astype(x.dtype),
                             cfg.norm_eps)
        return jlm._head_logits(params, x, cfg)[..., :cfg.vocab_size]
    return jax.jit(full)


@functools.lru_cache(maxsize=None)
def _jax_stack_prefill(jmodel, max_len):
    """The JAX package's ``blocks.stack_prefill`` with ``cross_kv`` from
    its ``init_cache``: (self cache, cross K/V)."""
    cfg = jmodel.cfg

    def run(params, batch):
        x, rope, kv = _jax_context(jmodel, params, batch)
        cache = jmodel.init_cache(x.shape[0], max_len)
        _, cache = jblocks.stack_prefill(params["blocks"], cache, x, cfg,
                                         rope, None, cross_kv=kv)
        return cache, kv
    return jax.jit(run)


def _check_self(tcache, jcache, cfg, f32, filled=None):
    """Each decoder layer's self K/V against the JAX cache tree
    (``pos0/attn/{k,v}`` [L, ...]); rows past ``filled`` zero."""
    assert len(tcache) == cfg.n_layers
    for layer, entry in enumerate(tcache):
        assert set(entry) == {"k", "v"}
        for name, got in entry.items():
            assert got.dtype == cfg.cdtype()
            _close(got, jcache["pos0"]["attn"][name][layer], cfg, f32,
                   f"layer {layer} {name}")
            if filled is not None:
                assert not got[:, filled:].any()


def _check_cross(tkv, jkv, cfg, f32):
    assert len(tkv) == cfg.n_layers
    for layer, entry in enumerate(tkv):
        for name in ("k", "v"):
            assert entry[name].shape == (
                jkv["pos0"][name].shape[1:]), (layer, name)
            _close(entry[name], jkv["pos0"][name][layer], cfg, f32,
                   f"cross {layer} {name}")


# ------------------------------------------------------------ the model

def test_build_model_returns_the_encoder_decoder():
    for cfg in (configs.get_config(ARCH),
                configs.reduced(configs.get_config(ARCH))):
        model = build_model(cfg)
        assert isinstance(model, whisper.EncDecLM)
        assert model.cfg is cfg


def test_layer_descriptors_match_jax():
    """Decoder layers carry cross-attention, the encoder's none."""
    for cfg_of in (lambda m: m.get_config(ARCH),
                   lambda m: m.reduced(m.get_config(ARCH))):
        jcfg, tcfg = cfg_of(jconfigs), cfg_of(configs)
        want = jblocks.layer_descriptors(jcfg)
        got = blocks.layer_descriptors(tcfg)
        assert [(d.mixer, d.ffn, d.cross) for d in got] == \
            [(d.mixer, d.ffn, d.cross) for d in want] == [
                ("attn", "dense", True)]
        enc = blocks.layer_descriptors(whisper.encoder_config(tcfg))
        assert [(d.mixer, d.ffn, d.cross) for d in enc] == [
            ("attn", "dense", False)]


def test_sinusoid_matches_jax():
    """Within two f32 ulps of the largest angle (pos up to t - 1 rad):
    the packages' exp and product may round the angle an ulp apart, which
    moves sin and cos by as much."""
    from repro.models.whisper import _sinusoid as jsinusoid
    for t, d in ((16, 64), (1500, 1024), (7, 10)):
        np.testing.assert_allclose(whisper._sinusoid(t, d).numpy(),
                                   np.asarray(jsinusoid(t, d)),
                                   rtol=0, atol=t * 2.0 ** -22)


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_encode_matches_jax(compute_dtype):
    """The encoder's normed output [B, T, D] (non-causal, no rope)."""
    jmodel, jparams, tmodel, tparams = _carried(compute_dtype)
    cfg = tmodel.cfg
    batch = _batch(cfg, 2, 8, seed=1)
    want = jax.jit(lambda p, f: jmodel.encode(p, f, remat=False))(
        jparams, jnp.asarray(batch["frames"]))
    got = tmodel.encode(tparams, torch.from_numpy(batch["frames"]),
                        remat=False)
    assert got.dtype == cfg.cdtype()
    _close(got, want, cfg, F32_PREFILL)


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_cross_kv_matches_jax(compute_dtype):
    """Each decoder layer's K/V of the same encoder output."""
    jmodel, jparams, tmodel, tparams = _carried(compute_dtype)
    cfg = tmodel.cfg
    enc = np.random.default_rng(2).standard_normal(
        (2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    want = jax.jit(jmodel.cross_kv)(jparams,
                                    jnp.asarray(enc).astype(compute_dtype))
    got = tmodel.cross_kv(tparams, torch.from_numpy(enc).to(cfg.cdtype()))
    assert all(e["k"].dtype == cfg.cdtype() for e in got)
    _check_cross(got, want, cfg, 1e-5)


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_loss_matches_jax(compute_dtype):
    """``EncDecLM.loss``: the NLL with the z-loss of the decoder tokens,
    no aux weight, a mask of ones."""
    jmodel, jparams, tmodel, tparams = _carried(compute_dtype)
    cfg = tmodel.cfg
    batch = _batch(cfg, 2, 12, seed=3)
    jloss, jm = _jit(jmodel, "loss")(jparams, _j(batch))
    tloss, tm = tmodel.loss(tparams, _t(batch))
    ltol = 1e-5 if compute_dtype == "float32" else 1e-2
    for got, want in ((tloss, jloss), (tm["nll"], jm["nll"])):
        np.testing.assert_allclose(float(got), float(want), rtol=ltol,
                                   atol=ltol)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_logits_match_jax_full_forward(compute_dtype):
    """``logits``: every position's, with cross-attention to the frames."""
    jmodel, jparams, tmodel, tparams = _carried(compute_dtype)
    cfg = tmodel.cfg
    batch = _batch(cfg, 2, 12, seed=4)
    got = tmodel.logits(tparams, _t(batch))
    assert got.shape == (2, 12, cfg.vocab_size)
    _close(got, _jax_full(jmodel)(jparams, _j(batch)), cfg, F32_PREFILL)


def test_jax_logits_leave_out_the_encoder():
    """Records the reference's inherited ``EncDecLM.logits``: it runs the
    decoder with no cross K/V, so the frames do not reach it (two frame
    draws give equal logits), and it is not the full forward, which the
    port's ``logits`` is."""
    jmodel, jparams, _, _ = _carried("float32")
    cfg = jmodel.cfg
    a, b = _batch(cfg, 2, 12, seed=5), _batch(cfg, 2, 12, seed=6)
    b["tokens"] = a["tokens"]
    la = np.asarray(jmodel.logits(jparams, _j(a)))
    np.testing.assert_array_equal(la, np.asarray(jmodel.logits(jparams,
                                                               _j(b))))
    full = np.asarray(_jax_full(jmodel)(jparams, _j(a)))
    assert np.abs(la - full).max() > 100 * F32_PREFILL


# --------------------------------------------------------------- serve

@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_prefill_matches_jax(compute_dtype):
    """The last position's logits against the JAX ``EncDecLM.prefill``'s
    (the same function); the self cache against the JAX package's
    ``blocks.stack_prefill`` with ``cross_kv`` (zeros past S); the cross
    K/V against its ``cross_kv``."""
    jmodel, jparams, tmodel, tparams = _carried(compute_dtype)
    cfg = tmodel.cfg
    b, s, max_len = 3, 11, 16
    batch = _batch(cfg, b, s, seed=7)
    jlogits, _ = _jit(jmodel, "prefill", ("max_len",))(
        jparams, _j(batch), max_len=max_len)
    tlogits, tcache = tmodel.prefill(tparams, _t(batch), max_len=max_len)
    assert set(tcache) == {"self", "cross"}
    assert tlogits.shape == (b, cfg.vocab_size)
    assert tlogits.dtype == cfg.cdtype()
    _close(tlogits, jlogits, cfg, F32_PREFILL)
    jself, jkv = _jax_stack_prefill(jmodel, max_len)(jparams, _j(batch))
    _check_self(tcache["self"], jself, cfg, F32_PREFILL, filled=s)
    _check_cross(tcache["cross"], jkv, cfg, F32_PREFILL)


def test_jax_prefill_returns_an_empty_self_cache():
    """Records the reference: the JAX ``EncDecLM.prefill`` returns
    ``init_cache`` zeros as its self cache, so its decode steps would
    attend to empty keys.  The port's prefill fills rows [0, S) (see
    ``repro_torch.models.whisper``)."""
    jmodel, jparams, tmodel, tparams = _carried("float32")
    cfg = tmodel.cfg
    batch = _batch(cfg, 2, 9, seed=8)
    _, jcache = _jit(jmodel, "prefill", ("max_len",))(jparams, _j(batch),
                                                      max_len=16)
    assert not any(np.asarray(leaf).any()
                   for leaf in jax.tree.leaves(jcache["self"]))
    _, tcache = tmodel.prefill(tparams, _t(batch), max_len=16)
    for entry in tcache["self"]:
        assert bool(entry["k"][:, :9].abs().amax(dim=(2, 3)).gt(0).all())
        assert not entry["k"][:, 9:].any()


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_decode_steps_match_jax(compute_dtype):
    """Three decode steps of both packages from the same cache (the JAX
    ``stack_prefill`` cache and cross K/V, carried into the port's),
    at a ragged position vector: logits each step, the self cache
    after."""
    jmodel, jparams, tmodel, tparams = _carried(compute_dtype)
    cfg = tmodel.cfg
    b, s, max_len = 3, 7, 16
    batch = _batch(cfg, b, s, seed=9)
    jself, jkv = _jax_stack_prefill(jmodel, max_len)(jparams, _j(batch))

    def port_of(leaf, i):
        return torch.from_numpy(np.array(leaf[i], np.float32)).to(
            cfg.cdtype())
    tcache = {"self": [{n: port_of(jself["pos0"]["attn"][n], i)
                        for n in ("k", "v")} for i in range(cfg.n_layers)],
              "cross": [{n: port_of(jkv["pos0"][n], i) for n in ("k", "v")}
                        for i in range(cfg.n_layers)]}
    jcache = {"self": jself, "cross": jkv}
    pos = np.array([s, s - 3, s - 5], np.int32)
    rng = np.random.default_rng(9)
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
    _check_self(tcache["self"], jcache["self"], cfg, F32_DECODE)


def test_prefill_then_decode_matches_the_full_forward():
    """The serving invariant: prefill's logits are the full forward's at
    position S - 1, and one decode step from its cache gives the full
    forward's at S, against the JAX full forward over S + 1 tokens
    (f32)."""
    jmodel, jparams, tmodel, tparams = _carried("float32")
    cfg = tmodel.cfg
    b, s = 2, 12
    batch = _batch(cfg, b, s + 1, seed=10)
    full = np.asarray(_jax_full(jmodel)(jparams, _j(batch)))
    prompt = dict(_t(batch), tokens=torch.from_numpy(batch["tokens"][:, :s]))
    logits, cache = tmodel.prefill(tparams, prompt, max_len=s + 4)
    np.testing.assert_allclose(logits.numpy(), full[:, s - 1],
                               rtol=F32_PREFILL, atol=F32_PREFILL)
    with torch.inference_mode():
        step, _ = tmodel.decode_step(
            tparams, torch.from_numpy(batch["tokens"][:, s:s + 1]), cache,
            torch.tensor(s))
    np.testing.assert_allclose(step.numpy(), full[:, s], rtol=F32_DECODE,
                               atol=F32_DECODE)
    # and the port's own full forward
    np.testing.assert_allclose(tmodel.logits(tparams, _t(batch)).numpy(),
                               full, rtol=F32_PREFILL, atol=F32_PREFILL)


def test_init_decodes_on_cpu():
    """Random weights from the port's own init (bf16): prefill and a
    decode step give finite logits; the cache holds ``max_len`` self
    rows and ``enc_seq`` cross rows."""
    cfg = configs.reduced(configs.get_config(ARCH))
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    assert isinstance(params, EncDecParams)
    logits, cache = model.prefill(params, _t(_batch(cfg, 2, 5, seed=11)),
                                  max_len=16)
    assert cache["self"][0]["k"].shape == (2, 16, cfg.n_kv_heads,
                                           cfg.head_dim)
    assert cache["cross"][0]["k"].shape == (2, cfg.enc_seq, cfg.n_kv_heads,
                                            cfg.head_dim)
    with torch.inference_mode():
        step, _ = model.decode_step(params, torch.ones(2, 1,
                                                       dtype=torch.long),
                                    cache, torch.tensor(5))
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()


@pytest.mark.parametrize("path", ["forward", "prefill", "decode"])
def test_decoder_without_the_encoder_kv_raises(path):
    """A cross-attention layer given no encoder K/V raises on every path:
    the decoder never runs without its encoder (as the JAX ``logits``
    does, ``test_jax_logits_leave_out_the_encoder``)."""
    cfg = configs.reduced(configs.get_config(ARCH))
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    s = 1 if path == "decode" else 3
    x = torch.zeros(2, s, cfg.d_model, dtype=cfg.cdtype())
    pos = torch.arange(s)
    rope = common.make_rope(pos, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_style)
    cache = model.init_cache(2, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder's K/V"), \
            torch.no_grad():
        if path == "forward":
            blocks.stack_forward(params.blocks, x, cfg, rope, remat=False)
        elif path == "prefill":
            blocks.stack_prefill(params.blocks, cache, x, cfg, rope)
        else:
            blocks.stack_decode(params.blocks, cache, x, cfg, rope,
                                torch.tensor(0))


# -------------------------------------------------------------- params

def _jleaf_of(tree, name, cfg):
    """The JAX tree's leaf of the port parameter ``name``: ``blocks.l...``
    and ``enc_blocks.l...`` index their stacked ``pos0`` leaf at l."""
    parts = name.split(".")
    if parts[0] not in ("blocks", "enc_blocks"):
        return tree[name]
    node = tree[parts[0]]["pos0"]
    for k in parts[2:]:
        node = node[k]
    return node[int(parts[1])]


@pytest.mark.parametrize("trainable", [False, True])
def test_params_from_numpy_carries_the_encdec_tree(trainable):
    """Every leaf of the JAX ``EncDecLM.init`` tree lands in one port
    parameter, with its values: ``enc_blocks/pos0/...`` [n_enc_layers,
    ...], ``enc_norm``, the decoder's ``norm_x`` and ``cross``."""
    jcfg, tcfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, JEncDecLM(jcfg).init(
        jax.random.PRNGKey(3)))
    params = params_from_numpy(tcfg, tree, device="cpu",
                               trainable=trainable)
    assert isinstance(params, EncDecParams)
    named = dict(params.named_parameters())
    n_leaves = sum(leaf.shape[0] if path[0].key in ("blocks", "enc_blocks")
                   else 1 for path, leaf in
                   jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(named) == n_leaves
    dt = torch.float32 if trainable else torch.bfloat16
    for name, p in named.items():
        want = _jleaf_of(tree, name, tcfg)
        assert p.dtype == dt and p.requires_grad == trainable, name
        np.testing.assert_array_equal(
            p.detach().float().numpy(),
            torch.from_numpy(np.asarray(want)).to(dt).float().numpy(),
            err_msg=name)
    assert {n.split(".")[0] for n in named} == {
        "embed", "blocks", "final_norm", "head", "enc_blocks", "enc_norm"}
    assert all(params.blocks[i].cross is not None
               for i in range(tcfg.n_layers))
    assert all(layer.cross is None and layer.norm_x is None
               for layer in params.enc_blocks)


def test_abstract_params_and_state_match_jax_eval_shape():
    """Full-size weights on meta: the JAX package's shapes (0.81 B
    parameters), serving in the compute dtype, training state in
    ``param_dtype`` with f32 moments."""
    cfg = configs.get_config(ARCH)
    jmodel = JEncDecLM(jconfigs.get_config(ARCH))
    model = build_model(cfg)
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jsteps.abstract_params(jmodel))[0]:
        keys = [p.key for p in path]
        if keys[0] in ("blocks", "enc_blocks"):
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i)] + keys[2:])] = tuple(
                    leaf.shape[1:])
        else:
            want[".".join(keys)] = tuple(leaf.shape)
    params = steps.abstract_params(model)
    got = {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert got == want
    assert {p.dtype for p in params.parameters()} == {cfg.cdtype()}
    assert all(p.device.type == "meta" for p in params.parameters())
    n = sum(p.numel() for p in params.parameters())
    # ModelConfig.n_params counts neither the vocabulary's pad rows of
    # embed and head nor enc_norm
    pad = cfg.padded_vocab - cfg.vocab_size
    assert n == cfg.n_params() + (2 * pad + 1) * cfg.d_model
    state = steps.abstract_state(model)
    assert {n: tuple(p.shape) for n, p in
            state["params"].named_parameters()} == want
    assert {p.dtype for p in state["params"].parameters()} == {
        cfg.pdtype()}
    assert {n: tuple(t.shape) for n, t in state["opt_state"]["m"].items()} \
        == want


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_abstract_cache_matches_jax_eval_shape(shape):
    """``{"self": each decoder layer's K/V of seq_len rows, "cross": each
    decoder layer's K/V of enc_seq rows}`` as ``jax.eval_shape`` gives
    the JAX ``abstract_cache``."""
    cfg = configs.get_config(ARCH)
    jcfg = jconfigs.get_config(ARCH)
    jcache = jsteps.abstract_cache(JEncDecLM(jcfg), jcfg,
                                   jconfigs.get_shape(shape))
    cache = steps.abstract_cache(build_model(cfg), cfg,
                                 configs.get_shape(shape))
    assert set(cache) == set(jcache) == {"self", "cross"}
    for part, jpart in (("self", jcache["self"]["pos0"]["attn"]),
                        ("cross", jcache["cross"]["pos0"])):
        assert len(cache[part]) == cfg.n_layers
        for entry in cache[part]:
            for name in ("k", "v"):
                t, want = entry[name], jpart[name]
                assert tuple(t.shape) == want.shape[1:], (part, name)
                assert str(t.dtype).removeprefix("torch.") == str(
                    want.dtype)
                assert t.device.type == "meta"


# ------------------------------------------------------------ builders

def _small(kind: str, b=2, s=8):
    return dataclasses.replace(configs.get_shape(kind), global_batch=b,
                               seq_len=s)


def test_build_prefill_step_draws_frames():
    """The prefill batch holds ``frames`` [B, enc_seq, D] f32 as
    ``abstract_batch`` declares them; the cache is ``{"self", "cross"}``
    with the self rows filled at [0, S)."""
    cfg = configs.reduced(configs.get_config(ARCH))
    shape = _small("prefill_32k")
    prefill, (params, batch) = steps.build_prefill_step(cfg, shape,
                                                        device="cpu")
    assert batch["frames"].dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        k: tuple(v.shape) for k, v in steps.abstract_batch(
            cfg, shape).items()} == {"tokens": (2, 8),
                                     "frames": (2, cfg.enc_seq, cfg.d_model)}
    assert batch["frames"].std() > 0.5
    logits, cache = prefill(params, batch)
    assert logits.shape == (2, cfg.vocab_size)
    assert cache["self"][0]["k"].shape[1] == 8
    assert cache["self"][0]["k"][:, 7].any()
    assert cache["cross"][0]["k"].shape[1] == cfg.enc_seq


def test_build_decode_step_builds_self_and_cross():
    cfg = configs.reduced(configs.get_config(ARCH))
    decode, (params, tokens, cache, pos) = steps.build_decode_step(
        cfg, _small("decode_32k"), device="cpu")
    assert set(cache) == {"self", "cross"}
    want = steps.abstract_cache(build_model(cfg), cfg, _small("decode_32k"))
    for part in ("self", "cross"):
        assert [{n: tuple(t.shape) for n, t in e.items()}
                for e in cache[part]] == [{n: tuple(t.shape) for n, t in
                                           e.items()} for e in want[part]]
    with torch.inference_mode():
        logits, cache = decode(params, tokens, cache, pos)
    assert bool(torch.isfinite(logits).all())
    assert cache["self"][0]["k"][:, int(pos)].any()


def test_build_train_step_batch_holds_frames():
    """The train batch holds ``frames`` beside ``tokens``, and a step
    runs on the CPU."""
    cfg = configs.reduced(configs.get_config(ARCH))
    shape = _small("train_4k", s=9)
    step, (state, batch) = steps.build_train_step(cfg, shape, device="cpu")
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        k: tuple(v.shape) for k, v in steps.abstract_batch(
            cfg, shape).items()}
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state["opt_state"]["step"]) == 1


# ------------------------------------------------------------- refusals

def test_serving_engine_refuses_the_encoder_decoder():
    """The engine's requests carry no frames and its cache no cross
    K/V."""
    model = build_model(configs.reduced(configs.get_config(ARCH)))
    params = model.init(seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        ServingEngine(model, params, ServeConfig(slots=2, max_len=16))


def test_serve_launcher_refuses_the_encoder_decoder():
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "1"])
