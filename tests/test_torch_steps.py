"""The shape cells (``configs.get_shape``, ``SHAPES``, ``cells``) and the
one-card step builders (``launch.steps``) against the JAX package's, and
the builders run at reduced size on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models.lm import build_model as jbuild_model
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.models.lm import build_model

DENSE = ["yi-9b", "mistral-large-123b", "chatglm3-6b", "starcoder2-7b"]


def test_shapes_match_jax():
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(configs.get_shape(name)) == \
            dataclasses.asdict(shape)
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.asdict(getattr(configs, name)) == \
            dataclasses.asdict(getattr(jconfigs, name))
    with pytest.raises(KeyError):
        configs.get_shape("train_8k")


@pytest.mark.parametrize("include_skipped", [False, True])
def test_cells_match_jax(include_skipped):
    got = configs.cells(include_skipped)
    assert got == jconfigs.cells(include_skipped)
    # long_500k only for the sub-quadratic archs (mamba2, jamba)
    assert len(configs.cells()) == 10 * 3 + 2
    if include_skipped:
        assert len(got) == 40
        assert sum(skipped for _, _, skipped in got) == 8


def _shape_of(sds):
    return tuple(sds.shape), np.dtype(sds.dtype).name


def _torch_of(t):
    assert t.device.type == "meta"
    return tuple(t.shape), str(t.dtype).removeprefix("torch.")


def _jax_params_by_port_name(tree, n_layers) -> dict:
    """The JAX params tree keyed by the port's parameter names: a
    ``blocks/pos0/...`` leaf [L, ...] becomes ``blocks.i....`` [...]."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        shape, dtype = _shape_of(leaf)
        if keys[0] == "blocks":
            for i in range(n_layers):
                out[".".join(["blocks", str(i)] + keys[2:])] = (shape[1:],
                                                               dtype)
        else:
            out[".".join(keys)] = (shape, dtype)
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_abstract_params_and_state_match_jax_eval_shape(arch):
    """Shapes as ``jax.eval_shape`` gives them; dtypes by the port's rule:
    serving weights in the compute dtype, training state as the JAX
    package's (params in ``param_dtype``, f32 m and v, int32 step)."""
    cfg = configs.get_config(arch)
    jmodel, model = jbuild_model(jconfigs.get_config(arch)), build_model(cfg)
    want = _jax_params_by_port_name(jsteps.abstract_params(jmodel),
                                    cfg.n_layers)
    params = steps.abstract_params(model)
    got = {k: _torch_of(p) for k, p in params.named_parameters()}
    assert {k: s for k, (s, _) in got.items()} == \
        {k: s for k, (s, _) in want.items()}
    assert {d for _, d in got.values()} == {cfg.compute_dtype}
    assert {d for _, d in want.values()} == {cfg.param_dtype}

    jstate = jsteps.abstract_state(jmodel)
    state = steps.abstract_state(model)
    got = {k: _torch_of(p) for k, p in state["params"].named_parameters()}
    assert got == _jax_params_by_port_name(jstate["params"], cfg.n_layers)
    for moment in ("m", "v"):
        assert {k: _torch_of(t) for k, t in state["opt_state"][
            moment].items()} == _jax_params_by_port_name(
                jstate["opt_state"][moment], cfg.n_layers)
    assert _torch_of(state["opt_state"]["step"]) == _shape_of(
        jstate["opt_state"]["step"])


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", DENSE)
def test_abstract_cache_matches_jax_eval_shape(arch, shape):
    cfg = configs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    jcache = jsteps.abstract_cache(jbuild_model(jcfg), jcfg,
                                   jconfigs.get_shape(shape))
    cache = steps.abstract_cache(build_model(cfg), cfg,
                                 configs.get_shape(shape))
    assert len(cache) == cfg.n_layers
    for name in ("k", "v"):
        (shape_l, dtype) = _shape_of(jcache["pos0"]["attn"][name])
        assert shape_l[0] == cfg.n_layers
        for layer in cache:
            assert _torch_of(layer[name]) == (shape_l[1:], dtype)


@pytest.mark.parametrize("for_decode", [False, True])
@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_abstract_batch_matches_jax(arch, shape, for_decode):
    want = jsteps.abstract_batch(jconfigs.get_config(arch),
                                 jconfigs.get_shape(shape), for_decode)
    got = steps.abstract_batch(configs.get_config(arch),
                               configs.get_shape(shape), for_decode)
    assert {k: _torch_of(t) for k, t in got.items()} == \
        {k: _shape_of(v) for k, v in want.items()}


def _small(kind_shape: str, b: int = 2, s: int = 16):
    return dataclasses.replace(configs.get_shape(kind_shape),
                               global_batch=b, seq_len=s)


def test_build_cell_runs_each_kind_on_the_cpu(capsys):
    cfg = configs.reduced(configs.get_config("yi-9b"))
    step, (state, batch) = steps.build_cell(cfg, _small("train_4k"),
                                            device="cpu")
    assert batch["tokens"].shape == (2, 16)
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state["opt_state"]["step"]) == 1
    out = capsys.readouterr().out
    assert "train_4k cut: seq_len 4096 -> 16, global_batch 256 -> 2" in out
    assert "yi-9b cut: n_layers 48 -> 2" in out

    prefill, (params, batch) = steps.build_cell(cfg, _small("prefill_32k"),
                                                device="cpu")
    logits, cache = prefill(params, batch)
    assert logits.shape == (2, cfg.vocab_size)
    assert cache[0]["k"].shape == (2, 16, cfg.n_kv_heads, cfg.head_dim)
    _, cache = prefill(params, batch, max_len=24)
    assert cache[0]["k"].shape[1] == 24
    # the uncut cell: 103.1 GB of KV cache, the reason for the cut
    assert "KV cache 103.1 GB" in capsys.readouterr().out

    decode, (params, tokens, cache, pos) = steps.build_cell(
        cfg, _small("decode_32k"), device="cpu")
    assert tokens.shape == (2, 1) and int(pos) == 15
    with torch.inference_mode():
        logits, cache = decode(params, tokens, cache, pos)
    assert logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert cache[0]["k"][:, 15].any() and not cache[0]["k"][:, :15].any()


def test_build_prefill_step_sizes_its_cache_as_the_jax():
    """``max_len = seq_len + n_prefix_embeds`` (the JAX builder's)."""
    cfg = configs.reduced(configs.get_config("chatglm3-6b"))
    prefill, args = steps.build_prefill_step(cfg, _small("prefill_32k", 1, 8),
                                             device="cpu")
    _, cache = prefill(*args)
    assert cache[0]["v"].shape[1] == 8 + cfg.n_prefix_embeds


def test_an_uncut_cell_prints_nothing(capsys):
    steps._cuts(configs.get_config("yi-9b"), configs.get_shape("decode_32k"))
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
def test_builders_without_a_card_raise(monkeypatch, shape):
    """No card and no ``device="cpu"``: raise before anything is drawn."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.build_cell("yi-9b", shape)
