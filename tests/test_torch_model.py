"""The port's serving slice (Yi-9B layout at reduced size) against the
JAX package on carried weights, plus the package's import and device
rules.

Weights: the JAX ``CausalLM.init`` tree, converted to numpy and loaded
with ``params_from_numpy``; tokens and positions come from seeded numpy.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models.lm import CausalLM as JCausalLM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_config, reduced
from repro_torch.models.lm import build_model, params_from_numpy
from repro_torch.serve import ServeConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]


def _cfgs(compute_dtype):
    jcfg = dataclasses.replace(jreduced(jget_config("yi-9b")),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(reduced(get_config("yi-9b")),
                               compute_dtype=compute_dtype)
    return jcfg, tcfg


def _carried(compute_dtype, seed=0):
    jcfg, tcfg = _cfgs(compute_dtype)
    jmodel = JCausalLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, build_model(tcfg), params_from_numpy(
        tcfg, tree, device="cpu")


def test_reduced_config_matches_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
            tcfg.head_dim) == (2, 64, 4, 2, 16)
    full = get_config("yi-9b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.padded_vocab) == (
                48, 4096, 32, 4, 128, 11008, 64000)
    assert full.n_params() == jget_config("yi-9b").n_params()


# bf16: the packages round the same f32 weights to bf16 alike, but their
# bf16 activations round at other points (matmul accumulation, silu,
# RoPE in f32 then cast), which after two layers and the head moves
# logits by up to a few bf16 ulps of the logit scale
@pytest.mark.parametrize("compute_dtype,atol",
                         [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_decode_steps_match_jax(compute_dtype, atol):
    jmodel, jparams, tmodel, tparams = _carried(compute_dtype)
    cfg = tmodel.cfg
    rng = np.random.default_rng(0)
    b = 3
    pos = np.array([0, 3, 7], np.int32)          # ragged per-row lengths
    jcache = jmodel.init_cache(b, 16)
    tcache = tmodel.init_cache(b, 16, device="cpu")
    jstep = jax.jit(jmodel.decode_step)
    for step in range(4):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jlogits, jcache = jstep(jparams, jnp.asarray(toks), jcache,
                                jnp.asarray(pos + step))
        with torch.inference_mode():
            tlogits, tcache = tmodel.decode_step(
                tparams, torch.from_numpy(toks), tcache,
                torch.from_numpy(pos + step))
        assert tlogits.shape == (b, cfg.vocab_size)
        np.testing.assert_allclose(tlogits.float().numpy(),
                                   np.asarray(jlogits, np.float32),
                                   rtol=atol, atol=atol)
    # the in-place cache holds what the JAX step returned
    np.testing.assert_allclose(
        tcache[1]["k"].float().numpy(),
        np.asarray(jcache["pos0"]["attn"]["k"][1], np.float32),
        rtol=atol, atol=atol)


def test_serving_engine_matches_jax_greedy_tokens():
    jmodel, jparams, tmodel, tparams = _carried("float32", seed=1)
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


def test_port_init_is_seeded_and_runs():
    model = build_model(reduced(get_config("yi-9b")))
    a, b = model.init(seed=3, device="cpu"), model.init(seed=3, device="cpu")
    for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                  b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert a.embed.dtype == torch.bfloat16        # stored in compute dtype
    assert float(a.blocks[0].attn.wq.float().abs().max()) <= 2.0 / 8 + 1e-6
    cache = model.init_cache(2, 8, device="cpu")
    with torch.inference_mode():
        logits, _ = model.decode_step(a, torch.zeros(2, 1, dtype=torch.long),
                                      cache, torch.tensor([0, 3]))
    assert logits.shape == (2, 512) and torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ["yi-9b", "mistral-large-123b",
                                  "chatglm3-6b", "starcoder2-7b"])
def test_dense_archs_decode_on_cpu(arch):
    model = build_model(reduced(get_config(arch)))
    params = model.init(seed=0, device="cpu")
    cache = model.init_cache(2, 8, device="cpu")
    with torch.inference_mode():
        logits, _ = model.decode_step(params, torch.ones(2, 1,
                                                         dtype=torch.long),
                                      cache, torch.tensor([1, 4]))
    assert torch.isfinite(logits).all()


# ---------------------------------------------------- device and imports

def test_entry_points_without_a_card_raise(monkeypatch):
    """No card and no explicit device="cpu": raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(reduced(get_config("yi-9b")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(model.cfg, {}, device=None)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])


def test_launcher_serves_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    results = serve.main(["--device", "cpu", "--requests", "2",
                          "--max-new", "3"])
    assert sorted(results) == [0, 1]
    assert all(len(v) == 3 for v in results.values())
    assert "req 1: 3 tokens" in capsys.readouterr().out


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "for fam in ('mxv', 'bicg', 'gemver'):\n"
        "    for mod in ('specs', 'ref', 'ops'):\n"
        "        assert f'repro_torch.kernels.{fam}.{mod}' in sys.modules\n"
        "assert 'repro_torch.kernels.mxv.kernel' in sys.modules\n"
        "assert 'repro_torch.kernels.gemver.kernel' in sys.modules\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def test_no_port_source_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                    f"{path.relative_to(ROOT)} imports {name}")


def test_batched_ragged_serving_equals_isolated():
    """Slots at different lengths share one batched step: each request
    yields the same tokens as when it is served alone (f32 compute)."""
    _, _, model, params = _carried("float32", seed=2)
    rng = np.random.default_rng(2)
    prompts = {uid: rng.integers(0, 512, n) for uid, n in
               enumerate((2, 5, 3))}
    kw = dict(max_len=32, max_new_tokens=5)
    batched = ServingEngine(model, params, ServeConfig(slots=3, **kw))
    for uid, p in prompts.items():
        batched.submit(uid, p)
    together = batched.run()
    for uid, p in prompts.items():
        alone = ServingEngine(model, params, ServeConfig(slots=1, **kw))
        alone.submit(uid, p)
        assert alone.run()[uid] == together[uid]
