"""Sequence-sharded flash-decode in the port
(``repro_torch.kernels.decode_attn.sharded``, ``serve/sharded.py``,
``launch/mesh.py``, ``models.common.MeshCtx`` and the ``ctx`` / ``shards``
arguments of the decode path) against the JAX package's
``repro.kernels.decode_attn.sharded`` and its models' ``decode_step(...,
shards=K)``, on shared numpy inputs and carried weights.

The static split runs in this process.  The collective merge runs on 2
and 4 ranks of a gloo process group on the CPU, each a process of its
own (``tests/torch_gloo_workers.py``, a ``FileStore`` under the test's
temporary directory), each rank holding only its slice of every cache;
one run of each size serves every check of that size.

The collective decode of the MoE is held against the JAX
``decode_step(ctx=, shards=2)`` under a (data=1, model=2) mesh, run in a
subprocess on 2 host devices: under a mesh context the JAX MoE runs
``moe_ep``, which drops each expert's overflow within each of the
``model`` ranks' slices of the tokens, and the port's follows it.  The
other models' reference is the JAX ``decode_step(shards=2)`` with no
mesh, the same function.

The JAX side runs in ``ref`` mode with an explicit ``StridingConfig`` on
both sides of the op, so no tune cache or plan memo left by another test
reaches the comparison.  Limits: the op in f32 at 1e-5 (the JAX package's
own, ``tests/test_decode_sharded.py``); a dense model's logits at 1e-4 and
the MoE and Whisper's at 2e-3 (``tests/test_torch_model.py``,
``tests/test_torch_families.py``); greedy tokens equal.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_gloo_workers as workers
from repro import configs as jconfigs
from repro.core.striding import StridingConfig as JConfig
from repro.kernels.decode_attn import ops as jops
from repro.kernels.decode_attn import sharded as jsharded
from repro.models.lm import build_model as jbuild_model
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels.decode_attn import ops as tops
from repro_torch.kernels.decode_attn import sharded as tsharded
from repro_torch.models import blocks
from repro_torch.models.lm import build_model, params_from_numpy
from repro_torch.serve import ServeConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
B, S, HQ, HKV, DH = 3, 64, 4, 2, 16
OP_TOL = 1e-5
CFG = dict(stride_unroll=2, portion_unroll=1)
KV_LENS = {"full": None,
           "ragged": np.array([S, S - 17, 23], np.int32),  # shard-unaligned
           "masked": np.array([5, 3, 1], np.int32)}        # shards 1.. empty
MODEL_TOL = {"yi-9b": 1e-4, "qwen3-moe-30b-a3b": 2e-3,
             "whisper-medium": 2e-3}
MAX_LEN = 16
# ragged rows whose positions fall on different ranks at 2 and 4 shards,
# then a scalar step
POS = [np.array([1, 6, 13], np.int32) + t for t in range(2)] + [np.int32(14)]
ENGINE_KW = dict(slots=2, max_len=32, max_new_tokens=5)


@pytest.fixture(autouse=True)
def _jax_ref_mode(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_MODE", "ref")


def _op_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, HQ, DH), (B, S, HKV, DH), (B, S, HKV, DH)))


def _jax_split(q, k, v, kv_len, shards, with_lse=False):
    return jsharded.decode_attn_sharded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=None if kv_len is None else jnp.asarray(kv_len),
        shards=shards, config=JConfig(**CFG), mode="ref", with_lse=with_lse)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# ------------------------------------------------------------- the op

@pytest.mark.parametrize("kv", list(KV_LENS))
@pytest.mark.parametrize("shards", [2, 4])
def test_static_split_matches_jax(shards, kv):
    q, k, v = _op_inputs()
    want = _jax_split(q, k, v, KV_LENS[kv], shards)
    got = tsharded.decode_attn_sharded(_t(q), _t(k), _t(v),
                                       kv_len=_t(KV_LENS[kv]), shards=shards,
                                       config=TConfig(**CFG), mode="ref")
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_static_split_with_lse_matches_jax(shards):
    q, k, v = _op_inputs(seed=5)
    kv_len = KV_LENS["ragged"]
    want_out, want_lse = _jax_split(q, k, v, kv_len, shards, with_lse=True)
    out, lse = tsharded.decode_attn_sharded(
        _t(q), _t(k), _t(v), kv_len=_t(kv_len), shards=shards,
        config=TConfig(**CFG), mode="ref", with_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=OP_TOL, atol=OP_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_merge_partials_matches_jax(shards):
    """Hand-split partials of the JAX oracle, with all-masked shards
    (lse about -1e30): the merge is finite and gives them weight 0."""
    q, k, v = _op_inputs(seed=9)
    kv_len = KV_LENS["masked"]
    sp = S // shards
    outs, lses = [], []
    for j in range(shards):
        o, lse = jops.decode_attn(
            jnp.asarray(q), jnp.asarray(k[:, j * sp:(j + 1) * sp]),
            jnp.asarray(v[:, j * sp:(j + 1) * sp]),
            kv_len=jnp.clip(jnp.asarray(kv_len) - j * sp, 0, sp),
            config=JConfig(**CFG), mode="ref", with_lse=True)
        outs.append(np.asarray(o))
        lses.append(np.asarray(lse))
    outs, lses = np.stack(outs), np.stack(lses)
    assert (lses[1:] < -1e29).all()
    want_out, want_lse = jsharded.merge_partials(jnp.asarray(outs),
                                                 jnp.asarray(lses))
    out, lse = tsharded.merge_partials(_t(outs), _t(lses))
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=OP_TOL, atol=OP_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=OP_TOL, atol=OP_TOL)
    one, _ = tsharded.merge_partials(_t(outs[:1]), _t(lses[:1]))
    np.testing.assert_array_equal(out.numpy(), one.numpy())


def test_dispatch_without_ctx_is_the_static_split():
    q, k, v = _op_inputs(seed=13)
    kv_len = _t(KV_LENS["ragged"])
    args = (_t(q), _t(k), _t(v))
    got = tsharded.dispatch(*args, kv_len=kv_len, shards=2, ctx=None,
                            config=TConfig(**CFG), mode="ref")
    want = tsharded.decode_attn_sharded(*args, kv_len=kv_len, shards=2,
                                        config=TConfig(**CFG), mode="ref")
    assert torch.equal(got, want)
    assert not tsharded.collective(None, 2)


def test_one_shard_is_the_unsharded_op_and_an_odd_split_raises():
    q, k, v = (_t(a) for a in _op_inputs(seed=2))
    kv_len = _t(KV_LENS["ragged"])
    for shards in (0, 1):
        assert torch.equal(
            tsharded.decode_attn_sharded(q, k, v, kv_len, shards=shards,
                                         config=TConfig(**CFG)),
            tops.decode_attn(q, k, v, kv_len, config=TConfig(**CFG)))
    with pytest.raises(ValueError, match="not divisible"):
        tsharded.decode_attn_sharded(q, k, v, kv_len, shards=3)


def test_static_split_reads_each_slice_in_place(monkeypatch):
    """Every shard's K and V are views of the whole cache's storage at
    their offset: no slice is copied to make it contiguous."""
    q, k, v = (_t(a) for a in _op_inputs(seed=4))
    seen = []
    real = tops.decode_attn

    def spy(q_, kc, vc, *args, **kw):
        seen.append((kc.untyped_storage().data_ptr(), kc.storage_offset(),
                     vc.untyped_storage().data_ptr(), kc.is_contiguous()))
        return real(q_, kc, vc, *args, **kw)
    monkeypatch.setattr(tops, "decode_attn", spy)
    tsharded.decode_attn_sharded(q, k, v, _t(KV_LENS["ragged"]), shards=4)
    e = HKV * DH
    assert seen == [(k.untyped_storage().data_ptr(), j * (S // 4) * e,
                     v.untyped_storage().data_ptr(), False)
                    for j in range(4)]


# ----------------------------------------------------------- the models

def _jcfg(arch):
    return dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                               compute_dtype="float32")


def _tcfg(arch):
    return dataclasses.replace(configs.reduced(configs.get_config(arch)),
                               compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _carried(arch, seed=0):
    """(JAX model, JAX params, the params as a numpy tree), made once per
    module run."""
    jmodel = jbuild_model(_jcfg(arch))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    return jmodel, jparams, jax.tree.map(np.asarray, jparams)


def _tokens(arch, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, _tcfg(arch).vocab_size, (B, 1)).astype(np.int32)
            for _ in POS]


@functools.lru_cache(maxsize=None)
def _jax_cross(arch):
    """Whisper's cross K/V of seeded frames: the JAX tree, and the port's
    per-layer list of numpy ``{"k", "v"}``."""
    jmodel, jparams, _ = _carried(arch)
    cfg = jmodel.cfg
    frames = np.random.default_rng(7).standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    jkv = jmodel.cross_kv(jparams, jmodel.encode(jparams, jnp.asarray(frames),
                                                 remat=False))
    port = [{n: np.asarray(jkv["pos0"][n][i]) for n in ("k", "v")}
            for i in range(cfg.n_layers)]
    return jkv, port


@functools.lru_cache(maxsize=None)
def _jax_steps(arch, shards):
    """The JAX ``decode_step(..., shards=shards)`` over :data:`POS` from
    an empty cache: each step's logits, and every layer's K and V after
    the last step ([B, MAX_LEN, Hkv, dh] each)."""
    jmodel, jparams, _ = _carried(arch)
    cfg = jmodel.cfg
    cache = jmodel.init_cache(B, MAX_LEN)
    if cfg.encdec:
        cache = {"self": cache, "cross": _jax_cross(arch)[0]}
    step = jax.jit(functools.partial(jmodel.decode_step, shards=shards))
    logits = []
    for toks, p in zip(_tokens(arch), POS):
        out, cache = step(jparams, jnp.asarray(toks), cache, jnp.asarray(p))
        logits.append(np.asarray(out))
    tree = cache["self"] if cfg.encdec else cache
    descs = blocks.layer_descriptors(_tcfg(arch))
    kv = {n: [np.asarray(tree[f"pos{i % len(descs)}"]["attn"][n]
                         [i // len(descs)])
              for i in range(cfg.n_layers)] for n in ("k", "v")}
    return logits, kv


_JAX_MESH_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["REPRO_KERNEL_MODE"] = "ref"
import dataclasses, functools
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config, reduced
from repro.models.common import MeshCtx
from repro.models.lm import build_model

inp = pickle.load(open(sys.argv[1], "rb"))
cfg = dataclasses.replace(reduced(get_config(inp["arch"])),
                          compute_dtype="float32")
model = build_model(cfg)
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
step = jax.jit(functools.partial(model.decode_step, ctx=MeshCtx(mesh),
                                 shards=2))
params = jax.tree.map(jnp.asarray, inp["tree"])
cache = model.init_cache(inp["b"], inp["max_len"])
logits = []
for toks, p in zip(inp["tokens"], inp["pos"]):
    out, cache = step(params, jnp.asarray(toks), cache, jnp.asarray(p))
    logits.append(np.asarray(out))
pickle.dump({"logits": logits, "cache": jax.tree.map(np.asarray, cache)},
            open(sys.argv[2], "wb"))
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def jax_mesh2(tmp_path_factory):
    """The JAX ``decode_step(ctx=, shards=2)`` of the MoE under a
    (data=1, model=2) mesh of 2 host devices, in a subprocess: each
    step's logits and every layer's K and V after the last, as
    :func:`_jax_steps` gives them."""
    import pickle
    arch = "qwen3-moe-30b-a3b"
    tmp = tmp_path_factory.mktemp("jax_mesh2")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"arch": arch, "tree": _carried(arch)[2],
                     "tokens": _tokens(arch), "pos": POS, "b": B,
                     "max_len": MAX_LEN}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", _JAX_MESH_SCRIPT, str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    assert "JAX_OK" in res.stdout, res.stdout[-2000:] + res.stderr[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        out = pickle.load(f)
    descs = blocks.layer_descriptors(_tcfg(arch))
    tree = out["cache"]
    kv = {n: [tree[f"pos{i % len(descs)}"]["attn"][n][i // len(descs)]
              for i in range(_tcfg(arch).n_layers)] for n in ("k", "v")}
    return {arch: (out["logits"], kv)}


def _model_case(arch):
    case = {"tree": _carried(arch)[2], "tokens": _tokens(arch), "pos": POS,
            "max_len": MAX_LEN}
    if _tcfg(arch).encdec:
        case["cross"] = _jax_cross(arch)[1]
    return case


@pytest.mark.parametrize("arch", list(MODEL_TOL))
def test_static_decode_steps_match_jax(arch):
    """``decode_step(shards=2)`` with no ctx (the static split over the
    whole cache) against the JAX ``decode_step(shards=2)``: logits each
    step, the cache after."""
    want_logits, want_kv = _jax_steps(arch, 2)
    cfg = _tcfg(arch)
    model = build_model(cfg)
    params = params_from_numpy(cfg, _carried(arch)[2], device="cpu")
    cache = model.init_cache(B, MAX_LEN, device="cpu")
    if cfg.encdec:
        cache = {"self": cache, "cross": [
            {n: _t(c[n]) for n in ("k", "v")} for c in _jax_cross(arch)[1]]}
    tol = MODEL_TOL[arch]
    with torch.inference_mode():
        for i, (toks, p) in enumerate(zip(_tokens(arch), POS)):
            got, cache = model.decode_step(params, _t(toks), cache,
                                           torch.as_tensor(p), shards=2)
            np.testing.assert_allclose(got.numpy(), want_logits[i],
                                       rtol=tol, atol=tol,
                                       err_msg=f"step {i}")
    layers = cache["self"] if cfg.encdec else cache
    for n in ("k", "v"):
        for layer, c in enumerate(layers):
            np.testing.assert_allclose(c[n].numpy(), want_kv[n][layer],
                                       rtol=tol, atol=tol)


# ------------------------------------------------- the collective merge

@pytest.fixture(scope="module")
def gloo2(tmp_path_factory):
    """One run of 2 gloo ranks: the op, the three models, the engine, the
    launcher and the meshes."""
    q, k, v = _op_inputs()
    payload = {
        "op": {"q": q, "k": k, "v": v, "kv_lens": list(KV_LENS.values())},
        "models": {arch: _model_case(arch) for arch in MODEL_TOL},
        "engine": {"tree": _carried("yi-9b", seed=1)[2],
                   "prompts": _prompts(), "kw": ENGINE_KW},
    }
    return workers.run(2, tmp_path_factory.mktemp("gloo2"), payload)


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """One run of 4 gloo ranks: the op and the dense model."""
    q, k, v = _op_inputs()
    payload = {"op": {"q": q, "k": k, "v": v,
                      "kv_lens": list(KV_LENS.values())},
               "models": {"yi-9b": _model_case("yi-9b")}}
    return workers.run(4, tmp_path_factory.mktemp("gloo4"), payload)


@pytest.fixture
def gloo(request):
    return request.getfixturevalue(f"gloo{request.param}")


@pytest.mark.parametrize("gloo", [2, 4], indirect=True)
def test_every_rank_holds_its_place_on_the_model_axis(gloo):
    assert [(r["tp"], r["tp_rank"]) for r in gloo] == [
        (len(gloo), i) for i in range(len(gloo))]


@pytest.mark.parametrize("gloo", [2, 4], indirect=True)
def test_collective_op_matches_jax_static_split(gloo):
    """``decode_attn_collective`` on each rank's own slice, every rank's
    merged output against the JAX static split of the whole cache."""
    q, k, v = _op_inputs()
    for i, kv_len in enumerate(KV_LENS.values()):
        want = np.asarray(_jax_split(q, k, v, kv_len, len(gloo)))
        for rank in gloo:
            got = rank["op"][i]
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=OP_TOL, atol=OP_TOL)


def _gathered(gloo, arch, name):
    """Each layer's K or V of ``arch``, the ranks' slices in rank order."""
    return [np.concatenate([r["models"][arch][name][layer] for r in gloo],
                           axis=1)
            for layer in range(len(gloo[0]["models"][arch][name]))]


@pytest.mark.parametrize("gloo", [2, 4], indirect=True)
def test_rank_local_cache_writes_gather_to_the_jax_cache(gloo):
    """Scalar and vector ``pos`` whose rows fall on different ranks: each
    rank keeps a [B, S/K] slice, and the slices in rank order equal the
    JAX cache after the same steps."""
    k = len(gloo)
    _, want = _jax_steps("yi-9b", k)
    for name in ("k", "v"):
        for rank in gloo:
            assert all(c.shape[1] == MAX_LEN // k
                       for c in rank["models"]["yi-9b"][name])
        for layer, got in enumerate(_gathered(gloo, "yi-9b", name)):
            np.testing.assert_allclose(got, want[name][layer], rtol=1e-4,
                                       atol=1e-4)
            # the rows the steps wrote, and no other
            written = {(r, int(p if np.ndim(p) == 0 else p[r]))
                       for p in POS for r in range(B)}
            assert np.count_nonzero(np.abs(got).sum(axis=(2, 3))) == len(
                written)


@pytest.mark.parametrize("arch", list(MODEL_TOL))
def test_collective_decode_steps_match_jax(request, gloo2, arch):
    """``decode_step(shards=2)`` over 2 ranks' local caches: every rank's
    logits each step against the JAX ``decode_step(shards=2)`` (for the
    MoE, under its (data=1, model=2) mesh: ``jax_mesh2``), and the
    gathered cache against the JAX cache."""
    if _tcfg(arch).moe is not None:
        want_logits, want_kv = request.getfixturevalue("jax_mesh2")[arch]
    else:
        want_logits, want_kv = _jax_steps(arch, 2)
    tol = MODEL_TOL[arch]
    for rank in gloo2:
        for i, got in enumerate(rank["models"][arch]["logits"]):
            np.testing.assert_allclose(got, want_logits[i], rtol=tol,
                                       atol=tol, err_msg=f"step {i}")
    for name in ("k", "v"):
        for layer, got in enumerate(_gathered(gloo2, arch, name)):
            np.testing.assert_allclose(got, want_kv[name][layer], rtol=tol,
                                       atol=tol)


# ----------------------------------------------------------- the engine

def _prompts():
    rng = np.random.default_rng(1)
    return {uid: rng.integers(0, 512, int(rng.integers(2, 7)))
            for uid in range(5)}


@functools.lru_cache(maxsize=None)
def _jax_engine_tokens():
    jmodel, jparams, _ = _carried("yi-9b", seed=1)
    eng = JServingEngine(jmodel, jparams, JServeConfig(shards=2,
                                                       **ENGINE_KW))
    for uid, p in _prompts().items():
        eng.submit(uid, p)
    return eng.run()


def _port_engine(shards):
    cfg = _tcfg("yi-9b")
    model = build_model(cfg)
    params = params_from_numpy(cfg, _carried("yi-9b", seed=1)[2],
                               device="cpu")
    eng = ServingEngine(model, params, ServeConfig(shards=shards,
                                                   **ENGINE_KW))
    for uid, p in _prompts().items():
        eng.submit(uid, p)
    return eng, eng.run()


def test_static_engine_gives_the_unsharded_and_the_jax_tokens():
    eng, got = _port_engine(2)
    assert eng.cache[0]["k"].shape[1] == ENGINE_KW["max_len"]
    assert got == _port_engine(1)[1] == _jax_engine_tokens()
    assert all(len(t) == ENGINE_KW["max_new_tokens"] for t in got.values())


def test_collective_engine_gives_the_unsharded_and_the_jax_tokens(gloo2):
    """Every rank of 2 returns the same tokens, those of the port's
    shards=1 engine and of the JAX engine at shards=2, from caches of
    half the sequence."""
    want = _jax_engine_tokens()
    assert want == _port_engine(1)[1]
    steps = None
    for rank in gloo2:
        assert rank["engine"]["results"] == want
        assert rank["engine"]["cache_len"] == ENGINE_KW["max_len"] // 2
        steps = steps or rank["engine"]["steps"]
        assert rank["engine"]["steps"] == steps


def test_launcher_over_gloo_serves_the_one_process_tokens(gloo2):
    from repro_torch.launch import serve
    want = serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                       "4"])
    assert [r["launcher"] for r in gloo2] == [want, want]


# ----------------------------------------------------- mesh and refusals

def test_make_mesh_and_mesh_ctx_on_two_ranks(gloo2):
    for i, rank in enumerate(gloo2):
        m = rank["mesh"]
        assert m["names"] == ("data", "model") and m["sizes"] == (1, 2)
        assert (m["tp"], m["tp_rank"]) == (2, i)
        assert m["batch_axes"] == ("data",)


def test_a_group_of_the_wrong_size_is_refused(gloo2):
    for rank in gloo2:
        m = rank["mesh"]
        assert m["wrong_shards"].startswith("ValueError"), m
        assert "4 ranks, not 2" in m["wrong_shards"]
        assert m["wrong_mesh"].startswith("ValueError"), m
        assert m["production"].startswith("ValueError"), m
        assert m["prefill"].startswith("NotImplementedError"), m


def test_no_group_serves_the_static_split():
    from repro_torch.serve import resolve_serving_mesh, serving_ctx
    assert not torch.distributed.is_initialized()
    assert resolve_serving_mesh(4) is None and serving_ctx(4) is None
    assert serving_ctx(1) is None


def test_importing_launch_mesh_touches_no_process_group():
    code = ("import torch.distributed as d\n"
            "import repro_torch.launch.mesh as m, repro_torch.serve.sharded\n"
            "assert not d.is_initialized()\n"
            "from torch.distributed.device_mesh import DeviceMesh\n"
            "assert not [x for x in vars(m).values()\n"
            "            if isinstance(x, DeviceMesh)]\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
