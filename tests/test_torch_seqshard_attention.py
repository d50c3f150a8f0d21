"""The sequence-sharded attention in the port's training — a head count
the ``model`` ranks do not divide (``models.attention.attn_seqshard``:
each rank's query rows against the whole sequence's K/V, the weights
whole) — against the JAX package's ``_sdpa_seqshard`` under its mesh.

The port's steps run on 2 ranks (model=2) and 4 ranks (data=2,model=2,
and model=4) of a gloo process group on the CPU
(``tests/torch_train_workers.py``), on weights carried from the JAX
init and shared numpy batches.  The JAX package's
``make_train_step(ctx=MeshCtx(...))`` runs on the same meshes of host
devices in one subprocess (``test_torch_expert_parallel.JAX_SCRIPT``),
started when the module starts.

The cases are a reduced StarCoder2-7B (GELU FFN, d_head 16) with 3 query
and 1 KV head at model=2, and with 6 and 2 at model=4: at S = 128 · tp
the layer boundaries are sequence-sharded and attention runs on each
rank's S / tp query rows; at S = 17 attention runs whole on every rank.
One more case, at S = 512 on model=2, cuts each rank's 256 query rows
into two chunks of 128 (attention's ``SCORE_BUDGET_BYTES`` set to one
byte in its ranks).  Three steps in f32 each, at the limits of
``tests/test_torch_tensor_parallel.py``: loss, grad norm and lr within
``METRIC_RTOL`` of the JAX step's; after three steps m and v within
``MOMENT_TOL`` of each tensor's largest entry, and the params within
``PARAM_LR`` lr of the port's one-card step (all but 0.1% within 1e-3
lr) and within 2 lr of the JAX step's (all but 0.1% within ``PARAM_LR``
lr, at most ``FLIPS`` entries beyond).
"""
import functools

import numpy as np
import pytest
import torch

import torch_gloo_workers as workers
from repro_torch.models.lm import build_model, params_from_numpy
from repro_torch.roofline.analysis import sharded_step_wire
from test_torch_expert_parallel import read_jax, start_jax, stop_jax
from test_torch_sharded_train import (FLIPS, METRIC_RTOL, MOMENT_TOL,
                                      OCFG, PARAM_LR, SUITE, _by_port_name,
                                      _close_rel, _moments_close)
from test_torch_tensor_parallel import _cfgs, _tree

ARCH = "starcoder2-7b"
B, STEPS = 4, 3
HEADS2 = (("n_heads", 3), ("n_kv_heads", 1), ("d_head", 16))
HEADS4 = (("n_heads", 6), ("n_kv_heads", 2), ("d_head", 16))
M2 = ((1, 2), ("data", "model"))
D2M2 = ((2, 2), ("data", "model"))
M4 = ((1, 4), ("data", "model"))
# case name: (cfg overrides, S, the score budget of the port's ranks)
CASES = {
    "h3/sp": (HEADS2, 256, None),
    "h3/full": (HEADS2, 17, None),
    "h3/chunked": (HEADS2, 512, 1),
    "h6/sp": (HEADS4, 512, None),
    "h6/full": (HEADS4, 17, None),
}
# (case, world, mesh)
RUNS = [("h3/sp", 2, M2), ("h3/full", 2, M2), ("h3/chunked", 2, M2),
        ("h3/sp", 4, D2M2), ("h3/full", 4, D2M2),
        ("h6/sp", 4, M4), ("h6/full", 4, M4)]


@functools.lru_cache(maxsize=None)
def _batches(s):
    _, cfg = _cfgs(ARCH)
    return [{"tokens": np.random.default_rng(40 + t).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)} for t in range(STEPS)]


def _case(name, mesh):
    kw, s, budget = CASES[name]
    out = {"arch": ARCH, "mesh": mesh, "tree": _tree(ARCH, kw),
           "batches": _batches(s), "cfg_kw": dict(kw)}
    if budget is not None:
        out["score_budget"] = budget
    return out


def _key(name, mesh):
    return f"{name}@{mesh[0]}"


@pytest.fixture(scope="module", autouse=True)
def _jax_proc(tmp_path_factory):
    """The JAX subprocess, started as the module starts: its steps of
    every run on its mesh."""
    steps = {}
    for name, _, mesh in RUNS:
        case = _case(name, mesh)
        case.pop("score_budget", None)
        steps[_key(name, mesh)] = {**case, "mesh": mesh[0]}
    job = start_jax(tmp_path_factory.mktemp("jax_seq"),
                    {"ocfg": OCFG, "steps": steps})
    yield job
    stop_jax(job)


@pytest.fixture(scope="module")
def jax_seq(_jax_proc):
    return read_jax(_jax_proc)


@pytest.fixture(scope="module")
def gloo2(tmp_path_factory):
    """2 gloo ranks at model=2: its runs, and one step's counted
    collectives at S = 256."""
    tmp = tmp_path_factory.mktemp("seq2")
    payload = {
        "steps": {_key(n, m): _case(n, m) for n, w, m in RUNS if w == 2},
        "count": {"arch": ARCH, "mesh": M2, "tree": _tree(ARCH, HEADS2),
                  "batch": _batches(256)[0], "cfg_kw": dict(HEADS2)},
    }
    return {"ranks": workers.run(2, tmp, payload, suite=SUITE)}


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """4 gloo ranks: the runs at data=2,model=2 and at model=4, and one
    step's counted collectives at model=4, S = 512."""
    tmp = tmp_path_factory.mktemp("seq4")
    payload = {
        "steps": {_key(n, m): _case(n, m) for n, w, m in RUNS if w == 4},
        "count": {"arch": ARCH, "mesh": M4, "tree": _tree(ARCH, HEADS4),
                  "batch": _batches(512)[0], "cfg_kw": dict(HEADS4)},
    }
    return {"ranks": workers.run(4, tmp, payload, suite=SUITE)}


@functools.lru_cache(maxsize=None)
def _one_card(name):
    """The port's one-card step on the same carried weights and batches:
    params, m and v after the steps."""
    from repro_torch.train import optimizer as topt
    from repro_torch.train import trainstep
    kw, s, _ = CASES[name]
    _, cfg = _cfgs(ARCH, **dict(kw))
    params = params_from_numpy(cfg, _tree(ARCH, kw), device="cpu",
                               trainable=True)
    state = {"params": params, "opt_state": topt.adamw_init(
        dict(params.named_parameters()))}
    step = trainstep.make_train_step(build_model(cfg),
                                     topt.AdamWConfig(**OCFG))
    for b in _batches(s):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
    return {"params": {k: p.detach().numpy()
                       for k, p in state["params"].named_parameters()},
            "m": {k: t.numpy() for k, t in state["opt_state"]["m"].items()},
            "v": {k: t.numpy() for k, t in state["opt_state"]["v"].items()}}


RUN_IDS = [f"{n}-{'x'.join(map(str, m[0]))}" for n, _, m in RUNS]


@pytest.mark.parametrize("name,world,mesh", RUNS, ids=RUN_IDS)
def test_seqshard_steps_match_jax_and_one_card(request, jax_seq, name,
                                               world, mesh):
    """Three steps on the mesh against the JAX package's step on the same
    mesh (every step's loss, grad norm and lr, then the whole params, m
    and v) and against the port's one-card step."""
    key = _key(name, mesh)
    got = request.getfixturevalue(f"gloo{world}")["ranks"][0]["steps"][key]
    want = jax_seq["steps"][key]
    kw, _, _ = CASES[name]
    _, cfg = _cfgs(ARCH, **dict(kw))
    assert cfg.n_heads % mesh[0][1]
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in ("loss", "grad_norm", "lr"):
            _close_rel(g[k], w[k], METRIC_RTOL, (step, k))
    assert got["step"] == STEPS
    st = want["state"]
    lr = OCFG["lr"]
    whole, one = got["whole"], _one_card(name)
    jax_state = {"params": _by_port_name(st["params"], cfg),
                 "m": _by_port_name(st["opt_state"]["m"], cfg),
                 "v": _by_port_name(st["opt_state"]["v"], cfg)}
    flips = 0
    for k, p in whole["params"].items():
        d = np.abs(p - one["params"][k])
        assert d.max() <= PARAM_LR * lr, (k, d.max() / lr)
        assert (d > 1e-3 * lr).mean() <= 1e-3, k
        d = np.abs(p - jax_state["params"][k])
        assert d.max() <= 2 * lr, (k, d.max() / lr)
        assert (d > PARAM_LR * lr).mean() <= 1e-3, k
        flips += int((d > PARAM_LR * lr).sum())
    assert flips <= FLIPS, flips
    for ref in (one, jax_state):
        for key in ("m", "v"):
            _moments_close(whole[key], ref[key], key, MOMENT_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_reports_the_same_metrics(request, world):
    ranks = request.getfixturevalue(f"gloo{world}")["ranks"]
    for key in ranks[0]["steps"]:
        for r in ranks[1:]:
            assert r["steps"][key]["metrics"] == \
                ranks[0]["steps"][key]["metrics"], key
            assert r["steps"][key]["whole"] is None


@pytest.mark.parametrize("world", [2, 4])
def test_attention_weights_are_whole_over_model(request, world):
    """Where the ranks do not divide the heads the rules keep wq, wk, wv
    and wo whole over ``model`` (cut over ``data`` alone); the FFN and
    the vocabulary are cut over ``model`` as in any tensor-parallel
    step."""
    ranks = request.getfixturevalue(f"gloo{world}")["ranks"]
    for r in ranks:
        for key, res in r["steps"].items():
            name = key.split("@")[0]
            data = 2 if "(2, 2)" in key else 1
            tp = 4 // data if world == 4 else 2
            kw, _, _ = CASES[name]
            _, cfg = _cfgs(ARCH, **dict(kw))
            d, q = cfg.d_model, cfg.n_heads * cfg.head_dim
            kv = cfg.n_kv_heads * cfg.head_dim
            local = res["local_shapes"]
            dl = -(-d // data)
            assert local["blocks.0.attn.wq"] == (dl, q), key
            assert local["blocks.0.attn.wk"] == (dl, kv), key
            assert local["blocks.0.attn.wv"] == (dl, kv), key
            assert local["blocks.0.attn.wo"] == (q, dl), key
            assert local["blocks.0.ffn.w_in"] == (dl, cfg.d_ff // tp), key
            assert local["embed"] == (cfg.padded_vocab // tp, d), key


@pytest.mark.parametrize("world,mesh,kw,s", [(2, M2, HEADS2, 256),
                                             (4, M4, HEADS4, 512)])
def test_counted_wire_bytes_equal_the_ring_model(request, world, mesh, kw,
                                                 s):
    """One step's recorded collectives, by kind, equal
    ``sharded_step_wire``'s ring model: each attention layer all-gathers
    the boundary's rows forward (twice under remat) and reduce-scatters
    their gradient once, and nothing else; every all-gather over
    ``model`` moves one boundary piece [rows, S / tp, D]."""
    ranks = request.getfixturevalue(f"gloo{world}")["ranks"]
    _, cfg = _cfgs(ARCH, **dict(kw))
    tp = mesh[0][1]
    want = sharded_step_wire(cfg, {"data": 1, "model": tp}, B, s)
    for r in ranks:
        summary = r["count"]["summary"]
        assert summary["collective_wire_bytes"] == pytest.approx(
            want, rel=1e-12)
        for kind, nbytes, g, _, _, axis in r["count"]["log"]:
            if kind == "all-gather" and axis == "model":
                assert nbytes == B * s // tp * cfg.d_model * 4, nbytes
