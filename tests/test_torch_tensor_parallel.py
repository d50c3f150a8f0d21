"""Tensor parallelism in the port's training — Megatron heads and FFN
over ``model``, the vocab-parallel embedding, head and loss, the
sequence-parallel layer boundaries (``models.common.tp_layout``), ZeRO-3
over ``data`` within each ``model`` block (``train.zero``) — and the
MoE's capacity rule under a mesh (``models.moe.moe_forward(ctx)``),
against the JAX package.

The port's steps run on 2 ranks (model=2) and 4 ranks (data=2,model=2)
of a gloo process group on the CPU (``tests/torch_train_workers.py``,
spawned once per world size, and once more on one rank for the
restore), on weights carried from the JAX init and shared numpy
batches; each rank holds only its pieces.  The JAX package's
``make_train_step(ctx=MeshCtx(...))`` runs on the same ("data", "model")
meshes of host devices in one subprocess (``--xla_force_host_platform_
device_count=4``), started when the module starts and read when a test
needs it.

Each case runs three steps of a reduced config in f32: Yi-9B (GQA, 4
query and 2 KV heads), InternVL2-2B (a prefix of 4 embeddings before
the tokens) and Mamba2-2.7B (Mamba-2 mixers, which the rules keep whole
over ``model``; a tied head), at S = 256, where S / tp >= 128 shards the
layer boundaries' sequence, and at S = 17, where it does not; and Yi-9B
with one KV head (the rules leave wk and wv whole at n_kv_heads < tp)
and d_ff = 129 (the rules leave the FFN whole where tp does not divide
it).  Limits are ``tests/test_torch_sharded_train.py``'s: loss, grad norm
and lr of every step within 1e-5 relative of the JAX step's (and so of
the port's one-card step's); after three steps m and v within 5e-4 of
each tensor's largest entry (``MOMENT_TOL``) of both, and the params:

* against the port's one-card step, every entry within 0.25 lr
  (``PARAM_LR``) and all but 0.1% of each tensor's within 1e-3 lr
  (``_params_close``'s rule for the bulk).  Tensor parallelism sums
  every attention and FFN output and the loss's lse in another order,
  and at S = 17 (64 tokens a step) an entry whose gradient is near
  AdamW's eps then takes its update anywhere in about [-1, 1] lr (as
  ``_params_close`` says): the TP step's entries lie up to 0.075 lr and
  its m up to 1.24e-4 of the largest from the one-card step's
  (InternVL2-2B, model=2), as close as the one-card step lies to the
  JAX step (0.135 lr, 2.2e-4), and the TP step lies closer to the JAX
  step than the one-card step does (0.060 lr, 9.7e-5);
* against the JAX step on the same mesh, as the compressed step's test
  holds its flips: every entry within 2 lr, all but 0.1% of each
  tensor's within 0.25 lr, and at most ``FLIPS`` entries over all
  tensors beyond it.  One is seen: Yi-9B at S = 17 on the
  (data=2, model=2) mesh, embed[371, 57] (token 371 occurs once, its
  gradient entry near eps at step 1) lies 1.27 lr from the JAX mesh
  step's for the one-card port and the TP step alike, which lie 0.026
  lr apart; the one-card port and the JAX step on one device agree
  there (``tests/test_torch_sharded_train.py``, the same batches).

All measured on these inputs.  At S = 256 every pair lies within 0.013
lr and 8.6e-6.
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_gloo_workers as workers
from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import build_model, params_from_numpy
from repro_torch.roofline.analysis import sharded_step_wire
from test_torch_sharded_train import (FLIPS, METRIC_RTOL, MOMENT_TOL,
                                      OCFG, PARAM_LR, SUITE, _by_port_name,
                                      _close_rel, _moments_close)

ROOT = Path(__file__).resolve().parents[1]
B, STEPS = 4, 3
SEQ = {"sp": 256, "full": 17}
KV1 = (("n_kv_heads", 1), ("d_ff", 129))
# case name: (arch, its seq key, cfg overrides)
CASES = {f"{a}/{s}": (a, s, ()) for a in ("yi-9b", "internvl2-2b",
                                         "mamba2-2.7b") for s in SEQ}
CASES.update({f"yi-9b-kv1/{s}": ("yi-9b", s, KV1) for s in SEQ})
MESHES = {2: ((1, 2), ("data", "model")), 4: ((2, 2), ("data", "model"))}
LAUNCH = ["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "256",
          "--log-every", "1"]
MOE = "qwen3-moe-30b-a3b"
MOE_TOL = 1e-5


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                               compute_dtype="float32", **kw)
    tcfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                               compute_dtype="float32", **kw)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _tree(arch, kw=()):
    from repro.models.lm import build_model as jbuild_model
    jcfg, _ = _cfgs(arch, **dict(kw))
    return jax.tree.map(np.asarray,
                        jbuild_model(jcfg).init(jax.random.PRNGKey(3)))


@functools.lru_cache(maxsize=None)
def _batches(arch, seq):
    _, cfg = _cfgs(arch)
    out = []
    for t in range(STEPS):
        rng = np.random.default_rng(40 + t)
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, SEQ[seq]))
             .astype(np.int32)}
        if cfg.n_prefix_embeds:
            b["prefix_embeds"] = rng.standard_normal(
                (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _case(name, world):
    arch, seq, kw = CASES[name]
    return {"arch": arch, "mesh": MESHES[world], "tree": _tree(arch, kw),
            "batches": _batches(arch, seq), "cfg_kw": dict(kw)}


@functools.lru_cache(maxsize=None)
def _moe_inputs():
    """(read only) The reduced Qwen3-MoE's MoE layer (f32) with 0.5 added to router
    column 0, and x >= 0: expert 0 takes most picks and overflows."""
    from repro.models.lm import build_model as jbuild_model
    jcfg, _ = _cfgs(MOE)
    layer = jbuild_model(jcfg).init(jax.random.PRNGKey(0))["blocks"][
        "pos0"]["moe"]
    tree = {k: np.array(layer[k][0]) for k in ("router", "w_in", "w_gate",
                                                "w_out")}
    tree["router"][:, 0] += 0.5
    x = np.abs(np.random.default_rng(1).standard_normal(
        (4, 16, jcfg.d_model))).astype(np.float32)
    return tree, x


# ------------------------------------------------------ the JAX meshes

_JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config, reduced
from repro.models import moe
from repro.models.common import MeshCtx
from repro.models.lm import build_model
from repro.train import optimizer as opt
from repro.train.trainstep import make_train_step

inp = pickle.load(open(sys.argv[1], "rb"))


def mesh_of(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:int(np.prod(shape))])


out = {"steps": {}, "moe": {}}
for key, case in inp["steps"].items():
    cfg = dataclasses.replace(reduced(get_config(case["arch"])),
                              compute_dtype="float32", **case["cfg_kw"])
    model = build_model(cfg)
    params = jax.tree.map(jnp.asarray, case["tree"])
    state = {"params": params, "opt_state": opt.adamw_init(params)}
    step = jax.jit(make_train_step(model, opt.AdamWConfig(**inp["ocfg"]),
                                   ctx=MeshCtx(mesh_of(case["mesh"]))))
    metrics = []
    for b in case["batches"]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    out["steps"][key] = {"metrics": metrics,
                         "state": jax.tree.map(np.asarray, state)}

cfg = dataclasses.replace(reduced(get_config(inp["moe"]["arch"])),
                          compute_dtype="float32")
p = jax.tree.map(jnp.asarray, inp["moe"]["tree"])
x = jnp.asarray(inp["moe"]["x"])
for tp in (1, 2):
    y, aux = moe.moe_forward(p, x, cfg, MeshCtx(mesh_of((1, tp))))
    out["moe"][tp] = (np.asarray(y), float(aux))
y, aux = moe.moe_dense(p, x, cfg)
out["moe"]["dense"] = (np.asarray(y), float(aux))
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX_OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_proc(tmp_path_factory):
    """The JAX subprocess, started as the module starts (it runs while
    the gloo ranks do): its TP steps for every case on both meshes, and
    ``moe_forward`` under a (1, 1) and a (1, 2) mesh and ``moe_dense`` on
    the skewed input."""
    tmp = tmp_path_factory.mktemp("jax_tp")
    tree, x = _moe_inputs()
    inp = {"ocfg": OCFG,
           "steps": {f"{name}@{w}": {**_case(name, w),
                                     "mesh": MESHES[w][0]}
                     for name in CASES for w in MESHES},
           "moe": {"arch": MOE, "tree": tree, "x": x}}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    yield {"proc": proc, "out": tmp / "out.pkl"}
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_tp(_jax_proc):
    stdout, stderr = _jax_proc["proc"].communicate(timeout=900)
    assert "JAX_OK" in stdout, stdout[-2000:] + stderr[-4000:]
    with open(_jax_proc["out"], "rb") as f:
        return pickle.load(f)


# ------------------------------------------------------ the gloo ranks

@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """One run of 4 gloo ranks at data=2,model=2: every case's three
    steps, the uninterrupted run that saves a checkpoint after two, one
    step's counted collectives, and the launcher."""
    tmp = tmp_path_factory.mktemp("tp4")
    payload = {
        "steps": {name: _case(name, 4) for name in CASES},
        "save": {"arch": "yi-9b", "mesh": MESHES[4],
                 "tree": _tree("yi-9b"), "batches": _batches("yi-9b", "sp"),
                 "directory": str(tmp / "ckpt"), "save_after": 2},
        "count": {"arch": "yi-9b", "mesh": MESHES[4],
                  "tree": _tree("yi-9b"),
                  "batch": _batches("yi-9b", "sp")[0]},
        "launcher": {"argv": LAUNCH + ["--mesh", "data=2,model=2",
                                       "--ckpt-dir", str(tmp / "launch")]},
    }
    return {"ranks": workers.run(4, tmp, payload, suite=SUITE),
            "ckpt": str(tmp / "ckpt")}


@pytest.fixture(scope="module")
def gloo2(tmp_path_factory, gloo4):
    """One run of 2 gloo ranks at model=2: every case's three steps, one
    step's counted collectives without sequence sharding, the MoE layer
    under ``serving_ctx(2)``, and the 4-rank checkpoint restored at
    data=2 and run on."""
    tmp = tmp_path_factory.mktemp("tp2")
    tree, x = _moe_inputs()
    payload = {
        "steps": {name: _case(name, 2) for name in CASES},
        "count": {"arch": "yi-9b", "mesh": MESHES[2],
                  "tree": _tree("yi-9b", KV1),
                  "batch": _batches("yi-9b", "full")[0],
                  "cfg_kw": dict(KV1)},
        "moe": {"tree": tree, "x": x},
        "restore": {"arch": "yi-9b", "directory": gloo4["ckpt"],
                    "batches": _batches("yi-9b", "sp")[2:], "world": 2},
    }
    return {"ranks": workers.run(2, tmp, payload, suite=SUITE)}


@pytest.fixture(scope="module")
def gloo1(tmp_path_factory, gloo4):
    """One rank: the 4-rank checkpoint restored whole and run on, and
    the MoE layer under ``serving_ctx(1)``."""
    tmp = tmp_path_factory.mktemp("tp1")
    tree, x = _moe_inputs()
    payload = {
        "steps": {},
        "moe": {"tree": tree, "x": x},
        "restore": {"arch": "yi-9b", "directory": gloo4["ckpt"],
                    "batches": _batches("yi-9b", "sp")[2:], "world": 1},
    }
    return {"ranks": workers.run(1, tmp, payload, suite=SUITE)}


@pytest.fixture
def gloo(request):
    return request.getfixturevalue(f"gloo{request.param}")


@functools.lru_cache(maxsize=None)
def _one_card(name):
    """The port's one-card step on the same carried weights and batches:
    params, m and v after the steps."""
    from repro_torch.train import optimizer as topt
    from repro_torch.train import trainstep
    arch, seq, kw = CASES[name]
    _, cfg = _cfgs(arch, **dict(kw))
    params = params_from_numpy(cfg, _tree(arch, kw), device="cpu",
                               trainable=True)
    state = {"params": params, "opt_state": topt.adamw_init(
        dict(params.named_parameters()))}
    step = trainstep.make_train_step(build_model(cfg),
                                     topt.AdamWConfig(**OCFG))
    for b in _batches(arch, seq):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
    return {"params": {k: p.detach().numpy()
                       for k, p in state["params"].named_parameters()},
            "m": {k: t.numpy() for k, t in state["opt_state"]["m"].items()},
            "v": {k: t.numpy() for k, t in state["opt_state"]["v"].items()}}


CASE_IDS = [f"{n}-{w}ranks" for w in MESHES for n in CASES]
CASE_ARGS = [(n, w) for w in MESHES for n in CASES]


@pytest.mark.parametrize("name,world", CASE_ARGS, ids=CASE_IDS)
def test_tp_steps_match_jax_and_one_card(request, jax_tp, name, world):
    """Three tensor-parallel steps (model=2, or data=2,model=2) against the
    JAX package's step on the same mesh: every step's loss, grad norm
    and lr, then the whole params, m and v; and against the port's
    one-card step."""
    got = request.getfixturevalue(f"gloo{world}")["ranks"][0]["steps"][name]
    want = jax_tp["steps"][f"{name}@{world}"]
    arch, _, kw = CASES[name]
    _, cfg = _cfgs(arch, **dict(kw))
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


@pytest.mark.parametrize("gloo", [2, 4], indirect=True)
def test_every_rank_reports_the_same_metrics(gloo):
    """Loss and grad norm are the global batch's on every rank of every
    model and data line; only rank 0 brings back whole tensors."""
    ranks = gloo["ranks"]
    for key in ranks[0]["steps"]:
        first = ranks[0]["steps"][key]["metrics"]
        for r in ranks[1:]:
            assert r["steps"][key]["metrics"] == first, key
            assert r["steps"][key]["whole"] is None


def _piece(name, shape, cfg, data, tp):
    """The rules' piece of a parameter of ``shape``: ceil(D / data) of a
    dim cut over data, D / tp of a dim cut over model."""
    w = list(shape)

    def fsdp(dim):
        w[dim] = -(-w[dim] // data)

    def model(dim, ok=True):
        if ok:
            w[dim] //= tp
    kv_ok, ff_ok = cfg.n_kv_heads % tp == 0, cfg.d_ff % tp == 0
    if name == "embed":
        model(0)
    elif name == "head":
        model(1)
    elif name.endswith("attn.wq"):
        fsdp(0), model(1)
    elif name.endswith(("attn.wk", "attn.wv")):
        fsdp(0), model(1, kv_ok)
    elif name.endswith("attn.wo"):
        model(0), fsdp(1)
    elif name.endswith(("ffn.w_in", "ffn.w_gate")):
        fsdp(0), model(1, ff_ok)
    elif name.endswith("ffn.w_out"):
        model(0, ff_ok), fsdp(1)
    elif name.endswith("mamba.in_proj"):
        fsdp(0)
    elif name.endswith("mamba.out_proj"):
        fsdp(1)
    return w


@pytest.mark.parametrize("gloo", [2, 4], indirect=True)
def test_local_shapes_are_the_rules_pieces(gloo):
    """Each rank holds its data piece of its model block: wq, wk, wv,
    w_in and w_gate by columns over model (wk, wv only where model
    divides the KV heads, the FFN only where it divides d_ff) and by rows
    over data; wo and w_out the other way round; embed's vocabulary rows
    and head's vocabulary columns over model; Mamba-2 over data alone;
    the norms whole."""
    ranks = gloo["ranks"]
    (data, tp), _ = MESHES[len(ranks)]
    for name, res in ranks[0]["steps"].items():
        arch, _, kw = CASES[name]
        _, cfg = _cfgs(arch, **dict(kw))
        meta = dict(build_model(cfg).init(device="meta",
                                          trainable=True).named_parameters())
        for k, shape in res["local_shapes"].items():
            assert list(shape) == _piece(k, meta[k].shape, cfg, data, tp), \
                (name, k, shape)


def test_labels_fall_on_each_ranks_vocabulary():
    """The loss takes each label's logit from the model rank that holds
    its column: at model=2 the batches' labels fall on both ranks'
    halves of the vocabulary."""
    _, cfg = _cfgs("yi-9b")
    half = cfg.padded_vocab // 2
    for seq in SEQ:
        labels = np.concatenate([b["tokens"][:, 1:].ravel()
                                 for b in _batches("yi-9b", seq)])
        assert (labels < half).any() and (labels >= half).any(), seq


@pytest.mark.parametrize("gloo,case", [(4, "yi-9b/sp"),
                                       (2, "yi-9b-kv1/full")],
                         indirect=["gloo"])
def test_counted_wire_bytes_equal_the_ring_model(gloo, case):
    """One step's recorded collectives, by kind, equal
    ``roofline.analysis.sharded_step_wire``'s ring model of the layout:
    at data=2,model=2 with the sequence sharded (ZeRO-3's gathers over
    data, the layout's all-gathers and reduce-scatters of S over model),
    and at model=2 unsharded, wk, wv and the FFN whole (all-reduces over
    model); and the bytes by axis are those of the axes the step cuts."""
    arch, seq, kw = CASES[case]
    _, cfg = _cfgs(arch, **dict(kw))
    (data, tp), _ = MESHES[len(gloo["ranks"])]
    for r in gloo["ranks"]:
        summary = r["count"]["summary"]
        want = sharded_step_wire(cfg, {"data": data, "model": tp}, B,
                                 SEQ[seq])
        assert summary["collective_wire_bytes"] == pytest.approx(
            want, rel=1e-12)
        by_axis = summary["collective_wire_bytes_by_axis"]
        assert set(by_axis) == ({"data", "model"} if data > 1
                                else {"model"})
        assert sum(by_axis.values()) == pytest.approx(
            summary["total_wire_bytes"], rel=1e-12)


def test_checkpoint_restored_at_one_and_two_ranks_continues(gloo4, gloo2,
                                                            gloo1):
    """Saved (sharded over data=2, model=2) after two steps, restored by
    ``remesh_state`` whole onto one rank and onto data=2: the third
    step's metrics are the uninterrupted 4-rank run's on every rank."""
    full = gloo4["ranks"][0]["save"]["metrics"]
    for run, mesh in ((gloo1, (1, 1)), (gloo2, (2, 1))):
        for r in run["ranks"]:
            res = r["restore"]
            assert res["step0"] == 2 and res["step"] == STEPS
            assert res["mesh"] == (("data", "model"), mesh)
            for k in ("loss", "grad_norm", "lr", "nll"):
                _close_rel(res["metrics"][0][k], full[2][k], METRIC_RTOL,
                           (mesh, k))


def test_launcher_at_data2_model2_trains_as_on_one(gloo4, tmp_path, capsys):
    """``launch.train --mesh data=2,model=2`` on 4 gloo ranks (reduced
    Yi-9B, bf16 compute, S = 256: the sequence sharded) and the
    one-process launcher on the same arguments: the checkpoint each
    writes after three steps holds params within 5% of the one-process
    run's update, ||p_4 - p_1|| / ||p_1 - p_0||, as the data=2
    launcher's test holds them."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    train.main(LAUNCH + ["--ckpt-dir", str(tmp_path)])
    step, tree = CheckpointManager(str(tmp_path)).restore()
    assert "done; checkpoints: [3]" in capsys.readouterr().out
    p0 = {k: p.detach().numpy() for k, p in build_model(
        configs.reduced(configs.get_config("yi-9b"))).init(
            seed=0, device="cpu", trainable=True).named_parameters()}
    one = tree["params"]
    moved = sum(float(np.square(one[k] - p0[k]).sum()) for k in p0)
    for r in gloo4["ranks"]:
        got = r["launcher"]
        assert got["step"] == step == 3
        gap = sum(float(np.square(got["params"][k] - one[k]).sum())
                  for k in one)
        assert (gap / moved) ** 0.5 <= 0.05, (gap / moved) ** 0.5


# ------------------------------------------------- MoE under a mesh

def _moe_layer(tree):
    return tmoe.MoE(*(torch.from_numpy(tree[k])
                      for k in ("router", "w_in", "w_gate", "w_out")))


def test_moe_capacity_under_a_mesh_matches_jax(jax_tp, gloo1, gloo2):
    """With a skewed router, the JAX ``moe_forward`` under a mesh context
    runs ``moe_ep`` and drops each expert's overflow (it differs from
    ``moe_dense``), at model = 1 and 2.  The port's ``moe_forward(ctx)``
    under ``serving_ctx`` of 1 and 2 ranks matches it within 1e-5, output
    and router loss, on every rank; without a ctx it is ``moe_dense``'s
    function, as before."""
    dense_y, dense_aux = jax_tp["moe"]["dense"]
    for tp, run in ((1, gloo1), (2, gloo2)):
        want_y, want_aux = jax_tp["moe"][tp]
        rows = (np.abs(want_y - dense_y).max(-1) > 1e-3).sum()
        assert rows > 0, tp                  # JAX dropped some picks
        for r in run["ranks"]:
            got = r["moe"]
            assert got["tp"] == tp
            np.testing.assert_allclose(got["y"], want_y, rtol=MOE_TOL,
                                       atol=MOE_TOL)
            assert abs(got["aux"] - want_aux) <= MOE_TOL * abs(want_aux)
    tree, x = _moe_inputs()
    _, cfg = _cfgs(MOE)
    y, aux = tmoe.moe_forward(_moe_layer(tree), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), dense_y, rtol=MOE_TOL,
                               atol=MOE_TOL)
    assert abs(float(aux) - dense_aux) <= MOE_TOL * abs(dense_aux)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_moe_forward_is_the_literal_ep_body(tp):
    """``moe_forward`` under a ctx of ``tp`` ranks against
    ``moe_ep_plain``, the JAX ``_ep_body`` literally (capacity buffers,
    scatter-add, gather back), on the skewed input's first 3 x 13
    tokens: slices of 39, 20 and 10 (the last padded), output and router
    loss within 1e-5."""
    tree, x = _moe_inputs()
    x = np.ascontiguousarray(x[:3, :13])
    _, cfg = _cfgs(MOE)
    layer = _moe_layer(tree)
    ctx = types.SimpleNamespace(tp=tp, tensor_parallel=False)
    y, aux = tmoe.moe_forward(layer, torch.from_numpy(x), cfg, ctx)
    py, paux = tmoe.moe_ep_plain(layer, torch.from_numpy(x), cfg, tp)
    torch.testing.assert_close(y, py, rtol=MOE_TOL, atol=MOE_TOL)
    torch.testing.assert_close(aux, paux, rtol=MOE_TOL, atol=0)
