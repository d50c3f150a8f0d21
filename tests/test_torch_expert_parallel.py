"""Expert parallelism in the port's training — a MoE's experts cut over
``model`` (``models.moe.moe_ep``: capacity buffers exchanged by
``all_to_all`` over the model group, the slices' outputs all-gathered)
— against the JAX package's ``moe_ep`` under its mesh.

The port's steps run on 2 ranks (model=2) and 4 ranks (data=2,model=2)
of a gloo process group on the CPU (``tests/torch_train_workers.py``),
on weights carried from the JAX init and shared numpy batches; each rank
holds only its ``E / tp`` experts.  The JAX package's
``make_train_step(ctx=MeshCtx(...))`` runs on the same meshes of host
devices in one subprocess, started when the module starts
(:data:`JAX_SCRIPT`, which ``tests/test_torch_seqshard_attention.py``
runs too).

The reduced Qwen3-MoE (4 experts, top-2) is skewed so that picks drop:
0.1 is added to every embedding entry, which gives the normed hidden
states a common direction, and 0.3 along it to router column 0, so that
expert 0 is among most tokens' two and overflows its capacity in every
slice.  Each case runs three steps in f32 at S = 256 (the layer
boundaries sequence-sharded: the MoE enters from the whole sequence and
leaves to the boundary's rows) and at S = 17.  Limits are
``tests/test_torch_tensor_parallel.py``'s: loss, grad norm
and lr within ``METRIC_RTOL`` of the JAX step's; after three steps m
and v within ``MOMENT_TOL`` of each tensor's largest entry, and the
params within ``PARAM_LR`` lr of the port's one-card step under the
same capacity rule (all but 0.1% within 1e-3 lr), and within 2 lr of
the JAX step's (all but 0.1% within ``PARAM_LR`` lr, at most ``FLIPS``
entries beyond).  The one-card reference runs the MoE by the rule of
``data · model`` slices (each model rank's slice of each data rank's
rows is one of the whole batch's ``data · model`` equal slices).
"""
import copy
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_gloo_workers as workers
from repro_torch import configs
from repro_torch.models import blocks
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import build_model, params_from_numpy
from repro_torch.roofline.analysis import sharded_step_wire
from test_torch_sharded_train import (FLIPS, METRIC_RTOL, MOMENT_TOL,
                                      OCFG, PARAM_LR, SUITE, _by_port_name,
                                      _close_rel, _moments_close)
from test_torch_tensor_parallel import MOE, MOE_TOL, _cfgs, _moe_inputs, \
    _tree

ROOT = Path(__file__).resolve().parents[1]
B, STEPS = 4, 3
SEQ = {"sp": 256, "full": 17}
MESHES = {2: ((1, 2), ("data", "model")), 4: ((2, 2), ("data", "model"))}
CASES = {f"moe/{s}": s for s in SEQ}
LAUNCH = ["--device", "cpu", "--arch", MOE, "--steps", "3", "--batch", "4",
          "--seq", "256", "--log-every", "1"]
EMBED_SHIFT, ROUTER_SHIFT = 0.1, 0.3

JAX_SCRIPT = r"""
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

if "moe" in inp:
    cfg = dataclasses.replace(reduced(get_config(inp["moe"]["arch"])),
                              compute_dtype="float32")
    p = jax.tree.map(jnp.asarray, inp["moe"]["tree"])
    x = jnp.asarray(inp["moe"]["x"])
    for tp in inp["moe"]["tps"]:
        y, aux = moe.moe_forward(p, x, cfg, MeshCtx(mesh_of((1, tp))))
        out["moe"][tp] = (np.asarray(y), float(aux))
    y, aux = moe.moe_dense(p, x, cfg)
    out["moe"]["dense"] = (np.asarray(y), float(aux))
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX_OK")
"""


def start_jax(tmp, inp: dict) -> dict:
    """:data:`JAX_SCRIPT` on ``inp`` in a subprocess on 4 host devices:
    ``{"proc", "out"}`` for :func:`read_jax`."""
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    return {"proc": proc, "out": tmp / "out.pkl"}


def read_jax(job: dict) -> dict:
    stdout, stderr = job["proc"].communicate(timeout=900)
    assert "JAX_OK" in stdout, stdout[-2000:] + stderr[-4000:]
    with open(job["out"], "rb") as f:
        return pickle.load(f)


def stop_jax(job: dict) -> None:
    if job["proc"].poll() is None:
        job["proc"].kill()
        job["proc"].communicate()


@functools.lru_cache(maxsize=None)
def _skewed_tree():
    """The JAX init of the reduced Qwen3-MoE (``_tree``), every
    embedding entry shifted by ``EMBED_SHIFT`` and every layer's router
    column 0 by ``ROUTER_SHIFT`` along the all-ones direction."""
    tree = copy.deepcopy(_tree(MOE))
    tree["embed"] = tree["embed"] + np.float32(EMBED_SHIFT)
    router = tree["blocks"]["pos0"]["moe"]["router"]
    router[..., 0] += np.float32(ROUTER_SHIFT)
    return tree


@functools.lru_cache(maxsize=None)
def _batches(seq):
    _, cfg = _cfgs(MOE)
    return [{"tokens": np.random.default_rng(40 + t).integers(
        0, cfg.vocab_size, (B, SEQ[seq])).astype(np.int32)}
        for t in range(STEPS)]


def _case(name, world):
    return {"arch": MOE, "mesh": MESHES[world], "tree": _skewed_tree(),
            "batches": _batches(CASES[name]), "cfg_kw": {}}


def _ep_inputs():
    """``_moe_inputs``' skewed layer, x on its first 3 x 13 tokens (39:
    slices of 20 and 10, the last padded) and a seeded output gradient."""
    tree, x = _moe_inputs()
    x = np.ascontiguousarray(x[:3, :13])
    gy = np.random.default_rng(2).standard_normal(x.shape).astype(
        np.float32)
    return tree, x, gy


@pytest.fixture(scope="module", autouse=True)
def _jax_proc(tmp_path_factory):
    """The JAX subprocess, started as the module starts: its steps of
    every case on both meshes, and ``moe_forward`` under (1, 2) and
    (1, 4) meshes and ``moe_dense`` on the EP forward's input."""
    tree, x, _ = _ep_inputs()
    job = start_jax(tmp_path_factory.mktemp("jax_ep"), {
        "ocfg": OCFG,
        "steps": {f"{n}@{w}": {**_case(n, w), "mesh": MESHES[w][0]}
                  for n in CASES for w in MESHES},
        "moe": {"arch": MOE, "tree": tree, "x": x, "tps": [2, 4]}})
    yield job
    stop_jax(job)


@pytest.fixture(scope="module")
def jax_ep(_jax_proc):
    return read_jax(_jax_proc)


def _ep_payload(mesh):
    tree, x, gy = _ep_inputs()
    return {"tree": tree, "x": x, "gy": gy, "mesh": mesh}


@pytest.fixture(scope="module")
def gloo2(tmp_path_factory):
    """2 gloo ranks at model=2: every case's steps, one step's counted
    collectives at S = 256, the EP forward at tp = 2 and the launcher."""
    tmp = tmp_path_factory.mktemp("ep2")
    payload = {
        "steps": {n: _case(n, 2) for n in CASES},
        "count": {"arch": MOE, "mesh": MESHES[2], "tree": _skewed_tree(),
                  "batch": _batches("sp")[0]},
        "ep_forward": _ep_payload(MESHES[2]),
        "launcher": {"argv": LAUNCH + ["--mesh", "model=2", "--ckpt-dir",
                                       str(tmp / "launch")]},
    }
    return {"ranks": workers.run(2, tmp, payload, suite=SUITE)}


@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """4 gloo ranks at data=2,model=2: every case's steps and one step's
    counted collectives at S = 17; the EP forward at model=4."""
    tmp = tmp_path_factory.mktemp("ep4")
    payload = {
        "steps": {n: _case(n, 4) for n in CASES},
        "count": {"arch": MOE, "mesh": MESHES[4], "tree": _skewed_tree(),
                  "batch": _batches("full")[0]},
        "ep_forward": _ep_payload(((1, 4), ("data", "model"))),
    }
    return {"ranks": workers.run(4, tmp, payload, suite=SUITE)}


@functools.lru_cache(maxsize=None)
def _one_card(name, n_slices):
    """The port's one-card step on the same weights and batches, its MoE
    under the capacity rule of ``n_slices`` slices (``moe_forward`` with
    a ctx that is not tensor-parallel): params, m and v after the steps,
    and the picks the capacity dropped in each step."""
    from repro_torch.train import optimizer as topt
    _, cfg = _cfgs(MOE)
    model = build_model(cfg)
    params = params_from_numpy(cfg, _skewed_tree(), device="cpu",
                               trainable=True)
    named = dict(params.named_parameters())
    opt_state = topt.adamw_init(named)
    ctx = types.SimpleNamespace(tp=n_slices, tensor_parallel=False)

    def run(layer, x, cfg, rope, causal, mode, kv, _ctx):
        return blocks._layer_forward(layer, x, cfg, rope, causal, mode, kv,
                                     ctx)
    dropped = []
    picks = tmoe._slice_picks

    def counted(*args):
        keep, aux = picks(*args)
        dropped[-1] += int((~keep).sum())
        return keep, aux
    ocfg = topt.AdamWConfig(**OCFG)
    for b in _batches(CASES[name]):
        dropped.append(0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmoe, "_slice_picks", counted)
            loss, _ = model.loss(params, {"tokens": torch.from_numpy(
                b["tokens"])}, run=run)
            grads = torch.autograd.grad(loss, list(named.values()))
        topt.adamw_step(ocfg, named, dict(zip(named, grads)), opt_state)
    return {"params": {k: p.detach().numpy() for k, p in named.items()},
            "m": {k: t.numpy() for k, t in opt_state["m"].items()},
            "v": {k: t.numpy() for k, t in opt_state["v"].items()},
            "dropped": dropped}


CASE_ARGS = [(n, w) for w in MESHES for n in CASES]
CASE_IDS = [f"{n}-{w}ranks" for n, w in CASE_ARGS]


@pytest.mark.parametrize("name,world", CASE_ARGS, ids=CASE_IDS)
def test_ep_steps_match_jax_and_one_card(request, jax_ep, name, world):
    """Three expert-parallel steps (model=2, or data=2,model=2) against
    the JAX package's step on the same mesh: every step's loss, grad
    norm and lr, then the whole params, m and v; and against the port's
    one-card step under the same capacity rule, which drops picks in
    every step."""
    got = request.getfixturevalue(f"gloo{world}")["ranks"][0]["steps"][name]
    want = jax_ep["steps"][f"{name}@{world}"]
    _, cfg = _cfgs(MOE)
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in ("loss", "grad_norm", "lr", "aux"):
            _close_rel(g[k], w[k], METRIC_RTOL, (step, k))
    assert got["step"] == STEPS
    (data, tp), _ = MESHES[world]
    one = _one_card(name, data * tp)
    assert min(one["dropped"]) > 0, one["dropped"]
    st = want["state"]
    lr = OCFG["lr"]
    whole = got["whole"]
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
def test_each_rank_holds_its_experts(request, world):
    """Each rank holds E / tp experts, its data piece of each (w_in and
    w_gate by d_model rows, w_out by d_model columns); the router whole;
    attention's weights and the vocabulary by the Megatron rules."""
    ranks = request.getfixturevalue(f"gloo{world}")["ranks"]
    (data, tp), _ = MESHES[world]
    _, cfg = _cfgs(MOE)
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    dl = -(-d // data)
    for r in ranks:
        for name, res in r["steps"].items():
            local = res["local_shapes"]
            for i in range(cfg.n_layers):
                pre = f"blocks.{i}.moe."
                assert local[pre + "w_in"] == (e // tp, dl, f), name
                assert local[pre + "w_gate"] == (e // tp, dl, f), name
                assert local[pre + "w_out"] == (e // tp, f, dl), name
                assert local[pre + "router"] == (d, e), name
            assert local["embed"] == (cfg.padded_vocab // tp, d)


@pytest.mark.parametrize("world", [2, 4])
def test_counted_wire_bytes_equal_the_ring_model(request, world):
    """One step's recorded collectives, by kind, equal
    ``sharded_step_wire``'s ring model, all-to-all included; every
    all-to-all is over ``model`` and moves one capacity buffer [E, cap,
    D] (f32 here); every all-gather over ``model`` moves activations
    (the boundary's rows or a token slice), never an expert's weights."""
    ranks = request.getfixturevalue(f"gloo{world}")["ranks"]
    (data, tp), _ = MESHES[world]
    seq = "sp" if world == 2 else "full"
    _, cfg = _cfgs(MOE)
    e, d = cfg.moe, cfg.d_model
    rows = B // data
    s = SEQ[seq]
    ts, cap = tmoe.capacity(rows * s, tp, e)
    want = sharded_step_wire(cfg, {"data": data, "model": tp}, B, s)
    assert want["all-to-all"] > 0
    for r in ranks:
        summary = r["count"]["summary"]
        assert summary["collective_wire_bytes"] == pytest.approx(
            want, rel=1e-12)
        for kind, nbytes, g, _, _, axis in r["count"]["log"]:
            if kind == "all-to-all":
                assert (axis, g, nbytes) == ("model", tp,
                                             e.n_experts * cap * d * 4)
            if kind == "all-gather" and axis == "model":
                assert nbytes in (rows * s // tp * d * 4, ts * d * 4), \
                    nbytes


@pytest.mark.parametrize("world", [2, 4])
def test_ep_forward_equals_the_literal_ep_body(request, jax_ep, world):
    """``moe_forward`` in a tensor-parallel forward at tp = 2 and 4, each
    rank holding E / tp experts, against ``moe_ep_plain`` (the JAX
    ``_ep_body`` literally, experts whole) and the JAX ``moe_forward``
    under a (1, tp) mesh, output and router loss within 1e-5, on every
    rank; the picks dropped (the JAX result differs from
    ``moe_dense``'s).  The gradients of (y · gy).sum() + aux: x's and the
    router's (its ranks' parts summed in the backward) equal the whole's
    on every rank, each rank's experts' their block of the whole's.  Its
    collectives: 4 all-to-alls of the buffer, 2 all-gathers of the token
    slices, 1 all-reduce of the router loss and 1 of the router's
    gradient."""
    ranks = request.getfixturevalue(f"gloo{world}")["ranks"]
    tree, x, gy = _ep_inputs()
    _, cfg = _cfgs(MOE)
    e = cfg.moe
    tp = ranks[0]["ep_forward"]["tp"]
    assert tp == (2 if world == 2 else 4)
    layer = tmoe.MoE(*(torch.from_numpy(tree[k]).clone() for k in (
        "router", "w_in", "w_gate", "w_out"))).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    py, paux = tmoe.moe_ep_plain(layer, xt, cfg, tp)
    pg = torch.autograd.grad((py * torch.from_numpy(gy)).sum() + paux,
                             [xt] + list(layer.parameters()))
    pg = dict(zip(["x"] + [n for n, _ in layer.named_parameters()], pg))
    jy, jaux = jax_ep["moe"][tp]
    dense_y, _ = jax_ep["moe"]["dense"]
    assert (np.abs(jy - dense_y).max(-1) > 1e-3).sum() > 0
    t = x.shape[0] * x.shape[1]
    ts, cap = tmoe.capacity(t, tp, e)
    e_loc = e.n_experts // tp
    for r in ranks:
        got = r["ep_forward"]
        assert got["local"] == (e_loc, cfg.d_model, e.d_ff_expert)
        for want_y, want_aux in ((py.detach().numpy(), float(paux)),
                                 (jy, jaux)):
            np.testing.assert_allclose(got["y"], want_y, rtol=MOE_TOL,
                                       atol=MOE_TOL)
            assert abs(got["aux"] - want_aux) <= MOE_TOL * abs(want_aux)
        g = got["grads"]
        np.testing.assert_allclose(g["x"], pg["x"].numpy(), rtol=MOE_TOL,
                                   atol=MOE_TOL)
        mine = slice(got["rank"] * e_loc, (got["rank"] + 1) * e_loc)
        for k in ("w_in", "w_gate", "w_out"):
            np.testing.assert_allclose(g[k], pg[k][mine].numpy(),
                                       rtol=MOE_TOL, atol=MOE_TOL)
        np.testing.assert_allclose(g["router"], pg["router"].numpy(),
                                   rtol=MOE_TOL, atol=MOE_TOL)
        assert sorted((k, n) for k, n, *_ in got["log"]) == sorted(
            [("all-to-all", e.n_experts * cap * cfg.d_model * 4)] * 4
            + [("all-gather", ts * cfg.d_model * 4)] * 2
            + [("all-reduce", 4), ("all-reduce",
                                   cfg.d_model * e.n_experts * 4)])


def _ulp_moved_norm(plain):
    """rmsnorm with every nonzero output moved one ulp, up or down by the
    low bit of its pattern (the same move when activation checkpointing
    recomputes it): chip_smoke.py's one-ulp control of the MoE steps."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke._moved_norm(plain, smoke._ulp_moved_by_low_bit)


def _launch_one(tmp, control: bool):
    """The one-process launcher on ``LAUNCH``, its MoE under the capacity
    rule of 2 slices (``blocks._layer_forward`` given a ctx of tp = 2
    that is not tensor-parallel), with every rmsnorm output moved one ulp
    where ``control``: (its params after the steps, the picks dropped)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.launch import train
    ctx = types.SimpleNamespace(tp=2, tensor_parallel=False)
    layer_forward, picks = blocks._layer_forward, tmoe._slice_picks
    dropped = []

    def capped(layer, x, cfg, rope, causal=True, mode=None, kv=None,
               _ctx=None):
        return layer_forward(layer, x, cfg, rope, causal, mode, kv, ctx)

    def counted(*args):
        keep, aux = picks(*args)
        dropped.append(int((~keep).sum()))
        return keep, aux
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(blocks, "_layer_forward", capped)
        mp.setattr(tmoe, "_slice_picks", counted)
        if control:
            mp.setattr(rops, "rmsnorm", _ulp_moved_norm(rops.rmsnorm))
        train.main(LAUNCH + ["--ckpt-dir", str(tmp)])
    step, tree = CheckpointManager(str(tmp)).restore()
    assert step == 3
    return tree["params"], sum(dropped)


def test_launcher_at_model2_trains_the_moe(gloo2, tmp_path, capsys):
    """``launch.train --arch qwen3-moe-30b-a3b --mesh model=2`` on 2 gloo
    ranks (reduced, bf16 compute, S = 256) against the one-process
    launcher on the same arguments with its MoE under the same capacity
    rule (2 slices; the random router drops picks in every step): the
    checkpoint each writes after three steps holds params within twice
    the one-ulp control's distance of the one-process run's,
    ||p_2 - p_1|| / ||p_1 - p_0||.  In bf16 a pick near its expert's
    capacity or a router near-tie moves with any rounding, so the
    control (the one-process run with every rmsnorm output moved one
    ulp) sets the limit, as chip_smoke's checks do (22.6% measured, the
    TP run 13.4%)."""
    one, dropped = _launch_one(tmp_path / "one", False)
    assert dropped > 0
    assert "done; checkpoints: [3]" in capsys.readouterr().out
    ctl, _ = _launch_one(tmp_path / "ctl", True)
    p0 = {k: p.detach().numpy() for k, p in build_model(
        configs.reduced(configs.get_config(MOE))).init(
            seed=0, device="cpu", trainable=True).named_parameters()}

    def gap(p):
        return (sum(float(np.square(p[k] - one[k]).sum()) for k in one)
                / sum(float(np.square(one[k] - p0[k]).sum())
                      for k in p0)) ** 0.5
    limit = 2 * gap(ctl)
    for r in gloo2["ranks"]:
        got = r["launcher"]
        assert got["step"] == 3
        assert gap(got["params"]) <= limit, (gap(got["params"]), limit)
