"""Training across ranks in the port — the ZeRO-3 step over ``data``
(``train.zero``, ``train.trainstep.make_train_step(..., ctx=)``), the
int8 error-feedback pod sync (``train.compression``,
``make_compressed_train_step``), the sharded checkpoint and elastic
restore (``checkpoint.manager``, ``runtime.elastic``) and the counted
collectives (``sharding.collectives``) — against the JAX package.

The port's steps run on 2 and 4 ranks of a gloo process group on the
CPU (``tests/torch_train_workers.py``, spawned once per world size), on
weights carried from the JAX init and shared numpy batches; each rank
holds only its shards.  The JAX package's plain step runs here on one
device on the whole global batch; its compressed step, and
``compressed_pmean`` / ``ef_compressed_pmean`` under ``shard_map``, run
in a subprocess on 4 host devices (``--xla_force_host_platform_device_
count``) on a (pod=2, data=2, model=1) mesh.

A MoE under a mesh runs the JAX ``moe_ep`` at model = 1: each rank's
tokens are one slice, each expert keeps its first ``cap`` picks of it
and drops the rest, and the router loss is the mean over the batch's
ranks of each rank's own (``jax.lax.pmean(aux, all_axes)``).  Its
reference is the JAX ``make_train_step(ctx=)`` on the same (pod, data,
model=1) mesh of host devices, in the subprocess; the port's one-card
step, which drops nothing, is not one.

Limits: loss, grad_norm and lr of every step within 1e-5 relative of
the JAX step's.  After three steps the whole params, m and v are held
two ways.  Against the port's own one-card step on the same batches
(the same arithmetic but for the order of the sums): params by
``tests/test_torch_train.py``'s ``_params_close``, m and v within 1e-4
of each tensor's largest entry (the limit of one gradient in
``test_loss_and_grads_match_jax``).  Against the JAX step: params within
0.25 lr and m, v within 5e-4 of each tensor's largest entry, about
twice the one-card port's own distance from the JAX step after the
same three steps (0.144 lr on internvl2-2b's ffn.w_out, 2.4e-4 of the
largest m on its head; measured on these inputs).  A compressed mean
must equal the JAX one, or be one quantization step (``scale2``) off,
with the count of elements that differ stated.
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_gloo_workers as workers
from repro import configs as jconfigs
from repro.models.lm import build_model as jbuild_model
from repro.train import compression as jcompression
from repro.train import optimizer as jopt
from repro.train import trainstep as jtrainstep
from repro_torch import configs
from repro_torch.models.lm import build_model, param_paths
from repro_torch.sharding.layout import shard_of
from repro_torch.train import compression

ROOT = Path(__file__).resolve().parents[1]
SUITE = "torch_train_workers"
OCFG = dict(lr=3e-3, warmup_steps=1, total_steps=4, weight_decay=0.0)
B, S, STEPS = 4, 17, 3
ARCHS = ["yi-9b", "internvl2-2b", "qwen3-moe-30b-a3b"]
POD2 = ((2, 2, 1), ("pod", "data", "model"))
DATA2 = ((2, 1), ("data", "model"))
DATA4 = ((4, 1), ("data", "model"))
# yi-9b at d_model 66: every matrix cut over data=4 into pieces of 17
# rows or columns, the last padded with 2
UNEVEN = {"d_model": 66}
COMPRESSED = ["yi-9b", "internvl2-2b"]
# the archs whose reference is the JAX step under the mesh (its moe_ep)
MESH_REF = ["qwen3-moe-30b-a3b"]
MESHES = {"data2": DATA2, "pod2": POD2}
LAUNCH = ["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "17",
          "--log-every", "1"]
METRIC_RTOL = 1e-5
GRAD_TOL = 1e-4          # against the one-card port
MOMENT_TOL = 5e-4        # against the JAX step
PARAM_LR = 0.25          # against the JAX step, in units of lr
FLIPS = 12               # compressed step: params over PARAM_LR · lr apart


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_config(arch)),
                               compute_dtype="float32", **kw)
    tcfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                               compute_dtype="float32", **kw)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _tree(arch, kw=()):
    jcfg, _ = _cfgs(arch, **dict(kw))
    return jax.tree.map(np.asarray,
                        jbuild_model(jcfg).init(jax.random.PRNGKey(3)))


def _batches(arch):
    _, cfg = _cfgs(arch)
    out = []
    for t in range(STEPS):
        rng = np.random.default_rng(40 + t)
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
             .astype(np.int32)}
        if cfg.n_prefix_embeds:
            b["prefix_embeds"] = rng.standard_normal(
                (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _by_port_name(tree, cfg) -> dict:
    out = {}
    for name, (path, i) in param_paths(cfg).items():
        leaf = tree
        for k in path:
            leaf = leaf[k]
        out[name] = np.asarray(leaf if i is None else leaf[i])
    return out


@functools.lru_cache(maxsize=None)
def _jax_steps(arch, accum=1, kw=()):
    """The JAX package's one-device step on the whole batch: each step's
    metrics, then params, m and v under the port's names."""
    jcfg, tcfg = _cfgs(arch, **dict(kw))
    model = jbuild_model(jcfg)
    params = jax.tree.map(jnp.asarray, _tree(arch, kw))
    state = {"params": params, "opt_state": jopt.adamw_init(params)}
    step = jax.jit(jtrainstep.make_train_step(
        model, jopt.AdamWConfig(**OCFG), grad_accum=accum))
    metrics = []
    for b in _batches(arch):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {
        "params": _by_port_name(state["params"], tcfg),
        "m": _by_port_name(state["opt_state"]["m"], tcfg),
        "v": _by_port_name(state["opt_state"]["v"], tcfg)}


def _case(arch, mesh, compressed=False, kw=()):
    return {"arch": arch, "mesh": mesh, "tree": _tree(arch, kw),
            "batches": _batches(arch), "compressed": compressed,
            "cfg_kw": dict(kw)}


# ------------------------------------------------- the JAX multi-device

_JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro import compat
from repro.configs import get_config, reduced
from repro.models.lm import build_model
from repro.train import optimizer as opt
from repro.train.compression import compressed_pmean, ef_compressed_pmean
from repro.train.trainstep import make_compressed_train_step

inp = pickle.load(open(sys.argv[1], "rb"))
auto = (AxisType.Auto,) * 3
mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"), axis_types=auto)
out = {"steps": {}, "mesh_steps": {}}
from repro.models.common import MeshCtx
from repro.train.trainstep import make_train_step
for key, case in inp["mesh_steps"].items():
    cfg = dataclasses.replace(reduced(get_config(case["arch"])),
                              compute_dtype="float32")
    model = build_model(cfg)
    shape, axes = case["mesh"]
    m = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                      devices=jax.devices()[:int(np.prod(shape))])
    params = jax.tree.map(jnp.asarray, case["tree"])
    state = {"params": params, "opt_state": opt.adamw_init(params)}
    step = jax.jit(make_train_step(
        model, opt.AdamWConfig(**inp["ocfg"]),
        ctx=MeshCtx(m, dp_axes=tuple(a for a in axes if a != "model"))))
    metrics = []
    for b in case["batches"]:
        state, met = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in met.items()})
    out["mesh_steps"][key] = {"metrics": metrics,
                              "state": jax.tree.map(np.asarray, state)}
for arch, case in inp["steps"].items():
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = jax.tree.map(jnp.asarray, case["tree"])
    state = {"params": params, "opt_state": opt.adamw_init(params),
             "ef": jax.tree.map(lambda p: jnp.zeros((2,) + p.shape,
                                                    jnp.float32), params)}
    step = jax.jit(make_compressed_train_step(
        model, opt.AdamWConfig(**inp["ocfg"]), mesh))
    metrics = []
    for b in case["batches"]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    out["steps"][arch] = {"metrics": metrics,
                          "state": jax.tree.map(np.asarray, state)}

mesh2 = jax.make_mesh((2, 2), ("pod", "data"),
                      axis_types=(AxisType.Auto,) * 2)
c = inp["compression"]
sync = jax.jit(compat.shard_map(lambda v: compressed_pmean(v, "pod"),
                                mesh=mesh2, in_specs=P("pod"),
                                out_specs=P("pod"), check_vma=False))
out["mean"] = np.asarray(sync(jnp.asarray(c["x"])))

def body(tree, ef):
    return ef_compressed_pmean(tree, ef, "pod")

ef_step = jax.jit(compat.shard_map(body, mesh=mesh2,
                                   in_specs=(P("pod"), P("pod")),
                                   out_specs=(P("pod"), P("pod")),
                                   check_vma=False))
ef = {k: jnp.zeros(v.shape[1:], jnp.float32) for k, v in c["tree"].items()}
synced = []
for t in range(c["steps"]):
    s, ef = ef_step({k: jnp.asarray(v[t]) for k, v in c["tree"].items()}, ef)
    synced.append(jax.tree.map(np.asarray, s))
out["synced"] = synced
out["ef"] = jax.tree.map(np.asarray, ef)
pickle.dump(out, open(sys.argv[2], "wb"))
print("JAX_OK")
"""


def _compression_inputs():
    rng = np.random.default_rng(7)
    return {"x": rng.standard_normal((2, 37, 5)).astype(np.float32),
            "tree": {"cut": rng.standard_normal((3, 2, 10, 6))
                     .astype(np.float32),
                     "whole": (rng.standard_normal((3, 2, 7)) * 1e-3)
                     .astype(np.float32)},
            "steps": 3}


@pytest.fixture(scope="module")
def jax4(tmp_path_factory):
    """The JAX package on 4 host devices, in a subprocess: its compressed
    step for each of ``COMPRESSED``, the compressed means, and the plain
    step under each mesh of :data:`MESH_REF` (a MoE's)."""
    tmp = tmp_path_factory.mktemp("jax4")
    inp = {"ocfg": OCFG, "compression": _compression_inputs(),
           "steps": {a: {"tree": _tree(a), "batches": _batches(a)}
                     for a in COMPRESSED},
           "mesh_steps": {f"{a}/{m}": {"arch": a, "mesh": MESHES[m],
                                       "tree": _tree(a),
                                       "batches": _batches(a)}
                          for a in MESH_REF for m in MESHES}}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(tmp / "in.pkl"),
         str(tmp / "out.pkl")], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    assert "JAX_OK" in res.stdout, res.stdout[-2000:] + res.stderr[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


# ------------------------------------------------------ the gloo ranks

@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """One run of 4 gloo ranks: the plain step at pod=2,data=2 for each
    arch, the compressed step, the uneven shards at data=4, the
    compressed means, the uninterrupted run that saves a checkpoint, the
    counted collectives and the refusals."""
    tmp = tmp_path_factory.mktemp("gloo4")
    steps = {f"{a}/pod2": _case(a, POD2) for a in ARCHS}
    steps.update({f"{a}/compressed": _case(a, POD2, compressed=True)
                  for a in COMPRESSED})
    steps["yi-9b/uneven"] = _case("yi-9b", DATA4,
                                  kw=tuple(UNEVEN.items()))
    c = _compression_inputs()
    payload = {
        "steps": steps,
        "compression": {"shape": (2, 2), "axes": ("pod", "data"),
                        "x": c["x"], "tree": c["tree"], "steps": c["steps"]},
        "save": {"arch": "yi-9b", "mesh": DATA4, "tree": _tree("yi-9b"),
                 "batches": _batches("yi-9b"),
                 "directory": str(tmp / "ckpt"), "save_after": 2},
        "count": {"arch": "yi-9b", "mesh": POD2, "tree": _tree("yi-9b"),
                  "batch": _batches("yi-9b")[0]},
    }
    out = workers.run(4, tmp, payload, suite=SUITE)
    return {"ranks": out, "ckpt": str(tmp / "ckpt")}


@pytest.fixture(scope="module")
def gloo2(tmp_path_factory, gloo4):
    """One run of 2 gloo ranks: the plain step at data=2 for each arch,
    the checkpoint of the 4-rank run restored onto 2 ranks and run on,
    and the refusals."""
    tmp = tmp_path_factory.mktemp("gloo2")
    payload = {
        "steps": {f"{a}/data2": _case(a, DATA2) for a in ARCHS},
        "restore": {"arch": "yi-9b", "directory": gloo4["ckpt"],
                    "batches": _batches("yi-9b")[2:], "world": 2},
        "launcher": {"argv": LAUNCH + ["--mesh", "data=2", "--ckpt-dir",
                                       str(tmp / "launch")]},
    }
    return {"ranks": workers.run(2, tmp, payload, suite=SUITE)}


@pytest.fixture
def gloo(request):
    return request.getfixturevalue(f"gloo{request.param}")


def _close_rel(got, want, rtol, what):
    assert abs(got - want) <= rtol * max(abs(want), 1e-12), (what, got, want)


def _params_close(got: dict, want: dict, lr: float):
    """``tests/test_torch_train.py``'s limit for params after AdamW: an
    entry whose gradient is near zero takes an update anywhere in about
    [-1, 1] lr when sums run in another order, so 5e-2 lr for every
    entry and 1e-3 lr for all but 0.1% of each tensor's."""
    for name, p in got.items():
        d = np.abs(p - want[name])
        assert d.max() <= 5e-2 * lr, (name, d.max() / lr)
        assert (d > 1e-3 * lr).mean() <= 1e-3, name


def _moments_close(got: dict, want: dict, key: str, tol: float):
    """m or v within ``tol`` of each tensor's largest entry."""
    for name, a in got.items():
        w = want[name]
        scale = float(np.abs(w).max()) or 1.0
        err = float(np.abs(a - w).max())
        assert err <= tol * scale, (key, name, err, scale)


def _near_jax(got: dict, want: dict):
    for name, p in got["params"].items():
        d = float(np.abs(p - want["params"][name]).max())
        assert d <= PARAM_LR * OCFG["lr"], (name, d / OCFG["lr"])
    for key in ("m", "v"):
        _moments_close(got[key], want[key], key, MOMENT_TOL)


@functools.lru_cache(maxsize=None)
def _one_card(arch, accum=1, kw=()):
    """The port's one-card step on the same carried weights and batches:
    params, m and v after the steps."""
    import torch
    from repro_torch.models.lm import params_from_numpy
    from repro_torch.train import optimizer as topt
    from repro_torch.train import trainstep as ttrainstep
    _, cfg = _cfgs(arch, **dict(kw))
    params = params_from_numpy(cfg, _tree(arch, kw), device="cpu",
                               trainable=True)
    state = {"params": params, "opt_state": topt.adamw_init(
        dict(params.named_parameters()))}
    step = ttrainstep.make_train_step(build_model(cfg),
                                      topt.AdamWConfig(**OCFG),
                                      grad_accum=accum)
    for b in _batches(arch):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
    return {"params": {k: p.detach().numpy()
                       for k, p in state["params"].named_parameters()},
            "m": {k: t.numpy() for k, t in state["opt_state"]["m"].items()},
            "v": {k: t.numpy() for k, t in state["opt_state"]["v"].items()}}


def _held(got, arch, accum=1, kw=(), jax_mesh=None):
    """A sharded run's metrics and whole state against the JAX step and
    the one-card port's; ``jax_mesh``: the JAX step under the mesh
    instead (``jax4``'s), and no one-card step."""
    if jax_mesh is not None:
        _, cfg = _cfgs(arch, **dict(kw))
        st = jax_mesh["state"]
        want_m, want = jax_mesh["metrics"], {
            "params": _by_port_name(st["params"], cfg),
            "m": _by_port_name(st["opt_state"]["m"], cfg),
            "v": _by_port_name(st["opt_state"]["v"], cfg)}
    else:
        want_m, want = _jax_steps(arch, accum, kw)
    for step, (g, w) in enumerate(zip(got["metrics"], want_m)):
        for k in ("loss", "grad_norm", "lr"):
            _close_rel(g[k], w[k], METRIC_RTOL, (step, k))
    assert got["step"] == STEPS
    whole = got["whole"]
    if jax_mesh is None:
        one = _one_card(arch, accum, kw)
        _params_close(whole["params"], one["params"], OCFG["lr"])
        for key in ("m", "v"):
            _moments_close(whole[key], one[key], key, GRAD_TOL)
    _near_jax(whole, want)


PLAIN = [(a, 2) for a in ARCHS] + [(a, 4) for a in ARCHS]


@pytest.mark.parametrize("arch,world", PLAIN,
                         ids=[f"{a}-{w}ranks" for a, w in PLAIN])
def test_sharded_steps_match_jax(request, arch, world):
    """Three ZeRO-3 steps (data=2, or pod=2,data=2) against the JAX
    package's step on the whole batch (a MoE's: under the same mesh,
    ``jax4``): every step's loss, grad norm and lr, then the whole
    params, m and v."""
    run = request.getfixturevalue(f"gloo{world}")["ranks"]
    mesh = "data2" if world == 2 else "pod2"
    key = f"{arch}/{mesh}"
    jax_mesh = (request.getfixturevalue("jax4")["mesh_steps"][key]
                if arch in MESH_REF else None)
    _held(run[0]["steps"][key], arch, jax_mesh=jax_mesh)


@pytest.mark.parametrize("gloo", [2, 4], indirect=True)
def test_every_rank_reports_the_same_metrics(gloo):
    """Loss and grad norm are means over the global batch on every rank;
    only rank 0 brings back whole tensors."""
    ranks = gloo["ranks"]
    for key in ranks[0]["steps"]:
        first = ranks[0]["steps"][key]["metrics"]
        for r in ranks[1:]:
            assert r["steps"][key]["metrics"] == first, key
            assert r["steps"][key]["whole"] is None


@pytest.mark.parametrize("gloo", [2, 4], indirect=True)
def test_local_shapes_are_the_rules_pieces(gloo):
    """Each rank holds ceil(D / data) of every dim the rules cut over
    data: wq, wk, wv, w_in, w_gate by rows, wo and w_out by columns;
    embed, head and the norms whole."""
    ranks = gloo["ranks"]
    world = len(ranks)
    for key, res in ranks[0]["steps"].items():
        arch = key.split("/")[0]
        kw = UNEVEN if key.endswith("uneven") else {}
        _, cfg = _cfgs(arch, **kw)
        data = 2 if (world == 4 and not key.endswith("uneven")) else world
        meta = dict(build_model(cfg).init(device="meta",
                                          trainable=True).named_parameters())
        for name, shape in res["local_shapes"].items():
            want = list(meta[name].shape)
            if name.endswith(("attn.wq", "attn.wk", "attn.wv", "ffn.w_in",
                              "ffn.w_gate", "dense.w_in", "dense.w_gate")):
                want[0] = -(-want[0] // data)
            elif name.endswith(("attn.wo", "ffn.w_out", "dense.w_out")):
                want[1] = -(-want[1] // data)
            elif name.endswith(("moe.w_in", "moe.w_gate")):
                want[1] = -(-want[1] // data)
            elif name.endswith("moe.w_out"):
                want[2] = -(-want[2] // data)
            assert list(shape) == want, (key, name)


def test_uneven_shards_match_jax(gloo4):
    """d_model 66 at data=4: pieces of 17 with 2 zero rows or columns in
    the last; the pad is never updated and never counted in the norm."""
    got = gloo4["ranks"][0]["steps"]["yi-9b/uneven"]
    assert got["local_shapes"]["blocks.0.attn.wq"] == (17, 64)
    assert got["local_shapes"]["blocks.0.attn.wo"] == (64, 17)
    _held(got, "yi-9b", 1, tuple(UNEVEN.items()))


@pytest.mark.parametrize("arch", COMPRESSED)
def test_compressed_steps_match_jax(gloo4, jax4, arch):
    """Three compressed steps at pod=2,data=2 against the JAX
    ``make_compressed_train_step`` on the same mesh of host devices.

    The two packages' pod-local gradients differ in their last bits, and
    an element whose quotient by the scale lies that close to a rounding
    boundary goes over the wire one quantization step (1/127 of the
    JAX leaf's largest) apart; where that element is a leaf's largest,
    the second hop's scale moves with it for the whole leaf.  So the
    limits here are the flips' and are stated with what they allow:
    loss and lr within 1e-5, grad_norm within 1e-4 relative (3.2e-5
    seen); params all within 2 lr and all but 0.1% of each tensor's
    entries within 0.25 lr (1.07 lr and 0.024% seen: an element whose
    synced gradient is 0 in one package and one step in the other takes
    a whole Adam step, lr, on its own), and at most FLIPS such elements
    over all tensors (6 seen, all in InternVL2-2B: head 3,
    blocks.0.ffn.w_in 2, blocks.0.ffn.w_out 1; 0 in Yi-9B), so an error
    spread over a whole tensor fails; m, v and the residual within 5e-2
    of each tensor's largest entry (3.4e-2 seen on m and v: three steps
    of one quantization step each)."""
    got = gloo4["ranks"][0]["steps"][f"{arch}/compressed"]
    want = jax4["steps"][arch]
    _, cfg = _cfgs(arch)
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert set(g) == set(w) == {"loss", "lr", "grad_norm"}
        _close_rel(g["loss"], w["loss"], METRIC_RTOL, (step, "loss"))
        _close_rel(g["lr"], w["lr"], METRIC_RTOL, (step, "lr"))
        _close_rel(g["grad_norm"], w["grad_norm"], 10 * METRIC_RTOL,
                   (step, "grad_norm"))
    st = want["state"]
    whole = got["whole"]
    lr = OCFG["lr"]
    flips = {}
    for name, w in _by_port_name(st["params"], cfg).items():
        d = np.abs(whole["params"][name] - w)
        assert d.max() <= 2 * lr, (name, d.max() / lr)
        assert (d > PARAM_LR * lr).mean() <= 1e-3, name
        flips[name] = int((d > PARAM_LR * lr).sum())
    assert sum(flips.values()) <= FLIPS, {k: n for k, n in flips.items() if n}
    ef = {}
    for name, (path, i) in param_paths(cfg).items():
        leaf = st["ef"]
        for k in path:
            leaf = leaf[k]
        # the JAX residual is [pods, n_periods, ...] for a stacked leaf
        ef[name] = leaf if i is None else leaf[:, i]
    for key, want_t in (("m", _by_port_name(st["opt_state"]["m"], cfg)),
                        ("v", _by_port_name(st["opt_state"]["v"], cfg)),
                        ("ef", ef)):
        for name, w in want_t.items():
            g = whole[key][name]
            assert g.shape == w.shape, (key, name)
            scale = float(np.abs(w).max()) or 1.0
            assert float(np.abs(g - w).max()) <= 5e-2 * scale, (key, name)


def _quantum(x: np.ndarray) -> float:
    """``scale2`` of a compressed mean: the largest |mean| over 127."""
    return max(float(np.abs(x).max()) / 127.0, 1e-30)


def test_compressed_pmean_matches_jax_shard_map(gloo4, jax4):
    """``compressed_pmean`` of each pod's tensor, cut over data=2 along
    dim 0 (37 rows: pieces of 19 and 18 + 1 pad row), against the JAX
    function on each pod's whole tensor under ``shard_map``: equal value
    for value (both scales are maxima over the whole tensor; 0 elements
    differ)."""
    want = jax4["mean"]
    np.testing.assert_array_equal(want[0], want[1])
    for r in gloo4["ranks"][:1]:
        got = r["compression"]["mean"]
        pod = r["compression"]["pod"]
        differ = int((got != want[pod]).sum())
        assert differ == 0, (differ, float(np.abs(got - want[pod]).max()),
                             _quantum(want[pod]))


def test_ef_compressed_pmean_matches_jax_shard_map(gloo4, jax4):
    """Three rounds of ``ef_compressed_pmean`` with the residual carried,
    a leaf cut over data and a whole one (1e-3 of the other's scale).
    The cut leaf's means are equal in every round.  The whole leaf's
    differ in their last bits from the second round on (5 then 7 of its
    7 elements, by under 1e-5 of a quantization step): XLA contracts the
    JAX residual ``corrected - q2 * scale2`` into one fused multiply-add
    where the port rounds the product first, and the scale of the next
    round moves by that ulp.  Limits: every element within 1e-3 of a
    quantization step, and no element a whole step apart (0 flips)."""
    res = gloo4["ranks"][0]["compression"]
    pod = res["pod"]
    for t, (got, want) in enumerate(zip(res["synced"], jax4["synced"])):
        for k, g in got.items():
            w = want[k][pod]
            d = np.abs(g - w)
            assert d.max() <= 1e-3 * _quantum(w), (t, k, d.max())
            if k == "cut":
                assert int((d > 0).sum()) == 0, (t, k)
    for k, g in res["ef"].items():          # both pods' residuals
        w = jax4["ef"][k]
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-3 * _quantum(
            jax4["synced"][-1][k][pod]), k


def test_checkpoint_restored_at_two_ranks_continues_as_uninterrupted(
        gloo4, gloo2):
    """Saved (sharded) after two steps at data=4, restored by
    ``remesh_state`` onto a (data=2, model=1) mesh of 2 ranks: the third
    step's metrics are the uninterrupted 4-rank run's."""
    full = gloo4["ranks"][0]["save"]["metrics"]
    res = gloo2["ranks"][0]["restore"]
    assert res["step0"] == 2
    assert res["mesh"] == (("data", "model"), (2, 1))
    assert res["step"] == STEPS
    for k in ("loss", "grad_norm", "lr", "nll"):
        _close_rel(res["metrics"][0][k], full[2][k], METRIC_RTOL, k)
    # and the uninterrupted run is the JAX package's
    want, _ = _jax_steps("yi-9b")
    for step, (g, w) in enumerate(zip(full, want)):
        _close_rel(g["loss"], w["loss"], METRIC_RTOL, step)
    assert gloo2["ranks"][1]["restore"]["metrics"] == res["metrics"]


def test_launcher_across_two_ranks_trains_as_on_one(gloo2, tmp_path,
                                                   capsys):
    """``launch.train --mesh data=2`` on the gloo ranks and the one-process
    launcher on the same arguments (reduced Yi-9B, bf16 compute): the
    checkpoint each writes after three steps holds params whose distance
    is within 5% of the update the one-process run made,
    ||p_2 - p_1|| / ||p_1 - p_0|| (bf16 sums in another order; 2.2%
    measured on these arguments)."""
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
    for r in gloo2["ranks"]:
        got = r["launcher"]
        assert got["step"] == step == 3
        assert set(got["params"]) == set(one)
        gap = sum(float(np.square(got["params"][k] - one[k]).sum())
                  for k in one)
        assert (gap / moved) ** 0.5 <= 0.05, (gap / moved) ** 0.5


def _ring(kind, nbytes, g):
    f = (g - 1) / g
    return {"all-gather": nbytes * f, "reduce-scatter": nbytes * f,
            "all-reduce": 2 * nbytes * f, "all-to-all": nbytes * f}[kind]


def test_counted_wire_bytes_equal_the_ring_model_of_the_shards(gloo4):
    """One plain step at pod=2,data=2 (remat): per sharded weight two
    bf16... here f32 all-gathers (forward and recompute) of its pieces
    and one f32 reduce-scatter over data, an all-reduce over pod of its
    f32 shard gradient; per whole parameter an f32 all-reduce over data
    and over pod; the metrics' and the norm's all-reduces.  Counted from
    the shard sizes, by hand."""
    _, cfg = _cfgs("yi-9b")
    meta = dict(build_model(cfg).init(device="meta",
                                      trainable=True).named_parameters())
    from repro_torch.sharding import rules

    class M:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 2, "model": 1}
    specs = rules.param_specs(meta, cfg, M)
    want = {}

    def add(kind, nbytes, g):
        want[kind] = want.get(kind, 0.0) + _ring(kind, nbytes, g)
    for name, p in meta.items():
        sh = shard_of(tuple(p.shape), specs[name], M,
                      {"pod": 0, "data": 0, "model": 0})
        whole = p.numel() * 4
        if sh.sharded:
            local = int(np.prod(sh.local_shape)) * 4
            add("all-gather", 2 * 2 * local, 2)     # forward + recompute
            add("reduce-scatter", 2 * local, 2)
            add("all-reduce", local, 2)             # over pod
        else:
            add("all-reduce", whole, 2)             # over data
            add("all-reduce", whole, 2)             # over pod
    for _ in range(2):                              # metrics over data, pod
        add("all-reduce", 3 * 4, 2)
    add("all-reduce", 4, 2)                         # the norm over data
    got = gloo4["ranks"][0]["count"]["summary"]["collective_wire_bytes"]
    assert got == pytest.approx(want, rel=1e-12)
    log = gloo4["ranks"][0]["count"]["log"]
    assert {(k, g) for k, _, g, *_ in log} == {
        ("all-gather", 2), ("reduce-scatter", 2), ("all-reduce", 2)}


@pytest.mark.parametrize("n_params,n_pods", [(1, 1), (10 ** 6, 2),
                                              (2_206_000_000, 2),
                                              (8_830_000_000, 4)])
def test_wire_bytes_match_jax(n_params, n_pods):
    assert compression.wire_bytes(n_params, n_pods) == \
        jcompression.wire_bytes(n_params, n_pods)


@pytest.mark.parametrize("gloo", [2, 4], indirect=True)
def test_refusals(gloo):
    """A dense model, a MoE (expert parallelism) and a head count the axis
    does not divide (the sequence-sharded attention) on a model axis of 2
    or 4 ranks build and run a step (no refusal at the step or at the
    state); an encoder-decoder at data=K, a vocabulary an odd model axis
    does not divide and the compressed step on a model axis of more than
    one rank raise NotImplementedError naming their ROADMAP entry; the
    compressed step refuses a mesh without ``pod``."""
    ref = gloo["ranks"][0]["refusals"]
    assert ref["model_axis"] == ""
    assert ref["model_axis_state"] == ""
    assert ref["moe"] == "", ref["moe"]
    assert ref["heads"] == "", ref["heads"]
    for key, entry in (("whisper", "Whisper's sharded training"),
                       ("vocab", "the odd-model vocabulary cut"),
                       ("compressed_tp",
                        "the compressed pod sync at model > 1")):
        assert ref[key].startswith("NotImplementedError"), (key, ref[key])
        assert f"ROADMAP.md Queue 1 item 4, {entry}" in ref[key], ref[key]
    assert ref["no_pod"] == ("ValueError: compressed pod sync needs a "
                             "'pod' mesh axis")