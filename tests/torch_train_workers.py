"""The rank side of ``tests/test_torch_sharded_train.py``'s process groups.

``torch_gloo_workers.run(world, tmp, payload, suite=__name__)`` spawns
``world`` gloo ranks on the CPU, each running :func:`suite` on the
inputs the test made with numpy: the sharded train steps (plain and
compressed, over ``data`` and ``pod`` or tensor-parallel over
``model``), the compressed means alone, a checkpoint saved on one mesh
and restored on another, the counted collectives of a step and the
refusals.  ``tests/test_torch_tensor_parallel.py`` spawns it too.  A rank returns numpy results; whole tensors (gathered from
every rank's shards) come back from rank 0 only.  This module imports no
JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the step's AdamW: no weight decay, as tests/test_torch_train.py's
OCFG = dict(lr=3e-3, warmup_steps=1, total_steps=4, weight_decay=0.0)


def suite(rank: int, world: int, payload: dict) -> dict:
    out = {"steps": {name: _steps(**case)
                     for name, case in payload["steps"].items()}}
    if "compression" in payload:
        out["compression"] = _compression(**payload["compression"])
    if "save" in payload:
        out["save"] = _save(**payload["save"])
    if "restore" in payload:
        out["restore"] = _restore(**payload["restore"])
    if "count" in payload:
        out["count"] = _count(**payload["count"])
    if "launcher" in payload:
        out["launcher"] = _launcher(**payload["launcher"])
    if "moe" in payload:
        out["moe"] = _moe(**payload["moe"])
    if "tp_card" in payload:
        out["tp_card"] = _tp_card(**payload["tp_card"])
    if "ep_forward" in payload:
        out["ep_forward"] = _ep_forward(**payload["ep_forward"])
    out["refusals"] = _refusals(world)
    return out


def _cfg(arch: str, **kw):
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype="float32", **kw)


def _ctx(shape, axes):
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    return steps.mesh_ctx(make_mesh(tuple(shape), tuple(axes)))


def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _state(cfg, tree, ctx, compressed: bool):
    from repro_torch.models.lm import build_model, params_from_numpy
    from repro_torch.train import compression, trainstep
    model = build_model(cfg)
    params = params_from_numpy(cfg, tree, device="cpu", trainable=True)
    state = trainstep.shard_state(model, params, ctx)
    if compressed:
        state["ef"] = compression.ef_init(dict(params.named_parameters()))
    return model, state


def _whole(state, model, ctx) -> dict:
    """Every leaf of the state, assembled from the ranks' pieces (rank 0
    keeps them)."""
    from repro_torch.launch import steps
    from repro_torch.train import trainstep
    whole = steps.abstract_state(model)
    if "ef" in state:
        whole["ef"] = {}
    shardings = steps.state_shardings(whole, model.cfg, ctx.mesh)
    tree = trainstep.state_tree(state)
    out = {}
    for part in ("params", "opt_state", "ef"):
        if part not in tree:
            continue
        names = ("m", "v") if part == "opt_state" else (None,)
        for sub in names:
            leaves = tree[part][sub] if sub else tree[part]
            shards = shardings[part][sub] if sub else shardings[part]
            key = sub or part
            out[key] = {k: shards[k].gather(leaves[k]).cpu().numpy()
                        for k in sorted(leaves)}
    return out if ctx.mesh.get_rank() == 0 else None


def _steps(arch, mesh, tree, batches, compressed=False, cfg_kw=None,
           remat=True, score_budget=None):
    """Three steps of the sharded (or compressed) step from the carried
    weights: each step's metrics on this rank, then the whole params, m,
    v (and ef) from rank 0.  ``score_budget``: attention's
    ``SCORE_BUDGET_BYTES`` for these steps (a small one cuts the query
    rows into chunks)."""
    from repro_torch.models import attention
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep
    budget = attention.SCORE_BUDGET_BYTES
    if score_budget is not None:
        attention.SCORE_BUDGET_BYTES = score_budget
    cfg = _cfg(arch, **(cfg_kw or {}))
    ctx = _ctx(*mesh)
    model, state = _state(cfg, tree, ctx, compressed)
    ocfg = opt.AdamWConfig(**OCFG)
    step = (trainstep.make_compressed_train_step(model, ocfg, ctx, remat)
            if compressed else
            trainstep.make_train_step(model, ocfg, remat=remat, ctx=ctx))
    metrics = []
    for b in batches:
        state, m = step(state, _batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    local = {k: tuple(p.shape)
             for k, p in state["params"].named_parameters()}
    attention.SCORE_BUDGET_BYTES = budget
    return {"metrics": metrics, "whole": _whole(state, model, ctx),
            "local_shapes": local, "step": int(state["opt_state"]["step"])}


def _compression(shape, axes, x, tree, steps):
    """``compressed_pmean`` of this rank's piece of its pod's ``x[pod]``
    (cut over ``data`` along dim 0), and ``ef_compressed_pmean`` over
    ``steps`` rounds of the tree (a leaf cut over ``data`` and a whole
    one), the residual carried: the pieces, assembled on rank 0."""
    from repro_torch.sharding.layout import shard_of
    from repro_torch.train import compression
    ctx = _ctx(shape, axes)
    pod = ctx.pod_rank

    def cut(a, spec):
        sh = shard_of(a.shape, spec, ctx.mesh)
        return sh, sh.local(torch.from_numpy(a))

    sh, piece = cut(x[pod], ("data",))
    mean = sh.gather(compression.compressed_pmean(piece, ctx))
    specs = {"cut": ("data", None), "whole": (None,)}
    ef = None
    synced = []
    for t in range(steps):
        g = {k: cut(v[t][pod], specs[k]) for k, v in tree.items()}
        shards = {k: s for k, (s, _) in g.items()}
        local = {k: p for k, (_, p) in g.items()}
        ef = compression.ef_init(local) if ef is None else ef
        out, ef = compression.ef_compressed_pmean(local, ef, ctx)
        synced.append({k: shards[k].gather(v).numpy()
                       for k, v in out.items()})
    # the residual is each pod's own: [pods, ...] over ("pod", ...)
    ef_whole = {k: shard_of((ctx.pod,) + tuple(tree[k].shape[2:]),
                            ("pod",) + specs[k], ctx.mesh)
                .gather(v[None]).numpy() for k, v in ef.items()}
    return {"mean": mean.numpy(), "synced": synced, "ef": ef_whole,
            "pod": pod}


def _save(arch, mesh, tree, batches, directory, save_after):
    """The uninterrupted run: ``len(batches)`` steps, the state saved
    (sharded) after ``save_after`` of them; each step's metrics."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import steps as tsteps
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep
    cfg = _cfg(arch)
    ctx = _ctx(*mesh)
    model, state = _state(cfg, tree, ctx, False)
    step = trainstep.make_train_step(model, opt.AdamWConfig(**OCFG),
                                     ctx=ctx)
    mgr = CheckpointManager(directory, keep=2)
    shardings = tsteps.state_shardings(tsteps.abstract_state(model), cfg,
                                       ctx.mesh)
    metrics = []
    for i, b in enumerate(batches):
        state, m = step(state, _batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
        if i + 1 == save_after:
            mgr.save(i + 1, trainstep.state_tree(state), shardings)
            mgr.wait()
    return {"metrics": metrics, "local_shapes": {
        k: tuple(p.shape) for k, p in state["params"].named_parameters()}}


def _restore(arch, directory, batches, world):
    """``remesh_state`` onto a ``world``-rank (data, model=1) mesh (one
    rank: a (1, 1) mesh), the state loaded into a fresh sharded state,
    then the remaining steps."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import steps as tsteps
    from repro_torch.models.lm import build_model
    from repro_torch.runtime import remesh_state
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep
    cfg = _cfg(arch)
    model = build_model(cfg)
    mgr = CheckpointManager(directory, keep=2)
    step0, tree, mesh = remesh_state(
        mgr, cfg, lambda: tsteps.abstract_state(model), world,
        model_parallel=1)
    ctx = tsteps.mesh_ctx(mesh)
    state = trainstep.init_state(model, seed=1, device="cpu", ctx=ctx)
    trainstep.load_state_tree(state, tree)
    step = trainstep.make_train_step(model, opt.AdamWConfig(**OCFG),
                                     ctx=ctx)
    metrics = []
    for b in batches:
        state, m = step(state, _batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"step0": step0, "mesh": (tuple(mesh.mesh_dim_names),
                                     tuple(mesh.shape)),
            "metrics": metrics, "step": int(state["opt_state"]["step"])}


def _count(arch, mesh, tree, batch, compressed=False, cfg_kw=None):
    """The collectives one step issues, as ``sharding.collectives``
    records them: (kind, operand bytes, group size, wire bytes, dtype,
    axis)."""
    from repro_torch.sharding import collectives
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep
    cfg = _cfg(arch, **(cfg_kw or {}))
    ctx = _ctx(*mesh)
    model, state = _state(cfg, tree, ctx, compressed)
    ocfg = opt.AdamWConfig(**OCFG)
    step = (trainstep.make_compressed_train_step(model, ocfg, ctx)
            if compressed else
            trainstep.make_train_step(model, ocfg, ctx=ctx))
    with collectives.recording() as log:
        step(state, _batch(batch))
    return {"log": [dataclasses.astuple(r) for r in log],
            "summary": collectives.summarize(log)}


def _launcher(argv):
    """``launch.train.main`` across this process group (``--mesh``), its
    checkpoint read back whole on every rank."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    train.main(argv)
    directory = argv[argv.index("--ckpt-dir") + 1]
    step, tree = CheckpointManager(directory).restore()
    return {"step": step, "params": tree["params"]}


def _refusal(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as err:
        return f"{type(err).__name__}: {err}"
    return ""


def _runs(model, ocfg, ctx) -> str:
    """One step of ``model`` on ``ctx`` from seed 0 (2 rows of 17
    tokens): "" where it builds and runs to a finite loss, else the
    refusal or the failure."""
    from repro_torch.train import trainstep

    def run():
        state = trainstep.init_state(model, seed=0, device="cpu", ctx=ctx)
        step = trainstep.make_train_step(model, ocfg, ctx=ctx)
        tokens = np.random.default_rng(0).integers(
            0, model.cfg.vocab_size, (2, 17)).astype(np.int32)
        _, m = step(state, {"tokens": torch.from_numpy(tokens)})
        if not np.isfinite(float(m["loss"])):
            raise ValueError(f"loss {float(m['loss'])}")
    return _refusal(run)


def _refusals(world: int) -> dict:
    """The sharded step on a model axis of ``world`` ranks: a dense model,
    a MoE (expert parallelism) and a head count the axis does not divide
    (the sequence-sharded attention) build and run; refused: the
    compressed step on a mesh without ``pod`` and on a model axis of
    more than one rank, a vocabulary an odd model axis does not divide,
    and the sharded step of an encoder-decoder."""
    import types
    from repro_torch.models.lm import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep, zero
    model = build_model(_cfg("yi-9b"))
    ocfg = opt.AdamWConfig(**OCFG)
    tp = _ctx((1, world), ("data", "model"))
    dp = _ctx((world, 1), ("data", "model"))
    odd = build_model(_cfg("yi-9b", n_heads=3, n_kv_heads=1))
    pods = types.SimpleNamespace(tp=2, mesh=types.SimpleNamespace(
        mesh_dim_names=("pod", "data", "model")))
    return {
        "model_axis": _refusal(lambda: trainstep.make_train_step(
            model, ocfg, ctx=tp)),
        "model_axis_state": _refusal(lambda: trainstep.init_state(
            model, device="cpu", ctx=tp)),
        "moe": _runs(build_model(_cfg("qwen3-moe-30b-a3b")), ocfg, tp),
        "heads": _runs(odd, ocfg, tp),
        "no_pod": _refusal(lambda: trainstep.make_compressed_train_step(
            model, ocfg, dp)),
        "compressed_tp": _refusal(
            lambda: trainstep.make_compressed_train_step(model, ocfg, pods)),
        "vocab": _refusal(lambda: zero.layout(
            model, types.SimpleNamespace(tp=3))),
        "whisper": _refusal(lambda: trainstep.make_train_step(
            build_model(_cfg("whisper-medium")), ocfg, ctx=dp)),
    }


def _moe(tree, x):
    """The MoE layer of the reduced Qwen3-MoE (f32) on ``x`` under the
    context of a (data=1, model=world) mesh of this process group (the
    weights whole on each rank, as sharded serving keeps them):
    ``moe_forward(ctx)``'s output and router loss."""
    import torch.distributed as dist
    from repro_torch.models import moe
    cfg = _cfg("qwen3-moe-30b-a3b")
    ctx = _ctx((1, dist.get_world_size()), ("data", "model"))
    p = moe.MoE(*(torch.from_numpy(tree[k])
                  for k in ("router", "w_in", "w_gate", "w_out")))
    y, aux = moe.moe_forward(p, torch.from_numpy(x), cfg, ctx)
    return {"y": y.numpy(), "aux": float(aux), "tp": ctx.tp}


def _ep_forward(tree, x, gy, mesh):
    """The reduced Qwen3-MoE's MoE layer (f32) on ``x`` in a
    tensor-parallel forward over ``mesh`` (whole sequence at the
    boundary), this rank holding only its model block of the experts:
    ``moe_forward``'s output and router loss, its collectives, and the
    gradients of (y · gy).sum() + aux in x, the router (its ranks' parts
    summed) and this rank's experts."""
    import dataclasses as dc
    from repro_torch.models import moe
    from repro_torch.sharding import collectives
    cfg = _cfg("qwen3-moe-30b-a3b")
    ctx = dc.replace(_ctx(*mesh), seq_sharded=False)
    e_loc = cfg.moe.n_experts // ctx.tp
    mine = slice(ctx.tp_rank * e_loc, (ctx.tp_rank + 1) * e_loc)
    ws = {k: torch.from_numpy(tree[k]) for k in ("router", "w_in",
                                                  "w_gate", "w_out")}
    p = moe.MoE(ws["router"], *(ws[k][mine].clone()
                                for k in ("w_in", "w_gate", "w_out")))
    p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    with collectives.recording() as log:
        y, aux = moe.moe_forward(p, xt, cfg, ctx)
        loss = (y * torch.from_numpy(gy)).sum() + aux
        grads = torch.autograd.grad(loss, [xt] + list(p.parameters()))
    names = ["x"] + [n for n, _ in p.named_parameters()]
    return {"y": y.detach().numpy(), "aux": float(aux), "tp": ctx.tp,
            "rank": ctx.tp_rank, "local": tuple(p.w_in.shape),
            "grads": {n: g.numpy() for n, g in zip(names, grads)},
            "log": [dataclasses.astuple(r) for r in log]}


def _tp_card(arch, mesh, batch, cfg_kw=None):
    """One tensor-parallel step of the reduced ``arch`` (f32, with
    ``cfg_kw``) on the card (every rank on cuda:0), from seed 0, with the
    kernels and with ``mode="ref"``: each run's metrics, the kernels'
    launches on this rank, and the whole params (rank 0)."""
    from repro_torch.kernels import cuda
    from repro_torch.models.lm import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep
    torch.cuda.set_device(0)
    cfg = _cfg(arch, **(cfg_kw or {}))
    model = build_model(cfg)
    ctx = _ctx(*mesh)
    out = {}
    for mode in (None, "ref"):
        state = trainstep.init_state(model, seed=0, device="cuda", ctx=ctx)
        step = trainstep.make_train_step(model, opt.AdamWConfig(**OCFG),
                                         mode=mode, ctx=ctx)
        for k in cuda.KERNELS.values():
            k.launches = 0
        state, m = step(state, {k: torch.from_numpy(v).cuda()
                                for k, v in batch.items()})
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in cuda.KERNELS.items()
                  if k.launches}
        whole = _whole(state, model, ctx)
        out[str(mode)] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "launches": counts,
            "params": None if whole is None else whole["params"]}
    return out
