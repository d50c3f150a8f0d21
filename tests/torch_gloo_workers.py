"""The rank side of ``tests/test_torch_sharded.py``'s process groups.

:func:`run` spawns ``world`` processes, each one rank of a gloo process
group on the CPU (a ``FileStore`` in the test's temporary directory; no
network), and each runs :func:`suite` on the inputs the test made with
numpy.  A rank returns numpy results, which :func:`run` hands back in
rank order; a rank that raises fails the run.  This module imports no
JAX: the test holds the results against the JAX package in its own
process.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def run(world: int, tmp, payload: dict, suite: str = __name__) -> list:
    """``world`` gloo ranks, each running ``suite(rank, world, payload)``
    of the module named ``suite`` (this one by default; a sibling module
    such as ``torch_train_workers`` brings its own)."""
    import torch.multiprocessing as mp
    tmp = str(tmp)
    mp.start_processes(_rank, args=(world, tmp, payload, suite),
                       nprocs=world, start_method="spawn")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank(rank: int, world: int, tmp: str, payload: dict,
          suite: str = __name__) -> None:
    import importlib
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world)
    try:
        fn = importlib.import_module(suite).suite
        torch.save(fn(rank, world, payload),
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def suite(rank: int, world: int, payload: dict) -> dict:
    """Every collective check of one run: the op, each model's decode
    steps, and, where the payload asks, the engine, the launcher and the
    meshes."""
    from repro_torch.serve import serving_ctx
    ctx = serving_ctx(world)
    out = {"tp": ctx.tp, "tp_rank": ctx.tp_rank,
           "op": _op(ctx, **payload["op"]),
           "models": {arch: _model(ctx, arch, **case)
                      for arch, case in payload["models"].items()}}
    if "engine" in payload:
        out["engine"] = _engine(ctx, **payload["engine"])
        out["launcher"] = _launcher(world)
        out["mesh"] = _meshes(world)
    return out


def _op(ctx, q, k, v, kv_lens) -> list:
    """``decode_attn_collective`` on this rank's own copy of its slice of
    the sequence, for each ``kv_len`` (None: the whole sequence)."""
    from repro_torch.kernels.decode_attn import sharded
    sp = k.shape[1] // ctx.tp
    lo = ctx.tp_rank * sp
    kl = torch.from_numpy(k[:, lo:lo + sp].copy())
    vl = torch.from_numpy(v[:, lo:lo + sp].copy())
    return [sharded.decode_attn_collective(
        torch.from_numpy(q), kl, vl,
        kv_len=None if n is None else torch.from_numpy(n), ctx=ctx).numpy()
        for n in kv_lens]


def _model(ctx, arch, tree, tokens, pos, max_len, cross=None) -> dict:
    """Teacher-forced decode steps of the reduced ``arch`` (f32) on the
    carried weights, from a rank-local zero cache: each step's logits and
    every layer's local K and V after the last."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import build_model, params_from_numpy
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(cfg, tree, device="cpu")
    b = tokens[0].shape[0]
    cache = model.init_cache(b, max_len, device="cpu", ctx=ctx)
    if cross is not None:
        cache = {"self": cache,
                 "cross": [{n: torch.from_numpy(c[n]) for n in ("k", "v")}
                           for c in cross]}
    logits = []
    with torch.inference_mode():
        for toks, p in zip(tokens, pos):
            step, cache = model.decode_step(
                params, torch.from_numpy(toks), cache, torch.as_tensor(p),
                ctx=ctx, shards=ctx.tp)
            logits.append(step.numpy())
    layers = cache["self"] if cross is not None else cache
    return {"logits": logits,
            "k": [c["k"].numpy() for c in layers if "k" in c],
            "v": [c["v"].numpy() for c in layers if "v" in c]}


def _engine(ctx, tree, prompts, kw) -> dict:
    """The engine over ``ctx`` on the reduced Yi-9B (f32): its tokens,
    the length of its rank-local cache and its step counts.  A deadline
    no request reaches puts every deadline check through rank 0."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.lm import build_model, params_from_numpy
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = dataclasses.replace(reduced(get_config("yi-9b")),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(cfg, tree, device="cpu")
    eng = ServingEngine(model, params, ServeConfig(
        shards=ctx.tp, deadline_s=600.0, **kw), ctx=ctx)
    for uid, p in prompts.items():
        eng.submit(uid, p)
    results = eng.run()
    return {"results": results,
            "cache_len": eng.cache[0]["k"].shape[1],
            "steps": (eng.stats()["decode_steps"],
                      eng.stats()["prefill_steps"])}


def _launcher(world: int) -> dict:
    from repro_torch.launch import serve
    return serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                       "4", "--shards", str(world)])


def _refusal(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError, NotImplementedError) as err:
        return f"{type(err).__name__}: {err}"
    return ""


def _meshes(world: int) -> dict:
    """``make_mesh`` at (1, world) over ("data", "model") and the MeshCtx
    on it, and the refusals of a group of the wrong size."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.common import MeshCtx
    from repro_torch.models.lm import build_model
    from repro_torch.configs import get_config, reduced
    from repro_torch.serve import serving_ctx
    m = tmesh.make_mesh((1, world), ("data", "model"))
    mctx = MeshCtx(m)
    model = build_model(reduced(get_config("yi-9b")))
    return {
        "names": tuple(m.mesh_dim_names),
        "sizes": (m.size(0), m.size(1)),
        "tp": mctx.tp, "tp_rank": mctx.tp_rank,
        "batch_axes": mctx.batch_axes(3),
        "wrong_shards": _refusal(lambda: serving_ctx(2 * world)),
        "wrong_mesh": _refusal(lambda: tmesh.make_mesh((world + 1,),
                                                       ("model",))),
        "production": _refusal(tmesh.make_production_mesh),
        "prefill": _refusal(lambda: model.prefill(
            model.init(seed=0, device="cpu"),
            {"tokens": np.zeros((1, 4), np.int32)}, max_len=8,
            ctx=serving_ctx(world))),
    }
