"""Training launcher: ``python -m repro_torch.launch.train --arch yi-9b``

Data pipeline → train step (loss with activation checkpointing →
backward → fused multi-strided AdamW) → checkpoint manager → straggler
monitor, as the JAX package's ``repro.launch.train``, on one card (the
default; it raises without one) or, with ``--device cpu``, on the CPU
through the kernels' plain versions.  The config is reduced to smoke-test
size unless ``--no-reduced``; ``--layers`` overrides its depth.

Across ranks: ``torchrun --nproc-per-node K -m repro_torch.launch.train
--mesh data=K`` (or ``--mesh pod=2,data=2``, ``--mesh model=2``,
``--mesh data=2,model=2``): one rank a card under NCCL, or gloo ranks
with ``--device cpu``; the state is sharded ZeRO-3 over ``data`` and cut
over ``model`` for tensor parallelism (Megatron heads, FFN and
vocabulary; a MoE's experts, exchanged by all_to_all; heads the ranks
do not divide stay whole, on the sequence-sharded attention), the batch
over ``(pod, data)``
(``trainstep.make_train_step(..., ctx=)``), ``--compressed-pod-sync``
averages gradients across pods as int8 with error feedback.
Checkpoints are whole leaves on disk, written by rank 0.  A process
group already initialised (a test's) is used as it is.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from types import SimpleNamespace

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import steps
from repro_torch.models.lm import build_model
from repro_torch.runtime.fault_tolerance import StepMonitor
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.trainstep import (init_compressed_state, init_state,
                                         load_state_tree,
                                         make_compressed_train_step,
                                         state_tree)

HOST = "host0"          # one process: the monitor's only host


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="reduced config (CPU-sized); "
                    "--no-reduced keeps the published widths")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the config's n_layers")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="train on the card (default) or with the CPU's "
                         "plain kernel versions")
    ap.add_argument("--mesh", default=None,
                    help="train across the ranks of torchrun: axis=size "
                         "pairs, e.g. data=4, pod=2,data=2, model=2 or "
                         "data=2,model=2")
    ap.add_argument("--compressed-pod-sync", action="store_true",
                    help="int8 error-feedback gradient mean across pods "
                         "(needs a pod axis in --mesh)")
    return ap.parse_args(argv)


def parse_mesh(text: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"pod=2,data=2"`` → ((2, 2), ("pod", "data"))."""
    pairs = [p.split("=") for p in text.split(",")]
    if any(len(p) != 2 for p in pairs):
        raise ValueError(f"--mesh {text!r}: want axis=size pairs")
    return (tuple(int(n) for _, n in pairs),
            tuple(a.strip() for a, _ in pairs))


def _mesh_ctx(args):
    """This rank's device and the MeshCtx of ``--mesh`` over the process
    group (initialised from torchrun's environment unless a caller did:
    ``launch.serve.process_group``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import process_group
    shape, axes = parse_mesh(args.mesh)
    dev, _ = process_group(args.device)
    return resolve_device(dev), steps.mesh_ctx(make_mesh(shape, axes))


def setup(argv=None) -> SimpleNamespace:
    """Everything the loop needs: args, cfg, model, the train step, the
    data pipeline, the checkpoint manager, the monitor, the state, and
    the first step (after ``--resume``)."""
    args = parse(argv)
    ctx = None
    if args.mesh:
        dev, ctx = _mesh_ctx(args)
    else:
        dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    compressed = args.compressed_pod_sync
    if compressed:
        if ctx is None:
            raise ValueError("--compressed-pod-sync needs --mesh with a pod "
                             "axis")
        step_fn = make_compressed_train_step(model, ocfg, ctx, remat=True)
        state = init_compressed_state(model, seed=0, device=dev, ctx=ctx)
    else:
        step_fn = make_train_step(model, ocfg, remat=True, ctx=ctx)
        state = init_state(model, seed=0, device=dev, ctx=ctx)
    data = make_pipeline(DataConfig(seq_len=args.seq,
                                    global_batch=args.batch,
                                    vocab_size=cfg.vocab_size))
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    shardings = None
    if ctx is not None:
        whole = steps.abstract_state(model)
        if compressed:
            whole["ef"] = {}
        shardings = steps.state_shardings(whole, cfg, ctx.mesh)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        start, tree = mgr.restore(device=dev, shardings=shardings)
        load_state_tree(state, tree)
        _say(ctx, f"resumed from step {start}")
    return SimpleNamespace(args=args, cfg=cfg, model=model, ocfg=ocfg,
                           step_fn=step_fn, data=data, mgr=mgr,
                           monitor=StepMonitor(), state=state, start=start,
                           device=dev, ctx=ctx, shardings=shardings)


def _say(ctx, text: str) -> None:
    """Print on rank 0 (every rank runs the loop)."""
    if ctx is None or ctx.mesh.get_rank() == 0:
        print(text, flush=True)


def batch_of(run: SimpleNamespace, step: int) -> dict:
    """The pipeline's tokens of ``step`` and, as the JAX launcher adds
    them, zero ``prefix_embeds`` [B, Np, D] for a VLM and zero ``frames``
    [B, enc_seq, D] for Whisper (f32: the frontends are stubs)."""
    cfg, b, dev = run.cfg, run.args.batch, run.device
    batch = {"tokens": torch.from_numpy(run.data.batch(step)).to(dev)}
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = torch.zeros(
            (b, cfg.n_prefix_embeds, cfg.d_model), device=dev)
    if cfg.encdec:
        batch["frames"] = torch.zeros((b, cfg.enc_seq, cfg.d_model),
                                      device=dev)
    return batch


def main(argv=None):
    run = setup(argv)
    args, state, monitor = run.args, run.state, run.monitor
    for step in range(run.start, args.steps):
        batch = batch_of(run, step)
        t0 = time.perf_counter()
        state, metrics = run.step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        monitor.record(HOST, time.perf_counter() - t0)
        if step % args.log_every == 0 or step == args.steps - 1:
            _say(run.ctx, f"step {step:5d}  loss {metrics['loss']:.4f}  "
                 f"lr {metrics['lr']:.2e}  gnorm {metrics['grad_norm']:.2f}"
                 f"  {monitor.medians().get(HOST, 0):.2f}s/step")
        if step and step % args.ckpt_every == 0:
            run.mgr.save(step, state_tree(state), run.shardings)
    run.mgr.save(args.steps, state_tree(state), run.shardings)
    run.mgr.wait()
    _say(run.ctx, f"done; checkpoints: {run.mgr.all_steps()}")
    if monitor.stragglers():
        print("stragglers flagged:", monitor.stragglers())
    return state


if __name__ == "__main__":
    main()
