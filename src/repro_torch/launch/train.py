"""Training launcher: ``python -m repro_torch.launch.train --arch yi-9b``

Data pipeline → train step (loss with activation checkpointing →
backward → fused multi-strided AdamW) → checkpoint manager → straggler
monitor, as the JAX package's ``repro.launch.train``, on one card (the
default; it raises without one) or, with ``--device cpu``, on the CPU
through the kernels' plain versions.  The config is reduced to smoke-test
size unless ``--no-reduced``; ``--layers`` overrides its depth.
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
from repro_torch.models.lm import build_model
from repro_torch.runtime.fault_tolerance import StepMonitor
from repro_torch.train import AdamWConfig, make_train_step
from repro_torch.train.trainstep import (init_state, load_state_tree,
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
    return ap.parse_args(argv)


def setup(argv=None) -> SimpleNamespace:
    """Everything the loop needs: args, cfg, model, the train step, the
    data pipeline, the checkpoint manager, the monitor, the state, and
    the first step (after ``--resume``)."""
    args = parse(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(model, ocfg, remat=True)
    data = make_pipeline(DataConfig(seq_len=args.seq,
                                    global_batch=args.batch,
                                    vocab_size=cfg.vocab_size))
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    state = init_state(model, seed=0, device=dev)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        start, tree = mgr.restore(device=dev)
        load_state_tree(state, tree)
        print(f"resumed from step {start}")
    return SimpleNamespace(args=args, cfg=cfg, model=model, ocfg=ocfg,
                           step_fn=step_fn, data=data, mgr=mgr,
                           monitor=StepMonitor(), state=state, start=start,
                           device=dev)


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
            print(f"step {step:5d}  loss {metrics['loss']:.4f}  "
                  f"lr {metrics['lr']:.2e}  gnorm {metrics['grad_norm']:.2f}"
                  f"  {monitor.medians().get(HOST, 0):.2f}s/step")
        if step and step % args.ckpt_every == 0:
            run.mgr.save(step, state_tree(state))
    run.mgr.save(args.steps, state_tree(state))
    run.mgr.wait()
    print(f"done; checkpoints: {run.mgr.all_steps()}")
    if monitor.stragglers():
        print("stragglers flagged:", monitor.stragglers())
    return state


if __name__ == "__main__":
    main()
