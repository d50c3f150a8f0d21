#!/usr/bin/env python3
"""Where the rmsnorm kernel's output leaves its plain version inside a
training forward, norm call by norm call, and what that does to the
loss.  Needs a CUDA card; imports nothing of JAX.

The model and batch are those of ``launch.steps.build_train_step`` (the
state from seed 0, the builder's seeded batch), so the forward is the
one chip_smoke's train-families phase compares.  Every rmsnorm call of
one forward (no grad, remat off) runs both the kernel and its plain
version (``mode="ref"``) on the same input and passes the kernel's
output on; for each call the script reports the share of output
elements whose bits differ, their mean signed difference in ulps of the
plain output (a bias shows as a mean away from 0) and the largest
inverse-rms difference.  Then it prints the loss of the kernels' forward
and of the plain forward, each twice (a run-to-run difference would be
nondeterminism, not the kernel), and of the plain forward with each
norm call moved by its kernel difference in one half of the model only
(the encoder's calls or the decoder's), to say which half moves the
loss.

    python3 tools/torch_norm_shift.py --arch whisper-medium --batch 4 \\
        --seq 448
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MANTISSA = {"torch.bfloat16": 8, "torch.float16": 11, "torch.float32": 24}


def _ulp(t):
    import torch
    f = t.float()
    return torch.ldexp(torch.ones_like(f), torch.frexp(f).exponent
                       - _MANTISSA[str(t.dtype)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="whisper-medium")
    ap.add_argument("--layers", type=int, default=None,
                    help="decoder layers kept (default: all)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=448)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_norm_shift: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from unittest import mock
    from repro_torch.configs import get_config, get_shape
    from repro_torch.kernels.rmsnorm import ops as trops
    from repro_torch.launch import steps
    from repro_torch.models.lm import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    shape = dataclasses.replace(get_shape("train_4k"),
                                global_batch=args.batch, seq_len=args.seq)
    _, (state, batch) = steps.build_train_step(cfg, shape, "cuda")
    model, params = build_model(cfg), state["params"]
    plain = trops.rmsnorm
    enc_calls = (2 * cfg.n_enc_layers + 1) if cfg.encdec else 0

    def loss(norm=None):
        with torch.no_grad(), (mock.patch.object(trops, "rmsnorm", norm)
                               if norm else contextlib.nullcontext()):
            return float(model.loss(params, batch, remat=False,
                                    mode=None if norm is None else "ref")[0])

    rows, deltas = [], []

    def both(x, w, eps=1e-6, config=None, mode=None, with_inv_rms=False):
        ok, ik = plain(x, w, eps=eps, with_inv_rms=True)
        op, ip = plain(x, w, eps=eps, mode="ref", with_inv_rms=True)
        d = (ok.float() - op.float()) / _ulp(op)
        diff = d != 0
        rows.append({"call": len(rows), "shape": list(x.shape),
                     "dtype": str(x.dtype).removeprefix("torch."),
                     "w_dtype": str(w.dtype).removeprefix("torch."),
                     "differ": int(diff.sum()), "n": d.numel(),
                     "mean_ulp_of_differing": float(d[diff].mean())
                     if bool(diff.any()) else 0.0,
                     "max_ulp": float(d.abs().max()),
                     "inv_max_rel": float(((ik - ip).abs()
                                           / ip.abs()).max())})
        deltas.append(ok.float() - op.float())
        return (ok, ik) if with_inv_rms else ok

    lk = loss(both)
    differ, n = sum(r["differ"] for r in rows), sum(r["n"] for r in rows)
    signed = sum(r["mean_ulp_of_differing"] * r["differ"] for r in rows)
    print(f"{args.arch}: {len(rows)} rmsnorm calls in one forward, "
          f"{differ} of {n} output elements differ from the plain version "
          f"({100 * differ / n:.4f}%), mean signed difference of those "
          f"{signed / max(differ, 1):+.4f} ulp; worst call "
          f"{max(r['max_ulp'] for r in rows):.0f} ulp, inverse rms within "
          f"{max(r['inv_max_rel'] for r in rows):.2e} relative")
    for r in sorted(rows, key=lambda r: -r["differ"])[:6]:
        print("  " + json.dumps(r))

    def shifted(lo, hi):
        it = iter(range(len(deltas)))

        def norm(x, w, eps=1e-6, config=None, mode=None,
                 with_inv_rms=False):
            out, inv = plain(x, w, eps=eps, mode="ref", with_inv_rms=True)
            i = next(it)
            if lo <= i < hi:
                out = (out.float() + deltas[i]).to(out.dtype)
            return (out, inv) if with_inv_rms else out
        return norm
    losses = {"kernels": loss(), "kernels again": loss(),
              "kernels (the call-by-call run)": lk,
              "plain": loss(plain), "plain again": loss(plain)}
    if enc_calls:
        losses["plain, encoder calls moved by the kernels' difference"] = (
            loss(shifted(0, enc_calls)))
        losses["plain, decoder calls moved by the kernels' difference"] = (
            loss(shifted(enc_calls, len(deltas))))
    ref = losses["plain"]
    for k, v in losses.items():
        print(f"  loss {k}: {v:.6f} (rel to plain {(v - ref) / ref:+.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
