"""Fused AdamW optimizer update (spec, op, oracle and its K1-instance
CUDA kernel; the K4 ring's adamw body is in ``kernels/manual.py``)."""
from repro_torch.kernels.adamw.ops import adamw_update

__all__ = ["adamw_update"]

# the JAX registry row's sizes: (60, 100) exercises the flatten+pad path
# (n=6000 → 12x512 blocking); n=16384 → 32x512 blocking is the aliased
# point; the bench size re-blocks to [8192, 512]
_SIZES = {"rows": 60, "cols": 100}
_ALIASED = {"rows": 128, "cols": 128}
_BENCH = {"rows": 4096, "cols": 1024}
_HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01,
              bc1=0.5, bc2=0.25)
