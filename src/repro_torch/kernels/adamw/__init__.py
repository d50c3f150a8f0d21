"""Fused AdamW optimizer update (spec, the per-tensor op and the
in-place op over a list of tensors, oracle and their K1-instance CUDA
kernel; the K4 ring's adamw body is in ``kernels/manual.py``).
The op registers its row with the JAX package's sizes."""
from repro_torch.core import Traffic
from repro_torch.kernels.adamw import ref as _ref
from repro_torch.kernels.adamw.ops import (_blocking, adamw_update,
                                           adamw_update_many)
from repro_torch.kernels.common import example_input as _rand
from repro_torch.registry.base import KernelSpec, register

__all__ = ["adamw_update", "adamw_update_many"]

# (60, 100) exercises the flatten+pad path (n=6000 → 12x512 blocking);
# n=16384 → 32x512 blocking is the aliased point; the bench size
# re-blocks to [8192, 512]
_SIZES = {"rows": 60, "cols": 100}
_ALIASED = {"rows": 128, "cols": 128}
_BENCH = {"rows": 4096, "cols": 1024}
_HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01,
              bc1=0.5, bc2=0.25)


def _inputs(s, dt, dev):
    shape = (s["rows"], s["cols"])
    return (_rand(shape, 0, dt, dev), _rand(shape, 1, dt, dev),
            _rand(shape, 2, dt, dev), _rand(shape, 3, device=dev).abs())


def _wire_traffic(s, dt):
    # the kernel flattens the tensor and re-blocks it; mirror ops._blocking
    rows, cols = _blocking(s["rows"] * s["cols"])
    # 4 read + 3 write arrays per stride: write-stream cap applies
    return Traffic(rows=rows, cols=cols, dtype=dt,
                   read_arrays=4, write_arrays=3)


register(KernelSpec(
    name="adamw_update", family="adamw", fn=adamw_update,
    make_inputs=_inputs,
    run=lambda inp, cfg, mode: adamw_update(*inp, config=cfg, mode=mode,
                                            **_HYPER),
    ref=lambda inp, cfg: _ref.adamw_ref(*inp, **_HYPER),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=_wire_traffic,
    cache_shape=lambda s: (s["rows"], s["cols"]),
    bench_sizes=_BENCH,
    rtol=1e-5, atol=1e-6, tags=("framework",)))
