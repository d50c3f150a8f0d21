"""Fused RMSNorm (spec, op, oracle and its K1-instance CUDA kernel).
The op registers its row with the JAX package's sizes."""
from repro_torch.core import Traffic as _Traffic
from repro_torch.kernels.common import example_input as _rand
from repro_torch.kernels.rmsnorm import ref as _ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.registry.base import KernelSpec, register

__all__ = ["rmsnorm"]

_SIZES = {"t": 32, "dm": 256}
_ALIASED = {"t": 32, "dm": 128}   # (32/4)*128*4 B = 4 KiB spacing (§4.5)

register(KernelSpec(
    name="rmsnorm", family="rmsnorm", fn=rmsnorm,
    make_inputs=lambda s, dt, dev: (_rand((s["t"], s["dm"]), 0, dt, dev),
                                    _rand((s["dm"],), 1, dt, dev)),
    run=lambda inp, cfg, mode: rmsnorm(inp[0], inp[1], config=cfg,
                                       mode=mode),
    ref=lambda inp, cfg: _ref.rmsnorm_ref(inp[0], inp[1]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: _Traffic(rows=s["t"], cols=s["dm"], dtype=dt,
                                   read_arrays=1, write_arrays=1,
                                   resident_bytes=s["dm"] * 4),
    cache_shape=lambda s: (s["t"], s["dm"]),
    bench_sizes={"t": 4096, "dm": 4096},
    rtol=1e-5, atol=1e-5, tags=("framework",)))
