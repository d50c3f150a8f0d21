"""Matrix-vector kernels (paper mxv / Listing 1 mxv_t): specs, ops,
oracles and the K2 row-dot and K3 column-dot CUDA kernels.  Each op
registers its row with the JAX package's sizes."""
from repro_torch.core import Traffic
from repro_torch.kernels.common import example_input as _rand
from repro_torch.kernels.mxv import ref as _ref
from repro_torch.kernels.mxv.ops import mxv, mxv_t
from repro_torch.registry.base import KernelSpec, register

__all__ = ["mxv", "mxv_t"]

_SIZES = {"m": 48, "n": 256}
_ALIASED = {"m": 32, "n": 128}   # (32/4)*128*4 B = 4 KiB spacing (§4.5)
_BENCH = {"m": 4096, "n": 4096}


def _shape(s):
    return (s["m"], s["n"])


register(KernelSpec(
    name="mxv", family="mxv", fn=mxv,
    make_inputs=lambda s, dt, dev: (_rand(_shape(s), 0, dt, dev),
                                    _rand((s["n"],), 1, dt, dev)),
    run=lambda inp, cfg, mode: mxv(inp[0], inp[1], config=cfg, mode=mode),
    ref=lambda inp, cfg: _ref.mxv_ref(inp[0], inp[1]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: Traffic(rows=s["m"], cols=s["n"], dtype=dt,
                                  read_arrays=1),
    cache_shape=_shape, bench_sizes=_BENCH, tags=("paper",)))

register(KernelSpec(
    name="mxv_t", family="mxv", fn=mxv_t,
    make_inputs=lambda s, dt, dev: (_rand(_shape(s), 0, dt, dev),
                                    _rand((s["m"],), 1, dt, dev)),
    run=lambda inp, cfg, mode: mxv_t(inp[0], inp[1], config=cfg, mode=mode),
    ref=lambda inp, cfg: _ref.mxv_t_ref(inp[0], inp[1]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: Traffic(rows=s["m"], cols=s["n"], dtype=dt,
                                  read_arrays=2),
    cache_shape=_shape, bench_sizes=_BENCH, tags=("paper",)))
