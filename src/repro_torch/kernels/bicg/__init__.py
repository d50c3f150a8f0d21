"""Fused BiCG kernel (paper Table 1, PolyBench bicg): specs, op and
oracle; its sweeps run the mxv family's K2 and K3 CUDA kernels.  The op
registers its row with the JAX package's sizes."""
from repro_torch.core import Traffic
from repro_torch.kernels.bicg import ref as _ref
from repro_torch.kernels.bicg.ops import bicg
from repro_torch.kernels.common import example_input as _rand
from repro_torch.registry.base import KernelSpec, register

__all__ = ["bicg"]

_SIZES = {"m": 48, "n": 256}
_ALIASED = {"m": 32, "n": 128}   # 4 KiB inter-stream spacing (§4.5)

register(KernelSpec(
    name="bicg", family="bicg", fn=bicg,
    make_inputs=lambda s, dt, dev: (_rand((s["m"], s["n"]), 0, dt, dev),
                                    _rand((s["m"],), 1, dt, dev),
                                    _rand((s["n"],), 2, dt, dev)),
    run=lambda inp, cfg, mode: bicg(inp[0], inp[1], inp[2], config=cfg,
                                    mode=mode),
    ref=lambda inp, cfg: _ref.bicg_ref(inp[0], inp[1], inp[2]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: Traffic(rows=s["m"], cols=s["n"], dtype=dt,
                                  read_arrays=2),
    cache_shape=lambda s: (s["m"], s["n"]),
    bench_sizes={"m": 4096, "n": 4096}, tags=("paper",)))
