"""gemver kernels: four steps + the reassembled whole (paper §6.4):
specs, ops, oracles and the K1-instance CUDA kernels of the elementwise
steps.  Each op registers its row with the JAX package's sizes."""
from repro_torch.core import Traffic
from repro_torch.kernels.common import example_input as _rand
from repro_torch.kernels.gemver import ref as _ref
from repro_torch.kernels.gemver.ops import (gemver, gemver_mxv1,
                                            gemver_mxv2, gemver_outer,
                                            gemver_sum)
from repro_torch.registry.base import KernelSpec, register

__all__ = ["gemver", "gemver_outer", "gemver_sum", "gemver_mxv1",
           "gemver_mxv2"]

_SIZES = {"m": 48, "n": 256}
_ALIASED = {"m": 32, "n": 128}   # 4 KiB inter-stream spacing (§4.5)
_BENCH = {"m": 4096, "n": 4096}


def _shape(s):
    return (s["m"], s["n"])


register(KernelSpec(
    name="gemver_outer", family="gemver", fn=gemver_outer,
    make_inputs=lambda s, dt, dev: (
        _rand(_shape(s), 0, dt, dev), _rand((s["m"],), 1, dt, dev),
        _rand((s["n"],), 2, dt, dev), _rand((s["m"],), 3, dt, dev),
        _rand((s["n"],), 4, dt, dev)),
    # op signature is (a, u1, v1, u2, v2)
    run=lambda inp, cfg, mode: gemver_outer(inp[0], inp[1], inp[2], inp[3],
                                            inp[4], config=cfg, mode=mode),
    ref=lambda inp, cfg: _ref.outer_ref(inp[0], inp[1], inp[2], inp[3],
                                        inp[4]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: Traffic(rows=s["m"], cols=s["n"], dtype=dt,
                                  read_arrays=1, write_arrays=1),
    cache_shape=_shape, bench_sizes=_BENCH, tags=("paper",)))

register(KernelSpec(
    name="gemver_sum", family="gemver", fn=gemver_sum,
    make_inputs=lambda s, dt, dev: (_rand((s["vn"],), 0, dt, dev),
                                    _rand((s["vn"],), 1, dt, dev)),
    run=lambda inp, cfg, mode: gemver_sum(inp[0], inp[1], config=cfg,
                                          mode=mode),
    ref=lambda inp, cfg: _ref.sum_ref(inp[0], inp[1]),
    default_sizes={"vn": 1000}, aliased_sizes={"vn": 2048},
    # the 1-D loop is blocked into [vn/1024, 1024] tiles (§5.1.1)
    traffic=lambda s, dt: Traffic(rows=max(s["vn"] // 1024, 4), cols=1024,
                                  dtype=dt, read_arrays=2, write_arrays=1),
    cache_shape=lambda s: (s["vn"],),
    bench_sizes={"vn": 4 * 2**20}, tags=("paper",)))

register(KernelSpec(
    name="gemver_mxv1", family="gemver", fn=gemver_mxv1,
    make_inputs=lambda s, dt, dev: (_rand(_shape(s), 0, dt, dev),
                                    _rand((s["m"],), 1, dt, dev),
                                    _rand((s["n"],), 2, dt, dev), 1.2),
    run=lambda inp, cfg, mode: gemver_mxv1(inp[0], inp[1], inp[2], inp[3],
                                           config=cfg, mode=mode),
    ref=lambda inp, cfg: _ref.mxv1_ref(inp[0], inp[1], inp[2], inp[3]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: Traffic(rows=s["m"], cols=s["n"], dtype=dt,
                                  read_arrays=2),
    cache_shape=_shape, bench_sizes=_BENCH, tags=("paper",)))

register(KernelSpec(
    name="gemver_mxv2", family="gemver", fn=gemver_mxv2,
    make_inputs=lambda s, dt, dev: (_rand(_shape(s), 0, dt, dev),
                                    _rand((s["n"],), 1, dt, dev), 1.5),
    run=lambda inp, cfg, mode: gemver_mxv2(inp[0], inp[1], inp[2],
                                           config=cfg, mode=mode),
    ref=lambda inp, cfg: _ref.mxv2_ref(inp[0], inp[1], inp[2]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: Traffic(rows=s["m"], cols=s["n"], dtype=dt,
                                  read_arrays=1),
    cache_shape=_shape, bench_sizes=_BENCH, tags=("paper",)))

register(KernelSpec(
    name="gemver", family="gemver", fn=gemver,
    make_inputs=lambda s, dt, dev: (
        _rand(_shape(s), 0, dt, dev), _rand((s["m"],), 1, dt, dev),
        _rand((s["n"],), 2, dt, dev), _rand((s["m"],), 3, dt, dev),
        _rand((s["n"],), 4, dt, dev), _rand((s["m"],), 5, dt, dev),
        _rand((s["n"],), 6, dt, dev), 1.5, 1.2),
    run=lambda inp, cfg, mode: gemver(*inp, config=cfg, mode=mode),
    ref=lambda inp, cfg: _ref.gemver_ref(*inp),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: Traffic(rows=s["m"], cols=s["n"], dtype=dt,
                                  read_arrays=1, write_arrays=1),
    cache_shape=_shape, bench_sizes=_BENCH,
    rtol=1e-3, atol=1e-3, tags=("paper",)))
