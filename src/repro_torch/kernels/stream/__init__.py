"""Stream micro-kernels (paper §4): read / copy / init / manual copy —
specs, ops, oracles, the K1 and K2 instances of ``csrc/stream.cu``
(``kernel.py``); the K4 ring is ``kernels/manual.py``.  Each op
registers its row with the JAX package's sizes
(``src/repro/kernels/stream/__init__.py``)."""
from repro_torch.core import Traffic
from repro_torch.kernels.common import example_input as _rand
from repro_torch.kernels.stream import ref as _ref
from repro_torch.kernels.stream.ops import (stream_copy, stream_copy_manual,
                                            stream_init, stream_read)
from repro_torch.registry.base import KernelSpec, register

__all__ = ["stream_read", "stream_copy", "stream_init", "stream_copy_manual"]

_SIZES = {"rows": 32, "cols": 256}
# (32/4) rows * 128 cols * 4 B = 4 KiB inter-stream spacing: an exact
# power of two at the aliasing granularity (paper §4.5)
_ALIASED = {"rows": 32, "cols": 128}
_BENCH = {"rows": 8192, "cols": 4096}


def _traffic(reads, writes):
    def build(sizes, dtype):
        return Traffic(rows=sizes["rows"], cols=sizes["cols"], dtype=dtype,
                       read_arrays=reads, write_arrays=writes)
    return build


def _shape(sizes):
    return (sizes["rows"], sizes["cols"])


register(KernelSpec(
    name="stream_read", family="stream", fn=stream_read,
    make_inputs=lambda s, dt, dev: (_rand(_shape(s), 0, dt, dev),),
    run=lambda inp, cfg, mode: stream_read(inp[0], config=cfg, mode=mode),
    ref=lambda inp, cfg: _ref.read_ref(inp[0], cfg.stride_unroll),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=_traffic(1, 0), cache_shape=_shape,
    bench_sizes=_BENCH, tags=("paper",)))

register(KernelSpec(
    name="stream_copy", family="stream", fn=stream_copy,
    make_inputs=lambda s, dt, dev: (_rand(_shape(s), 0, dt, dev),),
    run=lambda inp, cfg, mode: stream_copy(inp[0], config=cfg, mode=mode),
    ref=lambda inp, cfg: _ref.copy_ref(inp[0]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=_traffic(1, 1), cache_shape=_shape,
    bench_sizes=_BENCH, tags=("paper",)))

# a writes-only op has no operand to take a device from: its inputs
# carry it
register(KernelSpec(
    name="stream_init", family="stream", fn=stream_init,
    make_inputs=lambda s, dt, dev: (_shape(s), 3.5, dt, dev),
    run=lambda inp, cfg, mode: stream_init(inp[0], inp[1], inp[2],
                                           config=cfg, mode=mode,
                                           device=inp[3]),
    ref=lambda inp, cfg: _ref.init_ref(inp[0], inp[1], inp[2], inp[3]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=_traffic(0, 1), cache_shape=_shape,
    bench_sizes=_BENCH, tags=("paper",)))

register(KernelSpec(
    name="stream_copy_manual", family="stream", fn=stream_copy_manual,
    make_inputs=lambda s, dt, dev: (_rand(_shape(s), 0, dt, dev),),
    run=lambda inp, cfg, mode: stream_copy_manual(inp[0], config=cfg,
                                                  mode=mode),
    ref=lambda inp, cfg: _ref.copy_ref(inp[0]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=_traffic(1, 1), cache_shape=_shape,
    bench_sizes=_BENCH, tags=("paper",)))
