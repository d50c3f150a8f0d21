"""3x3 correlation stencil (paper conv): spec, op, oracle; its
K1-instance CUDA kernel is ``kernels/stencil.py``
(``csrc/stencil.cu``).  The op registers its row with the JAX package's
sizes (``src/repro/kernels/conv3x3/__init__.py``)."""
from repro_torch.core import Traffic as _Traffic
from repro_torch.kernels.common import example_input as _rand
from repro_torch.kernels.conv3x3 import ref as _ref
from repro_torch.kernels.conv3x3.ops import conv3x3
from repro_torch.registry.base import KernelSpec, register

__all__ = ["conv3x3"]

# h_out = h - 2 must be divisible by the conformance D points
_SIZES = {"h": 34, "w": 130}
_ALIASED = {"h": 34, "w": 128}   # pow-2 input row length → aliased streams
bench_sizes = {"h": 2050, "w": 2048}

register(KernelSpec(
    name="conv3x3", family="conv3x3", fn=conv3x3,
    make_inputs=lambda s, dt, dev: (_rand((s["h"], s["w"]), 0, dt, dev),
                                    _rand((3, 3), 1, dt, dev)),
    run=lambda inp, cfg, mode: conv3x3(inp[0], inp[1], config=cfg,
                                       mode=mode),
    ref=lambda inp, cfg: _ref.conv3x3_ref(inp[0], inp[1]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: _Traffic(rows=s["h"] - 2, cols=s["w"], dtype=dt,
                                   read_arrays=3, write_arrays=1),
    cache_shape=lambda s: (s["h"], s["w"]),
    bench_sizes=bench_sizes, tags=("paper",)))
