"""doitgen (PolyBench: MADNESS multi-resolution analysis): spec, op,
oracle and its K1-instance CUDA kernel (``kernel.py``,
``csrc/doitgen.cu``).  The op registers its row with the JAX package's
sizes (``src/repro/kernels/doitgen/__init__.py``)."""
from repro_torch.core import Traffic
from repro_torch.kernels.common import example_input as _rand
from repro_torch.kernels.doitgen import ref as _ref
from repro_torch.kernels.doitgen.ops import doitgen
from repro_torch.registry.base import KernelSpec, register

__all__ = ["doitgen"]

_SIZES = {"r": 4, "q": 8, "s": 32}
# m = r*q = 128 rows of 32 f32 → (128/4)*32*4 B = 4 KiB spacing (§4.5)
_ALIASED = {"r": 8, "q": 16, "s": 32}
bench_sizes = {"r": 16, "q": 256, "s": 256}

register(KernelSpec(
    name="doitgen", family="doitgen", fn=doitgen,
    make_inputs=lambda s, dt, dev: (
        _rand((s["r"], s["q"], s["s"]), 0, dt, dev),
        _rand((s["s"], s["s"]), 1, dt, dev)),
    run=lambda inp, cfg, mode: doitgen(inp[0], inp[1], config=cfg,
                                       mode=mode),
    ref=lambda inp, cfg: _ref.doitgen_ref(inp[0], inp[1]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: Traffic(rows=s["r"] * s["q"], cols=s["s"],
                                  dtype=dt, read_arrays=1, write_arrays=1,
                                  resident_bytes=s["s"] * s["s"] * 4),
    cache_shape=lambda s: (s["r"], s["q"], s["s"]),
    bench_sizes=bench_sizes, tags=("paper",)))
