"""2D Jacobi 5-point stencil sweep (PolyBench jacobi-2d): spec, op,
oracle; its K1-instance CUDA kernel is ``kernels/stencil.py``
(``csrc/stencil.cu``).  The op registers its row with the JAX package's
sizes (``src/repro/kernels/jacobi2d/__init__.py``)."""
from repro_torch.core import Traffic as _Traffic
from repro_torch.kernels.common import example_input as _rand
from repro_torch.kernels.jacobi2d import ref as _ref
from repro_torch.kernels.jacobi2d.ops import jacobi2d
from repro_torch.registry.base import KernelSpec, register

__all__ = ["jacobi2d"]

_SIZES = {"h": 34, "w": 130}
_ALIASED = {"h": 34, "w": 128}   # pow-2 input row length → aliased streams
bench_sizes = {"h": 2050, "w": 2048}

register(KernelSpec(
    name="jacobi2d", family="jacobi2d", fn=jacobi2d,
    make_inputs=lambda s, dt, dev: (_rand((s["h"], s["w"]), 0, dt, dev),),
    run=lambda inp, cfg, mode: jacobi2d(inp[0], config=cfg, mode=mode),
    ref=lambda inp, cfg: _ref.jacobi2d_ref(inp[0]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: _Traffic(rows=s["h"] - 2, cols=s["w"], dtype=dt,
                                   read_arrays=3, write_arrays=1),
    cache_shape=lambda s: (s["h"], s["w"]),
    bench_sizes=bench_sizes,
    rtol=1e-5, atol=1e-5, tags=("paper",)))
