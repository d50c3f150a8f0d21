"""Multi-strided flash-decode attention (spec, op, oracle and its
K3-instance CUDA kernels).  The op registers its row with the JAX
package's sizes."""
from repro_torch.core import Traffic
from repro_torch.kernels.common import example_input as _rand
from repro_torch.kernels.decode_attn import ref as _ref
from repro_torch.kernels.decode_attn.ops import decode_attn
from repro_torch.registry.base import KernelSpec, register

__all__ = ["decode_attn"]

_SIZES = {"b": 1, "s": 256, "hq": 4, "hkv": 2, "dh": 64}
_ALIASED = {"b": 1, "s": 512, "hq": 4, "hkv": 2, "dh": 64}


def _inputs(s, dt, dev):
    return (_rand((s["b"], s["hq"], s["dh"]), 0, dt, dev),
            _rand((s["b"], s["s"], s["hkv"], s["dh"]), 1, dt, dev),
            _rand((s["b"], s["s"], s["hkv"], s["dh"]), 2, dt, dev))


register(KernelSpec(
    name="decode_attn", family="decode_attn", fn=decode_attn,
    make_inputs=_inputs,
    run=lambda inp, cfg, mode: decode_attn(inp[0], inp[1], inp[2],
                                           config=cfg, mode=mode),
    ref=lambda inp, cfg: _ref.decode_attn_ref(inp[0], inp[1], inp[2]),
    default_sizes=_SIZES, aliased_sizes=_ALIASED,
    traffic=lambda s, dt: Traffic(rows=s["s"], cols=s["hkv"] * s["dh"],
                                  dtype=dt, read_arrays=2),
    cache_shape=lambda s: (s["b"], s["s"], s["hkv"], s["dh"]),
    bench_sizes={"b": 8, "s": 8192, "hq": 32, "hkv": 8, "dh": 128},
    rtol=2e-5, atol=2e-5, tags=("framework",)))
