"""Codegen variants of the framework kernel families: flash-decode GQA
attention, fused RMSNorm and the fused AdamW step
(``src/repro/kernels/gen/framework.py``).

The spec builders live with their families and are shared verbatim by
the hand-named ops and the ``*_gen`` rows here.

  * ``decode_attn_gen``  — one stride-axis reduction sweep of the
    (flattened) KV cache with the ``OnlineSoftmax`` combinator (K3,
    ``csrc/decode_attn.cu``); ``with_lse=True`` also returns the
    per-(batch, head) f32 log-sum-exp, the kernel's second output.
  * ``rmsnorm_gen``      — ``full_width`` streaming nest (K1,
    ``csrc/rmsnorm.cu``); ``with_inv_rms=True`` also returns the f32
    inverse rms per row.
  * ``adamw_update_gen`` — the flattened parameter §5.1.1-blocked into
    ``[rows, 512]`` tiles, p′/m′/v′ written as three outputs (K1,
    ``csrc/adamw.cu``).

Each resolves one config under its own name (explicit > tuned > planned
> default, with the JAX ops' Traffic) and dispatches through the same
static gate and guard as ``make_kernel_op`` kernels
(``codegen.emit.guarded``).
"""

from repro_torch.codegen import run_spec
from repro_torch.codegen.emit import guarded
from repro_torch.core import Traffic
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import common
from repro_torch.kernels.adamw import ref as _adamw_ref
from repro_torch.kernels.adamw.ops import _blocking as _adamw_blocking
from repro_torch.kernels.adamw.ops import adamw_update
from repro_torch.kernels.adamw.specs import adamw_spec
from repro_torch.kernels.common import example_input as _rand
from repro_torch.kernels.common import placeholder
from repro_torch.kernels.decode_attn import ref as _da_ref
from repro_torch.kernels.decode_attn.specs import decode_spec as _decode_spec
from repro_torch.kernels.rmsnorm import ref as _rms_ref
from repro_torch.kernels.rmsnorm.specs import rmsnorm_spec
from repro_torch.registry.base import KernelSpec, register

__all__ = ["decode_attn_gen", "rmsnorm_gen", "adamw_update_gen",
           # family specs re-exported for spec-level consumers
           "adamw_spec", "rmsnorm_spec"]


# the composites' screened and guarded launches
_decode = guarded("decode_attn_gen")
_rmsnorm = guarded("rmsnorm_gen")
_adamw = guarded("adamw_update_gen")


# --------------------------------------------------------- decode attn

def decode_attn_gen(q, kc, vc, config=None, mode=None, with_lse=False):
    """One-token GQA attention against a [B, S, Hkv, dh] KV cache,
    generated: a single online-softmax stream-reduction sweep of the
    flattened cache.  ``with_lse=True`` also returns the per-(batch,
    head) f32 log-sum-exp."""
    b, hq = q.shape[0], q.shape[1]
    s, hkv, dh = kc.shape[1], kc.shape[2], kc.shape[3]
    traffic = Traffic(rows=s, cols=hkv * dh, dtype=kc.dtype, read_arrays=2)
    cfg = common.resolve_for("decode_attn_gen", kc, config, s,
                             StridingConfig(4, 1), traffic, mode)
    flat = (kc.reshape(b, s, hkv * dh), vc.reshape(b, s, hkv * dh),
            q.reshape(b, hq * dh))
    out, lse = _decode(
        lambda c: run_spec(_decode_spec(hkv, dh), flat, c, mode),
        (kc, vc, q), lambda: (_decode_spec(hkv, dh)(*flat),), cfg, mode, s,
        traffic)
    out = out.reshape(b, hq, dh).to(q.dtype)
    return (out, lse.reshape(b, hq)) if with_lse else out


# ------------------------------------------------------------- rmsnorm

def rmsnorm_gen(x, w, eps=1e-6, config=None, mode=None,
                with_inv_rms=False):
    """Fused RMSNorm, generated.  ``with_inv_rms=True`` also returns the
    f32 inverse rms per row (the kernel's second output)."""
    shape = x.shape
    t = max(x.numel() // max(shape[-1], 1), 1)
    traffic = Traffic(rows=t, cols=shape[-1], dtype=x.dtype,
                      read_arrays=1, write_arrays=1,
                      resident_bytes=shape[-1] * 4)
    cfg = common.resolve_for("rmsnorm_gen", x, config, t,
                             StridingConfig(4, 1), traffic, mode)
    x2 = x.reshape(-1, shape[-1]).contiguous()
    out, inv = _rmsnorm(
        lambda c: run_spec(rmsnorm_spec, (x2, w, eps), c, mode),
        (x, w), lambda: (rmsnorm_spec(x2, w, eps),), cfg, mode, t, traffic)
    out = out.reshape(shape)
    return (out, inv.reshape(shape[:-1])) if with_inv_rms else out


# --------------------------------------------------------------- adamw

def adamw_update_gen(p, g, m, v, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.0,
                     bc1=1.0, bc2=1.0, config=None, mode=None):
    """Fused-AdamW step (generated): the hand op's blocked spec under a
    config resolved as ``adamw_update_gen``.  Returns (p', m', v')."""
    rows, cols = _adamw_blocking(max(p.numel(), 1))
    # rows=None: the emitter's pad and crop make any D valid
    traffic = Traffic(rows=rows, cols=cols, dtype=p.dtype,
                      read_arrays=4, write_arrays=3)
    cfg = common.resolve_for("adamw_update_gen", p, config, None,
                             StridingConfig(2, 2), traffic, mode)
    return _adamw(
        lambda c: adamw_update(p, g, m, v, lr, b1, b2, eps, wd, bc1, bc2,
                               config=c, mode=mode),
        (p, g, m, v), lambda: (adamw_spec(
            *(placeholder((rows, cols), t.dtype) for t in (p, g, m, v))),),
        cfg, mode, None, traffic)


# ---------------------------------------------------------- registry

_DA_SIZES = {"b": 1, "s": 256, "hq": 4, "hkv": 2, "dh": 64}
_DA_ALIASED = {"b": 1, "s": 512, "hq": 4, "hkv": 2, "dh": 64}


def _da_inputs(s, dt, dev):
    return (_rand((s["b"], s["hq"], s["dh"]), 0, dt, dev),
            _rand((s["b"], s["s"], s["hkv"], s["dh"]), 1, dt, dev),
            _rand((s["b"], s["s"], s["hkv"], s["dh"]), 2, dt, dev))


register(KernelSpec(
    name="decode_attn_gen", family="gen", fn=decode_attn_gen,
    make_inputs=_da_inputs,
    # the lse row statistic rides the conformance matrix
    run=lambda inp, cfg, mode: decode_attn_gen(inp[0], inp[1], inp[2],
                                               config=cfg, mode=mode,
                                               with_lse=True),
    ref=lambda inp, cfg: _da_ref.decode_attn_lse_ref(inp[0], inp[1],
                                                     inp[2]),
    default_sizes=_DA_SIZES, aliased_sizes=_DA_ALIASED,
    traffic=lambda s, dt: Traffic(rows=s["s"], cols=s["hkv"] * s["dh"],
                                  dtype=dt, read_arrays=2),
    # decode_spec is a per-(Hkv, dh) builder factory: apply it to the
    # flattened-cache placeholders the wrapper reshapes to
    traversal=lambda s, dt: _decode_spec(s["hkv"], s["dh"])(
        placeholder((s["b"], s["s"], s["hkv"] * s["dh"]), dt),
        placeholder((s["b"], s["s"], s["hkv"] * s["dh"]), dt),
        placeholder((s["b"], s["hq"] * s["dh"]), dt)),
    cache_shape=lambda s: (s["b"], s["s"], s["hkv"], s["dh"]),
    bench_sizes={"b": 8, "s": 8192, "hq": 32, "hkv": 8, "dh": 128},
    rtol=2e-5, atol=2e-5, tags=("framework", "gen")))

register(KernelSpec(
    name="rmsnorm_gen", family="gen", fn=rmsnorm_gen,
    make_inputs=lambda s, dt, dev: (_rand((s["t"], s["dm"]), 0, dt, dev),
                                    _rand((s["dm"],), 1, dt, dev)),
    run=lambda inp, cfg, mode: rmsnorm_gen(inp[0], inp[1], config=cfg,
                                           mode=mode, with_inv_rms=True),
    ref=lambda inp, cfg: _rms_ref.rmsnorm_stats_ref(inp[0], inp[1]),
    default_sizes={"t": 32, "dm": 256}, aliased_sizes={"t": 32, "dm": 128},
    traffic=lambda s, dt: Traffic(rows=s["t"], cols=s["dm"], dtype=dt,
                                  read_arrays=1, write_arrays=1,
                                  resident_bytes=s["dm"] * 4),
    traversal=lambda s, dt: rmsnorm_spec(placeholder((s["t"], s["dm"]), dt),
                                         placeholder((s["dm"],), dt)),
    cache_shape=lambda s: (s["t"], s["dm"]),
    bench_sizes={"t": 4096, "dm": 4096},
    rtol=1e-5, atol=1e-5, tags=("framework", "gen")))

_ADAMW_HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, wd=0.01,
                    bc1=0.5, bc2=0.25)


def _adamw_inputs(s, dt, dev):
    shape = (s["rows"], s["cols"])
    return (_rand(shape, 0, dt, dev), _rand(shape, 1, dt, dev),
            _rand(shape, 2, dt, dev), _rand(shape, 3, device=dev).abs())


register(KernelSpec(
    name="adamw_update_gen", family="gen", fn=adamw_update_gen,
    make_inputs=_adamw_inputs,
    run=lambda inp, cfg, mode: adamw_update_gen(*inp, config=cfg,
                                                mode=mode, **_ADAMW_HYPER),
    ref=lambda inp, cfg: _adamw_ref.adamw_ref(*inp, **_ADAMW_HYPER),
    default_sizes={"rows": 60, "cols": 100},
    aliased_sizes={"rows": 128, "cols": 128},
    # 4 read + 3 write arrays per stride at the nominal 1-D blocking
    traffic=lambda s, dt: Traffic(
        rows=max(s["rows"] * s["cols"] // 1024, 4), cols=1024, dtype=dt,
        read_arrays=4, write_arrays=3),
    # the spec the wrapper lowers: the flattened tensor at its §5.1.1
    # re-blocked [rows, 512] shape
    traversal=lambda s, dt: adamw_spec(
        *(placeholder(_adamw_blocking(max(s["rows"] * s["cols"], 1)), dt)
          for _ in range(4))),
    cache_shape=lambda s: (s["rows"], s["cols"]),
    bench_sizes={"rows": 4096, "cols": 1024},
    rtol=1e-5, atol=1e-6, tags=("framework", "gen")))
