"""The port's rmsnorm and decode_attn against the JAX package, and the
two-pass structure of the decode kernels through their plain versions.

Inputs are drawn once with numpy and the same arrays go to both
packages (JAX through its Pallas kernels in interpret mode and through
its ref mode).  Tolerances are the ``KernelSpec`` ones (rmsnorm 1e-5,
decode_attn 2e-5) unless stated beside the test.  The CUDA kernels
themselves are tested on the card in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codegen as jcg
from repro.core.striding import StridingConfig as JConfig
from repro.kernels.decode_attn import ops as jdops
from repro.kernels.rmsnorm import specs as jrspecs
from repro_torch.codegen import plan_blocks, run_spec
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels import cuda
from repro_torch.kernels.decode_attn import kernel as dkernel
from repro_torch.kernels.decode_attn import ops as tdops
from repro_torch.kernels.decode_attn import ref as tdref
from repro_torch.kernels.decode_attn import specs as tdspecs
from repro_torch.kernels.rmsnorm import kernel as rkernel
from repro_torch.kernels.rmsnorm import ops as trops
from repro_torch.kernels.rmsnorm import ref as trref

RMS_TOL = 1e-5
DEC_TOL = 2e-5
# bf16 outputs: the f32 results of the two packages differ in the last
# bits (summation order), which can flip one bf16 rounding — one ulp,
# at most 2^-7 relative
BF16_RTOL = 2.0 ** -7


def _jdtype(name):
    return jnp.bfloat16 if name == "bfloat16" else jnp.float32


def _tdtype(name):
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------- rmsnorm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jmode", ["interpret", "ref"])
@pytest.mark.parametrize("rows,d", [(16, 4), (12, 2), (5, 1), (8, 8)])
def test_rmsnorm_matches_jax(dtype, jmode, rows, d):
    rng = np.random.default_rng(rows * 10 + d)
    x = rng.standard_normal((rows, 128)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    jx, jw = jnp.asarray(x, _jdtype(dtype)), jnp.asarray(w, _jdtype(dtype))
    jo, jinv = jcg.run_spec(jrspecs.rmsnorm_spec, (jx, jw, 1e-5),
                            JConfig(d, 1), jmode)
    tx = torch.from_numpy(x).to(_tdtype(dtype))
    tw = torch.from_numpy(w).to(_tdtype(dtype))
    to, tinv = trops.rmsnorm(tx, tw, 1e-5, config=TConfig(d, 1),
                             with_inv_rms=True)
    assert to.dtype == tx.dtype and tinv.dtype == torch.float32
    np.testing.assert_allclose(tinv.numpy(), _f32(jinv), rtol=RMS_TOL,
                               atol=RMS_TOL)
    rtol = RMS_TOL if dtype == "float32" else BF16_RTOL
    np.testing.assert_allclose(to.float().numpy(), _f32(jo), rtol=rtol,
                               atol=RMS_TOL)


def test_rmsnorm_batch_dims_and_oracle():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    out, inv = trops.rmsnorm(x, w, 1e-6, with_inv_rms=True)
    ref_out, ref_inv = trref.rmsnorm_stats_ref(x, w, 1e-6)
    assert out.shape == x.shape and inv.shape == (2, 3)
    torch.testing.assert_close(out, ref_out, rtol=RMS_TOL, atol=RMS_TOL)
    torch.testing.assert_close(inv, ref_inv, rtol=RMS_TOL, atol=RMS_TOL)
    torch.testing.assert_close(trops.rmsnorm(x, w, 1e-6),
                               trref.rmsnorm_ref(x, w, 1e-6),
                               rtol=RMS_TOL, atol=RMS_TOL)


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    x, w = torch.randn(8, 64), torch.randn(64)
    spec = trops.specs.rmsnorm_spec(x, w, 1e-5)
    o, r = rkernel.emit(spec, plan_blocks(spec, TConfig(4, 1)),
                        [x, w], [1e-5])
    torch.testing.assert_close(o, trref.rmsnorm_stats_ref(x, w, 1e-5)[0])
    assert {n: k.launches for n, k in cuda.KERNELS.items()} == before
    assert set(cuda.KERNELS) >= {"rmsnorm", "decode_attn",
                                 "decode_attn_merge"}


# ----------------------------------------------------------- decode_attn

def _decode_inputs(seed, b, s, hkv, dh, g):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("masked", [True, False])
def test_decode_attn_matches_jax_interpret(d, g, masked):
    b, s, hkv, dh = 2, 32, 2, 16
    q, k, v = _decode_inputs(d * 10 + g, b, s, hkv, dh, g)
    # row 0 stops in the first segment: at D=4 its other three segments
    # lie wholly past kv_len (all-masked states of weight 0)
    kv_len = np.array([5, 27], np.int32) if masked else None
    jo, jl = jdops.decode_attn(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=None if kv_len is None else jnp.asarray(kv_len),
        config=JConfig(d, 1), mode="interpret", with_lse=True)
    to, tl = tdops.decode_attn(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_len=None if kv_len is None else torch.from_numpy(kv_len),
        config=TConfig(d, 1), with_lse=True)
    assert to.shape == q.shape and tl.shape == (b, hkv * g)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=DEC_TOL,
                               atol=DEC_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DEC_TOL,
                               atol=DEC_TOL)
    ref_out, ref_lse = tdref.decode_attn_lse_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if kv_len is None else torch.from_numpy(kv_len))
    torch.testing.assert_close(to, ref_out, rtol=DEC_TOL, atol=DEC_TOL)
    torch.testing.assert_close(tl, ref_lse, rtol=DEC_TOL, atol=DEC_TOL)


def test_decode_attn_bf16_matches_jax():
    b, s, hkv, dh, g = 2, 32, 2, 16, 2
    q, k, v = _decode_inputs(7, b, s, hkv, dh, g)
    kv_len = np.array([9, 32], np.int32)
    jo = jdops.decode_attn(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                           kv_len=jnp.asarray(kv_len), config=JConfig(4, 1),
                           mode="ref")
    to = tdops.decode_attn(*(torch.from_numpy(a).bfloat16()
                             for a in (q, k, v)),
                           kv_len=torch.from_numpy(kv_len),
                           config=TConfig(4, 1))
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(), _f32(jo), rtol=BF16_RTOL,
                               atol=DEC_TOL)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("kv", [(1, 64), (17, 40), (64, 64)])
def test_split_merge_algebra_equals_one_sweep(d, kv):
    """The kernels' two-pass structure — per-segment states, then an
    in-order merge — computed by the wrappers' plain versions equals the
    single sweep of the spec, empty (all-masked) segments included."""
    b, s, hkv, dh, g = 2, 64, 2, 32, 2
    q, k, v = (torch.from_numpy(a) for a in
               _decode_inputs(d, b, s, hkv, dh, g))
    inputs = tdops._flatten(q, k, v) + (
        tdops.validity_mask(torch.tensor(kv), b, s, "cpu"),)
    spec = tdspecs.decode_spec(hkv, dh, True)(*inputs)
    bp = plan_blocks(spec, TConfig(d, 1))
    states = dkernel.split(spec, bp, inputs)
    assert [tuple(x.shape) for x in states] == [
        (b, d, hkv * g), (b, d, hkv * g * dh), (b, d, hkv * g)]
    out, lse = dkernel.merge(spec.combine, *states)
    one_out, one_lse = run_spec(tdspecs.decode_spec(hkv, dh, True), inputs,
                                TConfig(d, 1), mode="ref")
    torch.testing.assert_close(out, one_out, rtol=DEC_TOL, atol=DEC_TOL)
    torch.testing.assert_close(lse, one_lse, rtol=DEC_TOL, atol=DEC_TOL)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
