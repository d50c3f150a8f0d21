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
from repro.kernels.decode_attn import specs as jdspecs
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
    """The kernels' two-pass structure — per-chunk states (each chunk a
    run of 64-row units across the D segments), then an in-order merge —
    computed by the wrappers' plain versions equals the single sweep of
    the spec, empty (all-masked) chunks included."""
    b, s, hkv, dh, g = 2, 64, 2, 32, 2
    q, k, v = (torch.from_numpy(a) for a in
               _decode_inputs(d, b, s, hkv, dh, g))
    inputs = tdops._flatten(q, k, v) + (
        tdops.validity_mask(torch.tensor(kv), b, s, "cpu"),)
    spec = tdspecs.decode_spec(hkv, dh, True)(*inputs)
    bp = plan_blocks(spec, TConfig(d, 1))
    states = dkernel.split(spec, bp, inputs)
    _, chunks = dkernel.plan_chunks(b, s, d, hkv, g, 132)
    assert [tuple(x.shape) for x in states] == [
        (b, chunks, hkv * g), (b, chunks, hkv * g * dh), (b, chunks, hkv * g)]
    out, lse = dkernel.merge(spec.combine, *states)
    one_out, one_lse = run_spec(tdspecs.decode_spec(hkv, dh, True), inputs,
                                TConfig(d, 1), mode="ref")
    torch.testing.assert_close(out, one_out, rtol=DEC_TOL, atol=DEC_TOL)
    torch.testing.assert_close(lse, one_lse, rtol=DEC_TOL, atol=DEC_TOL)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


# ------------------------------- decode: empty rows, holes, the chunking

def _holes_mask(b, s, seed):
    """A [B, S] f32 validity mask with holes: row 0 valid at random (30%),
    row 1 valid in two 64-row tiles of segment 0 and at the last row
    only, row 2 valid nowhere (a batch row with no valid position)."""
    rng = np.random.default_rng(seed)
    m = np.zeros((b, s), np.float32)
    m[0] = rng.random(s) < 0.3
    m[1, :64] = rng.random(64) < 0.5
    m[1, 128:192] = 1.0
    m[1, s - 1] = 1.0
    return m


@pytest.mark.parametrize("g", [2, 8, 9, 12, 16])
@pytest.mark.parametrize("case", ["kv_len_zero", "holes"])
def test_decode_attn_empty_row_and_holes_match_jax_interpret(g, case):
    """Every dense config's query-head group (2 in the reduced configs;
    8, 9, 12, 16 at full width), dh = 16, D = 4: a batch row with no
    valid position (kv_len 0: the spec's mean of V over all S rows, lse
    = -1e30 + log S) and a mask with holes, the port (its kernels' plain
    versions: chunked split, in-order fold) against the JAX Pallas
    kernel in interpret mode, at the decode row's 2e-5."""
    b, s, hkv, dh = 3, 256, 2, 16
    q, k, v = _decode_inputs(g + 100, b, s, hkv, dh, g)
    cfg = (JConfig(4, 1), TConfig(4, 1))
    if case == "kv_len_zero":
        kv_len = np.array([0, 57, 256], np.int32)
        jo, jl = jdops.decode_attn(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            kv_len=jnp.asarray(kv_len), config=cfg[0], mode="interpret",
            with_lse=True)
        to, tl = tdops.decode_attn(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            kv_len=torch.from_numpy(kv_len), config=cfg[1], with_lse=True)
        to, tl = to.reshape(b, -1), tl
        jo = np.asarray(jo).reshape(b, -1)
        mean_v = v[0].mean(0)                       # [hkv, dh]
        np.testing.assert_allclose(
            to[0].reshape(hkv, g, dh).numpy(),
            np.broadcast_to(mean_v[:, None], (hkv, g, dh)),
            rtol=DEC_TOL, atol=DEC_TOL)
    else:
        mask = _holes_mask(b, s, seed=g)
        targs = tdops._flatten(*(torch.from_numpy(a) for a in (q, k, v)))
        targs += (torch.from_numpy(mask),)
        jargs = tuple(jnp.asarray(a.numpy()) for a in targs)
        jo, jl = jcg.run_spec(jdspecs.decode_spec(hkv, dh, True), jargs,
                              cfg[0], "interpret")
        to, tl = run_spec(tdspecs.decode_spec(hkv, dh, True), targs, cfg[1])
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=DEC_TOL,
                               atol=DEC_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DEC_TOL,
                               atol=DEC_TOL)
    assert np.isfinite(to.numpy()).all() and np.isfinite(tl.numpy()).all()


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_chunked_split_and_fold_match_jax_interpret(d, sms):
    """The kernel's chunking (64-row units u = t·D + k, contiguous runs
    of them per chunk, as many chunks as ``sms`` SMs ask for) through
    ``split_plain`` and ``merge_plain`` equals the JAX Pallas kernel in
    interpret mode at the decode row's 2e-5 (f32 reassociation: other
    partial sums, one fold), with a ragged last tile (S / D = 160 rows:
    two whole units and a 32-row one per segment), the identity state
    for an all-masked chunk of a row with valid positions, and the
    states' rows accounted once."""
    b, s, hkv, dh, g = 3, 640, 2, 16, 4
    q, k, v = _decode_inputs(d * 7 + sms, b, s, hkv, dh, g)
    mask = _holes_mask(b, s, seed=d + sms)
    targs = tdops._flatten(*(torch.from_numpy(a) for a in (q, k, v)))
    targs += (torch.from_numpy(mask),)
    spec = tdspecs.decode_spec(hkv, dh, True)(*targs)
    bp = plan_blocks(spec, TConfig(d, 1))
    upb, chunks = dkernel.plan_chunks(b, s, d, hkv, g, sms)
    units = d * -(-(s // d) // dkernel.TILE)
    assert (chunks - 1) * upb < units <= chunks * upb
    rows = torch.cat([dkernel._chunk_rows(s, d, upb, c)
                      for c in range(chunks)])
    assert sorted(rows.tolist()) == list(range(s))
    pm, pnum, pden = dkernel.split_plain(spec, bp, targs, sms=sms)
    assert tuple(pm.shape) == (b, chunks, hkv * g)
    for c in range(chunks):                # identity: no valid row here
        idx = dkernel._chunk_rows(s, d, upb, c)
        if not (mask[1, idx.numpy()] > 0.5).any():
            assert bool((pm[1, c] == -1e30).all() and (pden[1, c] == 0).all())
    to, tl = dkernel.merge_plain(spec.combine, pm, pnum, pden)
    jo, jl = jcg.run_spec(jdspecs.decode_spec(hkv, dh, True),
                          tuple(jnp.asarray(a.numpy()) for a in targs),
                          JConfig(d, 1), "interpret")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=DEC_TOL,
                               atol=DEC_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=DEC_TOL,
                               atol=DEC_TOL)


def test_group_chunk_is_the_largest_divisor_up_to_16():
    for g in range(1, 70):
        gc = dkernel.group_chunk(g)
        assert g % gc == 0 and gc <= 16
        assert all(g % c for c in range(gc + 1, min(g, 16) + 1))


@pytest.mark.parametrize("b,s,d,hkv,g", [
    (4, 4096, 4, 4, 8), (8, 32768, 4, 4, 8), (1, 256, 1, 2, 2),
    (3, 640, 2, 2, 16), (64, 32768, 8, 8, 4), (2, 100, 4, 1, 9),
    (1, 1 << 20, 1, 1, 1)])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_plan_chunks_covers_the_units_in_bounded_chunks(b, s, d, hkv, g, sms):
    """Chunks cover a batch row's units once, none empty; a chunk holds at
    most MAX_UNITS units; and the blocks make about WAVES a SM where the
    units allow: whole chunks of equal units give at least half the
    chunks that asks for."""
    upb, chunks = dkernel.plan_chunks(b, s, d, hkv, g, sms)
    units = d * -(-(s // d) // dkernel.TILE)
    assert 1 <= chunks <= units
    assert (chunks - 1) * upb < units <= chunks * upb
    assert upb <= dkernel.MAX_UNITS
    pairs = b * hkv * (g // dkernel.group_chunk(g))
    want = min(units, dkernel.WAVES * sms // pairs)
    assert 2 * chunks >= want
