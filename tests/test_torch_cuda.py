"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(decided in the ``cuda_device`` fixture, never at import).  This file
imports no JAX, so it also runs on a card host without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.codegen import OnlineSoftmax, run_spec
from repro_torch.codegen import template_of as tcg_template
from repro_torch import registry as tregistry
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels import cuda
from repro_torch.kernels import stencil as tstencil
from repro_torch.kernels.adamw import _HYPER
from repro_torch.kernels.adamw import kernel as akernel
from repro_torch.kernels.adamw import ops as taops
from repro_torch.kernels.adamw import specs as taspecs
from repro_torch.kernels.bicg import ops as tbops
from repro_torch.kernels.conv3x3 import ops as tcops
from repro_torch.kernels.conv3x3 import specs as tcspecs
from repro_torch.kernels.decode_attn import kernel as dkernel
from repro_torch.kernels.decode_attn import ops as tdops
from repro_torch.kernels.doitgen import kernel as dgkernel
from repro_torch.kernels.doitgen import ops as tdgops
from repro_torch.kernels.doitgen import specs as tdgspecs
from repro_torch.kernels import gen as tgen
from repro_torch.kernels.gen import kernel as genkernel
from repro_torch.kernels.gemver import kernel as gkernel
from repro_torch.kernels.gemver import ops as tgops
from repro_torch.kernels.gemver import specs as tgspecs
from repro_torch.kernels.jacobi2d import ops as tjops
from repro_torch.kernels.jacobi2d import specs as tjspecs
from repro_torch.kernels import manual as tmanual
from repro_torch.kernels.mxv import kernel as mkernel
from repro_torch.kernels.mxv import ops as tmops
from repro_torch.kernels.rmsnorm import kernel as rkernel
from repro_torch.kernels.rmsnorm import ops as trops
from repro_torch.kernels.stream import kernel as skernel
from repro_torch.kernels.stream import ops as tsops
from repro_torch.kernels.stream import specs as tsspecs

RMS_TOL = 1e-5
# bf16 outputs: a reassociated f32 row sum can flip one bf16 rounding —
# one ulp, at most 2^-7 relative
BF16_RTOL = 2.0 ** -7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,d", [(4, 4), (96, 4), (6, 3), (64, 8), (32, 16)])
def test_rmsnorm_kernel_matches_plain(cuda_device, dtype, t, d):
    gen = torch.Generator(device=cuda_device).manual_seed(t * d)
    x = torch.randn(t, 4096, generator=gen, device=cuda_device).to(dtype)
    w = (1 + 0.1 * torch.randn(4096, generator=gen,
                               device=cuda_device)).to(dtype)
    n = rkernel.RMSNORM.launches
    o, r = trops.rmsnorm(x, w, 1e-5, config=TConfig(d, 1),
                         with_inv_rms=True)
    assert rkernel.RMSNORM.launches == n + 1
    ro, rr = trops.rmsnorm(x, w, 1e-5, config=TConfig(d, 1), mode="ref",
                           with_inv_rms=True)
    assert rkernel.RMSNORM.launches == n + 1
    rtol = BF16_RTOL if dtype == torch.bfloat16 else RMS_TOL
    torch.testing.assert_close(o.float(), ro.float(), rtol=rtol,
                               atol=RMS_TOL)
    torch.testing.assert_close(r, rr, rtol=RMS_TOL, atol=RMS_TOL)


# one ulp of the output type, relative (a reassociated f32 row sum can
# flip one rounding)
RMS_OUT_RTOL = {torch.bfloat16: BF16_RTOL, torch.float16: 2.0 ** -10,
                torch.float32: RMS_TOL}


def _rms_matches_plain(dev, dtype, t, dm, d):
    gen = torch.Generator(device=dev).manual_seed(t + dm + d)
    x = torch.randn(t, dm, generator=gen, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(dm, generator=gen, device=dev)).to(dtype)
    cfg = TConfig(d, 1)
    n = rkernel.RMSNORM.launches
    o, r = trops.rmsnorm(x, w, 1e-5, config=cfg, with_inv_rms=True)
    assert rkernel.RMSNORM.launches == n + 1
    ro, rr = trops.rmsnorm(x, w, 1e-5, config=cfg, mode="ref",
                           with_inv_rms=True)
    torch.testing.assert_close(o.float(), ro.float(),
                               rtol=RMS_OUT_RTOL[dtype], atol=RMS_TOL)
    torch.testing.assert_close(r, rr, rtol=RMS_TOL, atol=0.0)
    o2, r2 = trops.rmsnorm(x, w, 1e-5, config=cfg, with_inv_rms=True)
    assert torch.equal(r2, r) and torch.equal(o2, o)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("t", [1, 2, 4, 8, 96, 8192])
@pytest.mark.parametrize("dm", [128, 1000, 4096, 8192])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_rmsnorm_geometries_match_plain(cuda_device, dtype, t, dm, d):
    """Every geometry of the kernel at rows that fit a block (1-8 vectors
    of a row a thread, one item a block at few rows, runs of two at 8192
    rows) against the plain version: o within one ulp, r within 1e-5;
    both bit-equal from one run to the next."""
    _rms_matches_plain(cuda_device, dtype, t, dm, d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(1, 1), (4, 4), (96, 4), (512, 2)])
@pytest.mark.parametrize("dm", [12288, 16384, 32768, 65536])
def test_rmsnorm_cluster_rows_match_plain(cuda_device, dtype, t, d, dm):
    """Rows at and over one block's registers (32 KB): one block, and
    clusters of 2, 4 and 8 blocks (the partial sums pushed to every rank,
    added in rank order), as above."""
    _rms_matches_plain(cuda_device, dtype, t, dm, d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("t,dm", [(8, 1001), (3, 4098), (96, 1001),
                                  (4, 12289), (8192, 1001)])
def test_rmsnorm_rows_of_odd_vectors_match_plain(cuda_device, dtype, t, dm):
    """Rows that are not a whole number of 16-byte vectors run the
    narrower-lane instances (8, 4 or 2 bytes a vector; 12289 f32 over a
    cluster), as above; a lost-element control (one element of row 1
    zeroed) lies outside the limit."""
    _rms_matches_plain(cuda_device, dtype, t, dm, 1 if t == 3 else 4)
    gen = torch.Generator(device=cuda_device).manual_seed(dm)
    x = torch.randn(t, dm, generator=gen, device=cuda_device).to(dtype)
    w = torch.ones(dm, device=cuda_device, dtype=dtype)
    o = trops.rmsnorm(x, w, 1e-5)
    lost = x.clone()
    lost[1, int(x[1].float().abs().argmax())] = 0
    lo = trops.rmsnorm(lost, w, 1e-5, mode="ref")
    assert not torch.allclose(lo.float(), o.float(),
                              rtol=RMS_OUT_RTOL[dtype], atol=RMS_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [1, 4, 16])
@pytest.mark.parametrize("g,dh", [(8, 128), (2, 64), (1, 32), (2, 16)])
@pytest.mark.parametrize("masked", [True, False])
def test_decode_kernel_matches_plain(cuda_device, dtype, d, g, dh, masked):
    b, s, hkv = 3, 1024, 4
    gen = torch.Generator(device=cuda_device).manual_seed(d * g)
    q = torch.randn(b, hkv * g, dh, generator=gen, device=cuda_device)
    k = torch.randn(b, s, hkv, dh, generator=gen, device=cuda_device)
    v = torch.randn(b, s, hkv, dh, generator=gen, device=cuda_device)
    q, k, v = (a.to(dtype) for a in (q, k, v))
    kv_len = (torch.tensor([1, 300, 1024], device=cuda_device) if masked
              else None)
    n = (dkernel.SPLIT.launches, dkernel.MERGE.launches)
    out, lse = tdops.decode_attn(q, k, v, kv_len=kv_len,
                                 config=TConfig(d, 1), with_lse=True)
    assert (dkernel.SPLIT.launches, dkernel.MERGE.launches) == (
        n[0] + 1, n[1] + 1)
    ro, rl = tdops.decode_attn(q, k, v, kv_len=kv_len, config=TConfig(d, 1),
                               mode="ref", with_lse=True)
    # f32 reassociation: the kernel folds 64-row tiles and merges chunk
    # states; the plain version sums whole rows
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ro.float(), rtol=rtol, atol=1e-4)
    torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)


def _decode_case(dev, dtype, b, s, hkv, g, dh, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, hkv * g, dh, generator=gen, device=dev)
    k = torch.randn(b, s, hkv, dh, generator=gen, device=dev)
    v = torch.randn(b, s, hkv, dh, generator=gen, device=dev)
    return tuple(a.to(dtype) for a in (q, k, v))


def _holes(dev, b, s, seed):
    """Row 0 valid at random, row 1 in two tiles and the last row, the
    last row valid nowhere (the spec's mean of V), as a [B, S] mask."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = torch.zeros(b, s, device=dev)
    m[0] = (torch.rand(s, generator=gen, device=dev) < 0.3).float()
    m[1, :64] = (torch.rand(64, generator=gen, device=dev) < 0.5).float()
    m[1, 128:192] = 1.0
    m[1, s - 1] = 1.0
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,dh", [(8, 128), (16, 128), (9, 128), (2, 64),
                                  (12, 64), (1, 32), (2, 16)])
@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("case", ["kv_len_zero", "holes"])
def test_decode_kernel_empty_row_and_holes_match_plain(cuda_device, dtype,
                                                       g, dh, d, case):
    """A batch row with no valid position (the spec's mean of V over all
    S rows, lse = -1e30 + log S) and a mask with holes, split then
    merge against the plain version on the card, at the decode
    tolerance; the states of the split equal its plain version's where a
    chunk is all masked."""
    b, s, hkv = 3, 1024, 2
    q, k, v = _decode_case(cuda_device, dtype, b, s, hkv, g, dh, g * dh + d)
    if case == "kv_len_zero":
        mask = tdops.validity_mask(torch.tensor([0, 300, 1024],
                                                device=cuda_device),
                                   b, s, cuda_device)
    else:
        mask = _holes(cuda_device, b, s, g + d)
    inputs = tdops._flatten(q, k, v) + (mask,)
    from repro_torch.codegen import plan_blocks
    from repro_torch.kernels.decode_attn import specs as tdspecs
    spec = tdspecs.decode_spec(hkv, dh, True)(*inputs)
    bp = plan_blocks(spec, TConfig(d, 1))
    n = (dkernel.SPLIT.launches, dkernel.MERGE.launches)
    states = dkernel.split(spec, bp, inputs)
    mo, ml = dkernel.merge(spec.combine, *states)
    assert (dkernel.SPLIT.launches, dkernel.MERGE.launches) == (
        n[0] + 1, n[1] + 1)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plain = dkernel.split_plain(spec, bp, inputs, sms=sms)
    ro, rl = dkernel.merge_plain(spec.combine, *plain)
    torch.testing.assert_close(mo, ro, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ml, rl, rtol=1e-4, atol=1e-4)
    idle = plain[0] == -1e30                 # identity or empty-row chunks
    assert torch.equal(states[0][idle], plain[0][idle])
    torch.testing.assert_close(states[2], plain[2], rtol=1e-4, atol=1e-4)
    empty = mask.sum(1) == 0
    if bool(empty.any()):                    # the mean of V, every head
        mean_v = v.float().mean(1)[empty]    # [rows, hkv, dh]
        got = mo.reshape(b, hkv, g, dh)[empty]
        torch.testing.assert_close(
            got, mean_v[:, :, None].expand_as(got), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_bits_repeat(cuda_device, dtype):
    """Two runs on the same inputs give the same bits: the fold takes
    the chunks in a fixed order, and no atomic touches a value."""
    b, s, hkv, g, dh = 4, 4096, 4, 8, 128
    q, k, v = _decode_case(cuda_device, dtype, b, s, hkv, g, dh, 11)
    kv_len = torch.tensor([17, 2000, 4096, 0], device=cuda_device)
    runs = [tdops.decode_attn(q, k, v, kv_len=kv_len, config=TConfig(4, 1),
                              with_lse=True) for _ in range(3)]
    for out, lse in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])


@pytest.mark.gpu
def test_decode_merge_kernel_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, d, hq, dh = 3, 8, 16, 64
    pm = torch.randn(b, d, hq, generator=gen, device=cuda_device)
    pm[0, 1:] = -1e30                       # empty segments of row 0
    pnum = torch.randn(b, d, hq * dh, generator=gen, device=cuda_device)
    pden = torch.rand(b, d, hq, generator=gen, device=cuda_device) + 0.5
    comb = OnlineSoftmax(groups=hq, vwidth=dh, with_lse=True)
    out, lse = dkernel.merge(comb, pm, pnum, pden)
    ro, rl = dkernel.merge_plain(comb, pm, pnum, pden)
    torch.testing.assert_close(out, ro, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda_device):
    x = torch.randn(8, 4096, device=cuda_device).bfloat16()
    w = torch.ones(4096, device=cuda_device)          # wrong dtype
    with pytest.raises(TypeError):
        trops.rmsnorm(x, w.float().to(torch.float16), 1e-5)
    q = torch.randn(2, 4, 40, device=cuda_device)     # dh=40 not compiled
    k = torch.randn(2, 64, 2, 40, device=cuda_device)
    with pytest.raises(NotImplementedError):
        tdops.decode_attn(q, k, k, kv_len=torch.tensor([3, 9]))


@pytest.mark.gpu
def test_launcher_serves_on_the_card(cuda_device, capsys):
    from repro_torch.launch import serve
    n = (rkernel.RMSNORM.launches, dkernel.SPLIT.launches)
    results = serve.main(["--device", str(cuda_device), "--requests", "3"])
    assert sorted(results) == [0, 1, 2]
    assert all(len(toks) == 16 for toks in results.values())
    assert rkernel.RMSNORM.launches > n[0] and dkernel.SPLIT.launches > n[1]
    assert "req 2: 16 tokens" in capsys.readouterr().out


@pytest.mark.gpu
def test_launcher_trains_on_the_card(cuda_device, tmp_path, capsys):
    """The train launcher on the card (reduced yi-9b): each step runs
    rmsnorm 4L + 1 times (remat recomputes the layers' norms) and the K1
    adamw kernel once per parameter tensor."""
    from repro_torch.launch import train
    before = (rkernel.RMSNORM.launches, akernel.ADAMW.launches)
    state = train.main(["--device", str(cuda_device), "--steps", "2",
                        "--batch", "2", "--seq", "16", "--log-every", "1",
                        "--ckpt-dir", str(tmp_path)])
    n_layers, n_tensors = 2, len(list(state["params"].parameters()))
    assert rkernel.RMSNORM.launches - before[0] == 2 * (4 * n_layers + 1)
    assert akernel.ADAMW.launches - before[1] == 2 * n_tensors
    assert all(p.is_cuda and torch.isfinite(p).all()
               for p in state["params"].parameters())
    assert "done; checkpoints: [2]" in capsys.readouterr().out


# ------------------------------------------- decode: every dense group

def test_decode_kernel_admits_every_dense_config():
    """The repaired fault, checked where there is no card: the split
    kernel's admission rule takes the query-head group and head dim of
    every dense config, at full width and reduced."""
    dense = [get_config(a) for a in ARCHS if get_config(a).family == "dense"]
    assert {c.n_heads // c.n_kv_heads for c in dense} >= {8, 9, 12, 16}
    for cfg in dense + [reduced(c) for c in dense]:
        g = cfg.n_heads // cfg.n_kv_heads
        assert dkernel.admits(g, cfg.head_dim), cfg.name
    assert not dkernel.admits(8, 40) and not dkernel.admits(0, 128)
    assert not dkernel.admits(8, 72) and not dkernel.admits(8, 144)
    assert all(dkernel.admits(8, dh) for dh in range(16, 129, 16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [9, 12, 16])
@pytest.mark.parametrize("dh", [128, 64])
def test_decode_kernel_matches_plain_at_every_dense_group(cuda_device,
                                                         dtype, g, dh):
    b, s, hkv = 2, 2048, 2
    gen = torch.Generator(device=cuda_device).manual_seed(g * dh)
    q = torch.randn(b, hkv * g, dh, generator=gen, device=cuda_device)
    k = torch.randn(b, s, hkv, dh, generator=gen, device=cuda_device)
    v = torch.randn(b, s, hkv, dh, generator=gen, device=cuda_device)
    q, k, v = (a.to(dtype) for a in (q, k, v))
    kv_len = torch.tensor([700, 2048], device=cuda_device)
    n = dkernel.SPLIT.launches
    out, lse = tdops.decode_attn(q, k, v, kv_len=kv_len,
                                 config=TConfig(4, 1), with_lse=True)
    assert dkernel.SPLIT.launches == n + 1
    ro, rl = tdops.decode_attn(q, k, v, kv_len=kv_len, config=TConfig(4, 1),
                               mode="ref", with_lse=True)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ro.float(), rtol=rtol, atol=1e-4)
    torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [2, 16])
@pytest.mark.parametrize("dh", [48, 80, 96, 112])
def test_decode_kernel_matches_plain_at_head_dims_48_to_112(cuda_device,
                                                           dtype, g, dh):
    """The head dims whose rows are not a power of two of 16-element
    pieces (K in 32- or 64-byte swizzled TMA boxes, P V lanes left idle
    where dh / 4 does not divide a warp), at kv_len 17-64 and S = 4096,
    against the plain version; a lost-segment control lies outside the
    limit."""
    b, hkv = 4, 2
    for s, kv in ((64, [17, 40, 64, 33]), (4096, [700, 4096, 1, 2500])):
        gen = torch.Generator(device=cuda_device).manual_seed(g * dh + s)
        q, k, v = (torch.randn(*shape, generator=gen, device=cuda_device)
                   .to(dtype) for shape in ((b, hkv * g, dh),
                                            (b, s, hkv, dh), (b, s, hkv, dh)))
        kv_len = torch.tensor(kv, device=cuda_device)
        n = dkernel.SPLIT.launches
        out, lse = tdops.decode_attn(q, k, v, kv_len=kv_len,
                                     config=TConfig(4, 1), with_lse=True)
        assert dkernel.SPLIT.launches == n + 1
        ro, rl = tdops.decode_attn(q, k, v, kv_len=kv_len,
                                   config=TConfig(4, 1), mode="ref",
                                   with_lse=True)
        rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(out.float(), ro.float(), rtol=rtol,
                                   atol=1e-4)
        torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)
        lost = v.clone()
        lost[:, : s // 4] = 0                       # segment 0 lost
        lo = tdops.decode_attn(q, k, lost, kv_len=kv_len,
                               config=TConfig(4, 1), mode="ref")
        assert not torch.allclose(lo.float(), ro.float(), rtol=rtol,
                                  atol=1e-4)


# ----------------------------------------------- mxv / bicg / gemver

GAMMA = 2.0 ** -24


def _dot_factor(n):
    """c in |computed - exact| <= c 2^-24 Σ|a x| for an f32 dot of
    length n: worst case n; 8 sqrt(n) for independent mean-zero
    roundings (Higham and Mary 2019, Thm 3.1; fails with probability at
    most 2 n exp(-32) per dot).  The smaller of the two."""
    return min(float(n), 8.0 * n ** 0.5)


def _assert_dot(got, ref, bound_terms, n):
    """|got - ref| <= 2 c 2^-24 Σ|a x| per element, c = _dot_factor(n)
    (each of the two f32 sums lies within c 2^-24 Σ|a x| of the exact
    one), plus the last rounding into the output's dtype on each side
    (unit roundoff u: 2^-8 in bf16, 2^-11 in f16, 2^-24 in f32)."""
    u = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}.get(
        got.dtype, GAMMA)
    limit = 2 * _dot_factor(n) * GAMMA * bound_terms + 2 * u * ref.float().abs()
    d = (got.float() - ref.float()).abs()
    assert bool((d <= limit).all()), float((d - limit).max())


def _rand(gen, shape, dev, dtype):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


DPS = [(d, p) for d in (1, 2, 4, 8) for p in (1, 2)]
# the second is ragged; then 5 sub-portions of 128 on 64 rows (an odd
# last sub-portion in 16-bit types, rows too few for a wave), a row that
# the row-dot cuts into parts, 129 sub-portions (x over 64 KiB in f32),
# and 257 (x over 64 KiB in 16-bit types)
LINALG_SHAPES = [(512, 1024), (200, 1000), (64, 640), (1024, 16384),
                 (96, 16512), (64, 32896)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", DPS)
@pytest.mark.parametrize("m,n", LINALG_SHAPES)
def test_mxv_kernels_match_plain(cuda_device, dtype, arr, d, p, m, n):
    gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + p)
    a = _rand(gen, (m, n), cuda_device, dtype)
    x, xt = (_rand(gen, (n,), cuda_device, dtype),
             _rand(gen, (m,), cuda_device, dtype))
    cfg = TConfig(d, p, arrangement=arr)
    counts = (mkernel.ROWDOT.launches, mkernel.COLDOT.launches,
              sum(k.launches for k in cuda.KERNELS.values()))
    y, yt = tmops.mxv(a, x, config=cfg), tmops.mxv_t(a, xt, config=cfg)
    # one launch each: the column-dot folds its partial rows in its own
    # launch (a cluster's distributed shared memory), no merge pass
    assert (mkernel.ROWDOT.launches, mkernel.COLDOT.launches,
            sum(k.launches for k in cuda.KERNELS.values())) == (
                counts[0] + 1, counts[1] + 1, counts[2] + 2)
    ry = tmops.mxv(a, x, config=cfg, mode="ref")
    ryt = tmops.mxv_t(a, xt, config=cfg, mode="ref")
    assert y.dtype == yt.dtype == dtype
    _assert_dot(y, ry, (a.float().abs() * x.float().abs()).sum(-1), n)
    _assert_dot(yt, ryt, (xt.float().abs()[:, None]
                          * a.float().abs()).sum(0), m)
    q, s = tbops.bicg(a, xt, x, config=cfg)
    torch.testing.assert_close(q, y, rtol=0, atol=0)
    torch.testing.assert_close(s, yt, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,p", [(4, 2), (8, 1), (1, 2), (2, 1)])
def test_arrangements_give_the_same_bits(cuda_device, dtype, d, p):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    a = _rand(gen, (1024, 2048), cuda_device, dtype)
    x = _rand(gen, (2048,), cuda_device, dtype)
    u1, u2 = (_rand(gen, (1024,), cuda_device, dtype) for _ in range(2))
    v1, v2 = (_rand(gen, (2048,), cuda_device, dtype) for _ in range(2))
    out = {}
    for arr in ("grouped", "interleaved"):
        cfg = TConfig(d, p, arrangement=arr)
        out[arr] = (tmops.mxv(a, x, config=cfg),
                    tgops.gemver_outer(a, u1, v1, u2, v2, config=cfg))
    for g, i in zip(out["grouped"], out["interleaved"]):
        assert torch.equal(g, i)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", DPS)
@pytest.mark.parametrize("m,n", LINALG_SHAPES)
def test_gemver_kernels_match_plain(cuda_device, dtype, arr, d, p, m, n):
    """The elementwise steps round each operation as the body does, so
    kernel and plain version agree bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + p + 1)
    a = _rand(gen, (m, n), cuda_device, dtype)
    u1, u2 = (_rand(gen, (m,), cuda_device, dtype) for _ in range(2))
    v1, v2 = (_rand(gen, (n,), cuda_device, dtype) for _ in range(2))
    x, z = (_rand(gen, (m * n + 77,), cuda_device, dtype) for _ in range(2))
    cfg = TConfig(d, p, arrangement=arr)
    counts = (gkernel.OUTER.launches, gkernel.SUM.launches)
    o = tgops.gemver_outer(a, u1, v1, u2, v2, config=cfg)
    s = tgops.gemver_sum(x, z, config=cfg)
    assert (gkernel.OUTER.launches, gkernel.SUM.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert torch.equal(o, tgops.gemver_outer(a, u1, v1, u2, v2, config=cfg,
                                             mode="ref"))
    assert torch.equal(s, tgops.gemver_sum(x, z, config=cfg, mode="ref"))


def _last_launch(source: str, symbol: str) -> list:
    """The last launch's (instance, grid) record of a kernel library."""
    import ctypes
    fn = getattr(cuda.library(source), symbol)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    out = (ctypes.c_int * 3)()
    fn(out)
    return list(out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("m,n", [(4096, 4096), (200, 1000), (64, 640),
                                 (1024, 16384), (96, 16512), (64, 32896)])
def test_rowdot_and_outer_launch_the_instance_their_geometry_picks(
        cuda_device, dtype, d, m, n):
    """Each wrapper launches once, the instance (streams a group, x in
    shared memory) and grid that rowdot_geometry / outer_geometry give
    for the padded operands."""
    from repro_torch.codegen import plan_blocks
    from repro_torch.kernels import common as tcommon
    from repro_torch.kernels.mxv import specs as tmspecs
    gen = torch.Generator(device=cuda_device).manual_seed(m + n + d)
    a = _rand(gen, (m, n), cuda_device, dtype)
    x = _rand(gen, (n,), cuda_device, dtype)
    u1, u2 = (_rand(gen, (m,), cuda_device, dtype) for _ in range(2))
    v1, v2 = (_rand(gen, (n,), cuda_device, dtype) for _ in range(2))
    cfg = TConfig(d, 2)
    # the ops take D as effective_config clamps it (to divide the rows)
    bp = plan_blocks(tmspecs.mxv_spec(a, x),
                     tcommon.effective_config(cfg, m, cfg))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    isz = a.element_size()
    rg = mkernel.rowdot_geometry(bp.rows, bp.cols, isz, bp.d, sms)
    og = gkernel.outer_geometry(bp.rows, bp.cols, isz, bp.d, sms)
    before = (mkernel.ROWDOT.launches, gkernel.OUTER.launches)
    tmops.mxv(a, x, config=cfg)
    assert _last_launch("reduction", "rowdot_last_launch") == [
        rg.streams, int(rg.smem > 0), rg.blocks]
    tgops.gemver_outer(a, u1, v1, u2, v2, config=cfg)
    assert _last_launch("gemver", "gemver_outer_last_launch") == [
        og.streams, og.tiles, og.runs]
    assert (mkernel.ROWDOT.launches, gkernel.OUTER.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", [(1, 2), (3, 1), (8, 2), (16, 1), (4, 3),
                                 (2, 5)])
@pytest.mark.parametrize("n", [1, 300, 2 * 256 * 4 + 77, 3 * 2 ** 16 + 5])
def test_gemver_sum_short_segments_match_plain(cuda_device, dtype, arr, d,
                                               p, n):
    """gemver_sum where the steps do not fill the segments: one element,
    segments of one tile row (n = 300 at D = 8), a step cut short at
    every segment's end, P = 3 (a thread's units one short of a pass),
    P = 5 (two passes, the second of one unit) and D = 16 (16 blocks a
    step), bit for bit and in one launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + d * 10 + p)
    x, z = (_rand(gen, (n,), cuda_device, dtype) for _ in range(2))
    cfg = TConfig(d, p, arrangement=arr)
    before = gkernel.SUM.launches
    s = tgops.gemver_sum(x, z, config=cfg)
    assert gkernel.SUM.launches == before + 1
    assert s.dtype == dtype and s.shape == (n,)
    assert torch.equal(s, tgops.gemver_sum(x, z, config=cfg, mode="ref"))


@pytest.mark.gpu
def test_one_gemver_call_launches_each_kernel_once(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    m, n = 1024, 2048
    a = _rand(gen, (m, n), cuda_device, torch.float32)
    u1, u2, y = (_rand(gen, (m,), cuda_device, torch.float32)
                 for _ in range(3))
    v1, v2, z = (_rand(gen, (n,), cuda_device, torch.float32)
                 for _ in range(3))
    kernels = (gkernel.OUTER, mkernel.COLDOT, gkernel.SUM, mkernel.ROWDOT)
    before = [k.launches for k in kernels]
    total = sum(k.launches for k in cuda.KERNELS.values())
    a_hat, x, w = tgops.gemver(a, u1, v1, u2, v2, y, z, 1.5, 1.2)
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    # four kernels, one launch each (the column-dot has no merge pass)
    assert sum(k.launches for k in cuda.KERNELS.values()) == total + 4
    ra, rx, rw = tgops.gemver(a, u1, v1, u2, v2, y, z, 1.5, 1.2, mode="ref")
    assert torch.equal(a_hat, ra)
    # x = 0 + 1.2 Aᵀy + z: the sum's bound plus the roundings of the
    # scaling and the add
    limit = (2 * _dot_factor(m) * GAMMA * 1.2
             * (y.abs()[:, None] * ra.abs()).sum(0)
             + 4 * GAMMA * (rx.abs() + z.abs()))
    assert bool(((x - rx).abs() <= limit).all())
    # w = 1.5 A x, held against the plain step on the kernels' own x
    rw_x = tgops.gemver_mxv2(ra, x, 1.5, mode="ref")
    _assert_dot(w, rw_x, 1.5 * (ra.abs() * x.abs()).sum(-1), n)


@pytest.mark.gpu
def test_linalg_wrappers_raise_on_what_they_do_not_take(cuda_device):
    a = torch.randn(64, 256, device=cuda_device)
    x = torch.randn(256, device=cuda_device)
    with pytest.raises(TypeError):                    # f64 not compiled
        tmops.mxv(a.double(), x.double())
    with pytest.raises(TypeError):                    # mixed dtypes
        tmops.mxv(a, x.bfloat16())
    with pytest.raises(TypeError):
        tmops.mxv_t(a, torch.randn(64, device=cuda_device).bfloat16())
    with pytest.raises(ValueError):                   # not contiguous
        tmops.mxv_t(torch.randn(256, 512, device=cuda_device)[:, ::2],
                    torch.randn(256, device=cuda_device))
    with pytest.raises(ValueError):                   # K4 ring too large
        tgops.gemver_sum(x, x, config=TConfig(16, 1, lookahead=64))
    with pytest.raises(NotImplementedError):          # no kernel by that name
        run_spec(lambda *t: dataclasses.replace(
            tgspecs.gemver_mxv2_spec(*t), name="unported"), (a, x, 1.5),
            TConfig(4, 2))
    with pytest.raises(ValueError):                   # stride axis unpadded
        run_spec(tmops.specs.mxv_t_spec, (a[:63], x[:63]), TConfig(4, 2))


# ------------------------------------------- stream family and the K4 ring

STREAM_SHAPES = [(512, 1024), (200, 1000)]     # the second is ragged
ALPHA = 1.5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", DPS)
@pytest.mark.parametrize("m,n", STREAM_SHAPES)
def test_stream_kernels_match_plain(cuda_device, dtype, arr, d, p, m, n):
    """K1 copy, triad and init equal their plain versions bit for bit;
    the K2 read's two passes agree within the f32 sum limit."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + p + 2)
    x, c = (_rand(gen, (m, n), cuda_device, dtype) for _ in range(2))
    cfg = TConfig(d, p, arrangement=arr)
    kernels = (skernel.COPY, skernel.TRIAD, skernel.INIT, skernel.READ,
               skernel.READ_MERGE)
    before = [k.launches for k in kernels]
    y = tsops.stream_copy(x, config=cfg)
    a = run_spec(tsspecs.triad_spec, (x, c, ALPHA), cfg)
    f = tsops.stream_init((m, n), 3.7, dtype, config=cfg, device=cuda_device)
    r = tsops.stream_read(x, config=cfg)
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    assert torch.equal(y, x)
    assert torch.equal(a, run_spec(tsspecs.triad_spec, (x, c, ALPHA), cfg,
                                   mode="ref"))
    assert torch.equal(f, tsops.stream_init((m, n), 3.7, dtype, config=cfg,
                                            mode="ref", device=cuda_device))
    rr = tsops.stream_read(x, config=cfg, mode="ref")
    assert r.shape == rr.shape == (cfg.stride_unroll,)
    seg = m // cfg.stride_unroll
    terms = x.float().abs().reshape(cfg.stride_unroll, -1).sum(1)
    limit = 2 * _dot_factor(seg * n) * GAMMA * terms + 2 * GAMMA * rr.abs()
    assert bool(((r - rr).abs() <= limit).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", [(1, 2), (2, 2), (3, 1), (4, 2), (8, 2),
                                 (16, 1)])
def test_stream_f32_lanes_equal_plain(cuda_device, arr, d, p):
    """The f32 K1 lanes (up to 8 streams of a step in registers, D = 16
    in two groups): copy, triad and init through their ops equal their
    plain versions bit for bit, and a lost-stream control (stream 1's
    rows of the plain output set to -1) does not."""
    m, n = 480, 640
    gen = torch.Generator(device=cuda_device).manual_seed(d * 4 + p)
    x, c = (_rand(gen, (m, n), cuda_device, torch.float32) for _ in range(2))
    cfg = TConfig(d, p, arrangement=arr)
    kernels = (skernel.COPY, skernel.TRIAD, skernel.INIT)
    before = [k.launches for k in kernels]
    got = {"copy": tsops.stream_copy(x, config=cfg),
           "triad": run_spec(tsspecs.triad_spec, (x, c, ALPHA), cfg),
           "init": tsops.stream_init((m, n), 3.7, torch.float32, config=cfg,
                                     device=cuda_device)}
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    want = {"copy": x,
            "triad": run_spec(tsspecs.triad_spec, (x, c, ALPHA), cfg,
                              mode="ref"),
            "init": torch.full((m, n), 3.7, device=cuda_device)}
    for name, ref in want.items():
        assert torch.equal(got[name], ref), name
        if d > 1:
            lost = ref.clone()
            lost[m // d: 2 * m // d] = -1.0
            assert not torch.equal(got[name], lost)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", [(1, 2), (4, 2), (16, 2), (4, 3), (16, 1)])
@pytest.mark.parametrize("m,n", [(512, 384), (256, 640)])
def test_stream_16bit_lanes_equal_plain(cuda_device, dtype, arr, d, p, m,
                                        n):
    """The 16-bit K1 lanes (16 bytes a lane, a pair of sub-portions a
    load): copy, triad and init equal their plain versions bit for bit.
    384 and 640 columns are 3 and 5 sub-portions, so a step ends on an
    odd one (8-byte loads); P=3 starts a pair on an odd sub-portion; P=1
    takes 8-byte loads only; D=16 is two register groups of 8 streams."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + n + d * p)
    x, c = (_rand(gen, (m, n), cuda_device, dtype) for _ in range(2))
    cfg = TConfig(d, p, arrangement=arr)
    kernels = (skernel.COPY, skernel.TRIAD, skernel.INIT)
    before = [k.launches for k in kernels]
    y = tsops.stream_copy(x, config=cfg)
    a = run_spec(tsspecs.triad_spec, (x, c, ALPHA), cfg)
    f = tsops.stream_init((m, n), -3.7, dtype, config=cfg,
                          device=cuda_device)
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    assert torch.equal(y, x)
    assert torch.equal(a, run_spec(tsspecs.triad_spec, (x, c, ALPHA), cfg,
                                   mode="ref"))
    assert torch.equal(f, tsops.stream_init((m, n), -3.7, dtype, config=cfg,
                                            mode="ref", device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", DPS)
def test_stream_read_pass1_matches_plain_chunk_by_chunk(cuda_device, dtype,
                                                        arr, d, p):
    """Pass 1 of the read against its plain version at the card's own
    chunking, each chunk under the f32 sum limit of its own length, on
    a stream row whose last chunk is ragged; losing that chunk would
    land outside the limit."""
    from repro_torch.codegen import plan_blocks
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    nsub = 2 * sms * 7 + 3               # sub-portions of a stream row: odd
    gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + p + 4)
    x2 = (1 + _rand(gen, (d, nsub * 128), cuda_device,
                    torch.float32)).to(dtype)
    cfg = TConfig(d, p, arrangement=arr)
    spec = tsspecs.read_spec(x2)
    bp = plan_blocks(spec, cfg)
    spc, chunks = skernel.read_chunks(bp, sms)
    assert nsub % spc != 0               # 8 sub-portions a chunk, 3 in the last
    part = skernel.read_split(spec, bp, x2, cfg)
    ref = skernel.read_split_plain(spec, bp, x2, spc, chunks)
    assert part.shape == ref.shape == (chunks, d)
    w = spc * 128
    ax = x2.float().abs()
    terms = torch.stack([ax[:, q * w:(q + 1) * w].sum(1)
                         for q in range(chunks)])
    limit = 2 * _dot_factor(w) * GAMMA * terms + 2 * GAMMA * ref.abs()
    assert bool(((part - ref).abs() <= limit).all())
    assert float(ref[-1].abs().min()) > float(limit[-1].max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("per_sm", [1, 2, 4])
def test_stream_read_odd_subportions_and_merge_bits(cuda_device, dtype, arr,
                                                    d, per_sm):
    """The read at an odd number of sub-portions in every chunk (16-bit
    lanes: pairs, then one 8-byte load) and at 1, 2 or 4 chunks an SM:
    pass 1 within each chunk's f32 sum limit of its plain version; the
    merge equal to ``read_merge_plain`` bit for bit (the same fold
    order); and the op's two launches give those bits."""
    from repro_torch.codegen import plan_blocks
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    gen = torch.Generator(device=cuda_device).manual_seed(d * 7 + per_sm)
    spc0 = 7                             # sub-portions a chunk: odd
    nsub = spc0 * per_sm * sms - 2       # the last chunk holds 5
    x2 = (1 + _rand(gen, (d, nsub * 128), cuda_device,
                    torch.float32)).to(dtype)
    cfg = TConfig(d, 2, arrangement=arr)
    spec = tsspecs.read_spec(x2)
    bp = plan_blocks(spec, cfg)
    spc, chunks = skernel.read_chunks(bp, sms, per_sm)
    assert (spc, chunks) == (spc0, per_sm * sms)
    part = skernel.read_split(spec, bp, x2, cfg, per_sm)
    ref = skernel.read_split_plain(spec, bp, x2, spc, chunks)
    ax = x2.float().abs()
    w = spc * 128
    terms = torch.stack([ax[:, q * w:(q + 1) * w].sum(1)
                         for q in range(chunks)])
    limit = 2 * _dot_factor(w) * GAMMA * terms + 2 * GAMMA * ref.abs()
    assert bool(((part - ref).abs() <= limit).all())
    assert float(ref[-1].abs().min()) > float(limit[-1].max())
    y = skernel.read_merge(part)
    assert torch.equal(y, skernel.read_merge_plain(part))
    if per_sm == skernel.READ_BLOCKS_PER_SM:
        before = skernel.READ.launches, skernel.READ_MERGE.launches
        got = tsops.stream_read(x2.reshape(d * 8, -1), config=cfg)
        assert (skernel.READ.launches, skernel.READ_MERGE.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(got, y)


@pytest.mark.gpu
@pytest.mark.parametrize("chunks", [1, 31, 33, 264, 1000])
@pytest.mark.parametrize("d", [1, 4, 9])
def test_stream_read_merge_equals_plain_bits(cuda_device, chunks, d):
    """The merge folds each stream's partials in one warp in the order of
    ``read_merge_plain``: the same bits, for any number of chunks."""
    gen = torch.Generator(device=cuda_device).manual_seed(chunks + d)
    part = _rand(gen, (chunks, d), cuda_device, torch.float32) * 1e3
    assert torch.equal(skernel.read_merge(part),
                       skernel.read_merge_plain(part))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 4, 8])
def test_stream_read_arrangements_give_the_same_bits(cuda_device, d):
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = _rand(gen, (1024, 2048), cuda_device, torch.float32)
    g, i = (tsops.stream_read(x, config=TConfig(d, 2, arrangement=arr))
            for arr in ("grouped", "interleaved"))
    assert torch.equal(g, i)


def _ring_fits(spec, cfg, dtype, limit) -> bool:
    """Whether the K4 ring of ``spec`` fits ``limit`` bytes at its
    narrowest step (128 columns), on the blocked tiling of a 1-D nest."""
    from repro_torch.codegen import block_1d, classify, plan_blocks
    if classify(spec).blocked:
        spec, _ = block_1d(spec, cfg)
    bp = plan_blocks(spec, cfg)
    isz = dtype.itemsize
    return tmanual.ring_smem((isz,) * len(spec.reads), (isz,), bp.d, bp.bm,
                             128, cfg.lookahead) <= limit


@pytest.mark.gpu
@pytest.mark.parametrize("lookahead", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", DPS)
@pytest.mark.parametrize("m,n", STREAM_SHAPES)
def test_manual_ring_matches_plain(cuda_device, lookahead, dtype, arr, d, p,
                                   m, n):
    """Every K4 body (copy, triad, fill, gemver_sum) equals its plain
    version bit for bit, and each call launches its ring once; a ring
    that does not fit the card's shared memory even at 128 columns
    (D=8 with two inputs at lookahead 3 or 4) raises ValueError and
    launches nothing."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + p + 3)
    x, c = (_rand(gen, (m, n), cuda_device, dtype) for _ in range(2))
    v, z = (_rand(gen, (m * n + 77,), cuda_device, dtype) for _ in range(2))
    cfg = TConfig(d, p, lookahead=lookahead, arrangement=arr)
    limit = torch.cuda.get_device_properties(
        cuda_device).shared_memory_per_block_optin
    cases = {
        "stream_copy": (tsspecs.copy_spec, (x,),
                        lambda: tsops.stream_copy_manual(x, config=cfg),
                        lambda: tsops.stream_copy_manual(x, config=cfg,
                                                         mode="ref")),
        "stream_triad": (tsspecs.triad_spec, (x, c, ALPHA),
                         lambda: run_spec(tsspecs.triad_spec, (x, c, ALPHA),
                                          cfg),
                         lambda: run_spec(tsspecs.triad_spec, (x, c, ALPHA),
                                          cfg, mode="ref")),
        "stream_init": (lambda value: tsspecs.init_spec((m, n), dtype, value),
                        (-2.3,),
                        lambda: tsops.stream_init((m, n), -2.3, dtype,
                                                  config=cfg,
                                                  device=cuda_device),
                        lambda: tsops.stream_init((m, n), -2.3, dtype,
                                                  config=cfg, mode="ref",
                                                  device=cuda_device)),
        "gemver_sum": (tgspecs.gemver_sum_spec, (v, z),
                       lambda: tgops.gemver_sum(v, z, config=cfg),
                       lambda: tgops.gemver_sum(v, z, config=cfg,
                                                mode="ref")),
    }
    for name, (build, args, run, plain) in cases.items():
        kernel = tmanual.BODIES[name]
        before = kernel.launches
        if _ring_fits(build(*args), cfg, dtype, limit):
            out = run()
            assert kernel.launches == before + 1, name
            assert torch.equal(out, plain()), name
        else:
            with pytest.raises(ValueError, match="does not fit"):
                run()
            assert kernel.launches == before, name


@pytest.mark.gpu
def test_manual_ring_uses_the_opt_in_shared_memory(cuda_device):
    """The bench copy's ring at lookahead 4 (a 128-column tile, two
    blocks an SM) and triad's (one block an SM) need more than the 48 KB
    a launch gets without opting in, run in one wave, and equal their
    plain versions."""
    x, c = (torch.randn(8192, 4096, device=cuda_device) for _ in range(2))
    cfg = TConfig(4, 2, lookahead=4)
    props = torch.cuda.get_device_properties(cuda_device)
    from repro_torch.codegen import plan_blocks
    bp = plan_blocks(tsspecs.copy_spec(x), cfg)
    for name, per_sm in (("stream_copy", 2), ("stream_triad", 1)):
        plan = tmanual.ring_plan(name, x.dtype, bp, cfg,
                                 props.multi_processor_count)
        assert plan.tw == 128 and plan.per_sm == per_sm
        assert plan.smem > 48 * 1024 and plan.copies == 4
        assert plan.blocks <= per_sm * props.multi_processor_count
    assert torch.equal(tsops.stream_copy_manual(x, config=cfg), x)
    assert torch.equal(run_spec(tsspecs.triad_spec, (x, c, ALPHA), cfg),
                       run_spec(tsspecs.triad_spec, (x, c, ALPHA), cfg,
                                mode="ref"))


RING_RUN_SHAPES = [(2144, 1280), (4096, 2048)]   # 67 row blocks: ragged


@pytest.mark.gpu
@pytest.mark.parametrize("lookahead", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", RING_RUN_SHAPES)
def test_manual_ring_runs_and_waves_match_plain(cuda_device, lookahead,
                                                dtype, m, n):
    """Copy, triad, fill and gemver_sum on rings whose blocks each take
    several steps (more steps than one wave has blocks), with a ragged
    last run and runs that are no multiple of the lookahead: every
    output equals its plain version bit for bit, one launch a call."""
    from repro_torch.codegen import block_1d, classify, plan_blocks
    gen = torch.Generator(device=cuda_device).manual_seed(m + lookahead)
    x, c = (_rand(gen, (m, n), cuda_device, dtype) for _ in range(2))
    v, z = (_rand(gen, (m * n,), cuda_device, dtype) for _ in range(2))
    cfg = TConfig(4, 2, lookahead=lookahead)
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    cases = {
        "stream_copy": ((tsspecs.copy_spec(x)),
                        lambda: tsops.stream_copy_manual(x, config=cfg), x),
        "stream_triad": (tsspecs.triad_spec(x, c, ALPHA),
                         lambda: run_spec(tsspecs.triad_spec, (x, c, ALPHA),
                                          cfg),
                         run_spec(tsspecs.triad_spec, (x, c, ALPHA), cfg,
                                  mode="ref")),
        "stream_init": (tsspecs.init_spec((m, n), dtype, 0.7),
                        lambda: tsops.stream_init((m, n), 0.7, dtype,
                                                  config=cfg,
                                                  device=cuda_device),
                        tsops.stream_init((m, n), 0.7, dtype, config=cfg,
                                          mode="ref", device=cuda_device)),
        "gemver_sum": (tgspecs.gemver_sum_spec(v, z),
                       lambda: tgops.gemver_sum(v, z, config=cfg),
                       tgops.gemver_sum(v, z, config=cfg, mode="ref")),
    }
    plans = []
    for name, (spec, run, want) in cases.items():
        if classify(spec).blocked:
            spec, _ = block_1d(spec, cfg)
        plan = tmanual.ring_plan(name, dtype, plan_blocks(spec, cfg), cfg,
                                 sms)
        assert plan.blocks <= plan.per_sm * sms
        plans.append(plan)
        kernel = tmanual.BODIES[name]
        before = kernel.launches
        out = run()
        assert kernel.launches == before + 1, name
        assert torch.equal(out, want), name
    assert any(p.per > 1 for p in plans)
    if m == 2144:                        # 67 row blocks a segment
        assert any(p.steps % p.per for p in plans)
        assert lookahead == 1 or any(p.per % lookahead for p in plans)


# ------------------------------------------- stencils and doitgen

ALL_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
# output columns: one column and fewer than a vector, the aliased and
# conformance widths, the bench width and its neighbours (2045 and 2047
# are no whole vectors in any dtype; 2046 rows of bf16 start 16, 4, 8, 4
# bytes into a 16-byte boundary)
STENCIL_COLS = [1, 7, 126, 128, 130, 2045, 2046, 2047]


@pytest.fixture
def no_tf32():
    """The plain doitgen is a cuBLAS f32 product: keep TF32 off for it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("cols", STENCIL_COLS)
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("rows", [6, 37, 64])
def test_stencil_kernels_match_plain(cuda_device, dtype, cols, d, rows):
    """Both stencils round as their bodies do, so kernel and plain version
    agree bit for bit.  37 rows do not divide D > 1: the emitter pads the
    rows (the op would clamp D), so the spec is run as the op runs it.
    At 6 rows every segment is shorter than one run; D = 3 leaves a
    stream of the group of 4 idle, D = 8 is two groups."""
    gen = torch.Generator(device=cuda_device).manual_seed(cols * d + rows)
    x = _rand(gen, (rows + 2, cols + 2), cuda_device, dtype)
    w = _rand(gen, (3, 3), cuda_device, dtype)
    w9 = [w[r, c] for r in range(3) for c in range(3)]
    cfg = TConfig(d, 1)
    for kernel, build, args in ((tstencil.JACOBI, tjspecs.jacobi_spec, (x,)),
                                (tstencil.CONV, tcspecs.conv3x3_spec,
                                 (x, *w9))):
        before = kernel.launches
        out = run_spec(build, args, cfg)
        assert kernel.launches == before + 1
        plain = run_spec(build, args, cfg, mode="ref")
        assert out.dtype == dtype and out.shape == (rows, cols)
        assert torch.equal(out, plain), kernel.name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES)
def test_stencil_ops_launch_their_kernel_once(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = _rand(gen, (34, 130), cuda_device, dtype)
    w = _rand(gen, (3, 3), cuda_device, dtype)
    counts = (tstencil.JACOBI.launches, tstencil.CONV.launches)
    j, c = tjops.jacobi2d(x), tcops.conv3x3(x, w)
    assert (tstencil.JACOBI.launches, tstencil.CONV.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert torch.equal(j, tjops.jacobi2d(x, mode="ref"))
    assert torch.equal(c, tcops.conv3x3(x, w, mode="ref"))
    assert (tstencil.JACOBI.launches, tstencil.CONV.launches) == (
        counts[0] + 1, counts[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("cols", [2045, 2046])
@pytest.mark.parametrize("d", [1, 3, 4, 8])
@pytest.mark.parametrize("run", [1, 2, 3, 4, 5, 7, 64])
def test_stencil_geometries_match_plain(cuda_device, dtype, cols, d, run):
    """Every run length through ``stencil.launch`` (the loop's ring of 5
    rows is unrolled: runs of 1-7 rows end at each slot): the rows of
    each run of each stream are written once, bit for bit."""
    from repro_torch.codegen import plan_blocks
    gen = torch.Generator(device=cuda_device).manual_seed(cols + d + run)
    rows = 24
    x = _rand(gen, (rows + 2, cols + 2), cuda_device, dtype)
    w = _rand(gen, (3, 3), cuda_device, dtype)
    w9 = [w[r, c] for r in range(3) for c in range(3)]
    for name, build, args in (("jacobi2d", tjspecs.jacobi_spec, (x,)),
                              ("conv3x3", tcspecs.conv3x3_spec, (x, *w9))):
        spec = build(*args)
        bp = plan_blocks(spec, TConfig(d, 1))
        g = tstencil.geometry(bp, x.element_size(), 132, run=run)
        out = tstencil.launch(name, x, tstencil.conv_weights(w9, x.device)
                              if name == "conv3x3" else None, bp, g)
        plain = run_spec(build, args, TConfig(d, 1), mode="ref")
        assert torch.equal(out, plain), (name, g)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("cols", [125, 2046])
def test_stencil_rows_at_any_alignment_match_plain(cuda_device, dtype,
                                                   offset, cols):
    """x a contiguous view ``offset`` elements into its buffer: every
    input row starts off a 16-byte boundary (2, 4, 6, 8 or 12 bytes), so
    rows load in narrower pieces; the output's own rows as they fall."""
    gen = torch.Generator(device=cuda_device).manual_seed(offset + cols)
    rows = 40
    buf = _rand(gen, (offset + (rows + 2) * (cols + 2),), cuda_device,
                dtype)
    x = buf[offset:].view(rows + 2, cols + 2)
    w = _rand(gen, (3, 3), cuda_device, dtype)
    assert torch.equal(tjops.jacobi2d(x), tjops.jacobi2d(x, mode="ref"))
    assert torch.equal(tcops.conv3x3(x, w), tcops.conv3x3(x, w, mode="ref"))


@pytest.mark.gpu
def test_conv_weights_of_one_f32_tensor_take_no_launch(cuda_device):
    """conv3x3's nine weights, as the op unpacks a contiguous [3, 3]: the
    kernel reads that storage (f32, bf16 or f16), and nothing is
    launched to pack it; another layout is packed on the card, in the
    same order; a 16-bit weight widens to f32 in one cast where f32 is
    asked for."""
    w = torch.randn(3, 3, device=cuda_device)
    for wd in (w, w.bfloat16(), w.half()):
        w9 = [wd[r, c] for r in range(3) for c in range(3)]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = tstencil.kernel_weights(w9, w.device)
            torch.cuda.synchronize()
        assert got.data_ptr() == wd.data_ptr() and got.dtype == wd.dtype
        assert not [e for e in prof.events() if e.device_type ==
                    torch.autograd.DeviceType.CUDA]
        assert torch.equal(got, wd.reshape(9))
    assert tstencil.conv_weights([w[r, c] for r in range(3)
                                  for c in range(3)], w.device).data_ptr() \
        == w.data_ptr()
    wt = w.t()
    packed = tstencil.conv_weights([wt[r, c] for r in range(3)
                                    for c in range(3)], w.device)
    assert packed.data_ptr() != w.data_ptr()
    assert torch.equal(packed, wt.reshape(9))
    wb = w.bfloat16()
    assert torch.equal(tstencil.conv_weights(
        [wb[r, c] for r in range(3) for c in range(3)], w.device),
        wb.float().reshape(9))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("wdtype", ALL_DTYPES)
def test_conv3x3_weights_in_any_type_match_plain(cuda_device, dtype,
                                                 wdtype):
    """conv3x3 with its weight in each type beside x's: the kernel widens
    the weights of their own storage as the plain body widens them."""
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    x = _rand(gen, (40, 133), cuda_device, dtype)
    w = _rand(gen, (3, 3), cuda_device, wdtype)
    before = tstencil.CONV.launches
    got = tcops.conv3x3(x, w)
    assert tstencil.CONV.launches == before + 1
    assert torch.equal(got, tcops.conv3x3(x, w, mode="ref"))


# (r, q, s, p): q not divisible by D pads the rows, p = 24, 100, 200 and
# 32 mask a p tile, p = 100 is no whole 16-byte group in bf16 and f16
# (the staging instance), s = 72 is not a multiple of either chunk (32
# in bf16 and f16, 16 in f32), then the bench size (the 64 tile) and a
# batch of 64 (the 128 tile)
DOITGEN_SHAPES = [(3, 10, 32, 24), (2, 64, 256, 200), (4, 8, 32, 32),
                  (1, 37, 40, 100), (2, 16, 72, 64), (16, 256, 256, 256),
                  (64, 256, 256, 256)]


def _doitgen_case(dev, dtype, r, q, s, p, seed, offset=0):
    """A [r, q, s] and C4 [s, p] drawn on the card; ``offset`` > 0 makes
    A a contiguous view ``offset`` elements into its buffer (not 16-byte
    aligned)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = _rand(gen, (offset + r * q * s,), dev, dtype)
    a = buf[offset:].view(r, q, s)
    return a, _rand(gen, (s, p), dev, dtype)


def _check_doitgen(a, c4, cfg):
    """One launch through the spec, held against the plain version under
    the dot limit of s terms plus the rounding into the dtype."""
    before = dgkernel.DOITGEN.launches
    out = run_spec(tdgspecs.doitgen_spec, (a, c4), cfg)
    assert dgkernel.DOITGEN.launches == before + 1
    plain = run_spec(tdgspecs.doitgen_spec, (a, c4), cfg, mode="ref")
    r, q, s = a.shape
    assert out.dtype == a.dtype and out.shape == (r, q, c4.shape[1])
    terms = torch.einsum("rqs,sp->rqp", a.float().abs(), c4.float().abs())
    _assert_dot(out, plain, terms, s)


class _Recorder:
    """Stands in for ``dgkernel.DOITGEN``: records each launch's
    arguments and launches through the real kernel."""

    def __init__(self, kernel):
        self.kernel, self.args = kernel, []

    @property
    def launches(self):
        return self.kernel.launches

    def __call__(self, device, *args):
        self.args.append(args)
        self.kernel(device, *args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("r,q,s,p", DOITGEN_SHAPES)
def test_doitgen_kernel_matches_plain(cuda_device, no_tf32, dtype, d, r, q,
                                      s, p):
    """Each output is an f32 dot of s terms (on the tensor cores in bf16
    and f16), summed in another order than the plain cuBLAS product:
    held to the dot limit, plus the rounding into the dtype."""
    a, c4 = _doitgen_case(cuda_device, dtype, r, q, s, p, r * q + s + p + d)
    _check_doitgen(a, c4, TConfig(d, 1))
    before = dgkernel.DOITGEN.launches
    assert tdgops.doitgen(a, c4).shape == (r, q, p)
    assert dgkernel.DOITGEN.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("tile", dgkernel.TILES)
@pytest.mark.parametrize("vec", [True, False])
def test_doitgen_instances_match_plain(cuda_device, no_tf32, monkeypatch,
                                       dtype, tile, vec):
    """Every instance, picked by the wrapper from shapes and addresses:
    the 64 tile at (4, 64, 96, 96), the 128 tile at (64, 256, 256, 256);
    the staging instance where A starts one element past a 16-byte
    boundary."""
    rec = _Recorder(dgkernel.DOITGEN)
    monkeypatch.setattr(dgkernel, "DOITGEN", rec)
    r, q, s, p = (64, 256, 256, 256) if tile == 128 else (4, 64, 96, 96)
    a, c4 = _doitgen_case(cuda_device, dtype, r, q, s, p, tile + vec,
                          offset=0 if vec else 1)
    _check_doitgen(a, c4, TConfig(4, 1))
    ((*_, got_tile, got_vec, _blocks),) = rec.args
    assert (got_tile, bool(got_vec)) == (tile, vec)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("d,bm", [(16, 0), (8, 32)])
def test_doitgen_two_passes_match_plain(cuda_device, no_tf32, dtype, d, bm):
    """At the bench size a block's rows take more than one pass of its
    tile: D=16 at the default rows (16 x 8 rows, two passes of the 64
    tile in f32) and D=8 at block_rows 32 (256 rows, four passes of the
    64 tile in every dtype; ``test_doitgen_geometry_takes_several_passes``
    counts them).  Every pass's stores go to its own rows before the
    next pass takes the row table, in each of three launches."""
    a, c4 = _doitgen_case(cuda_device, dtype, 16, 256, 256, 256, d + bm)
    for _ in range(3):
        _check_doitgen(a, c4, TConfig(d, 1, block_rows=bm))


@pytest.mark.gpu
def test_stencil_and_doitgen_wrappers_raise_on_what_they_do_not_take(
        cuda_device):
    x = torch.randn(34, 130, device=cuda_device)
    w = torch.randn(3, 3, device=cuda_device)
    a = torch.randn(2, 8, 32, device=cuda_device)
    c4 = torch.randn(32, 16, device=cuda_device)
    counts = {k.name: k.launches for k in (tstencil.JACOBI, tstencil.CONV,
                                            dgkernel.DOITGEN)}
    with pytest.raises(TypeError):                    # f64 not compiled
        tjops.jacobi2d(x.double())
    with pytest.raises(TypeError):
        tcops.conv3x3(x.double(), w.double())
    with pytest.raises(TypeError):
        tdgops.doitgen(a.double(), c4.double())
    with pytest.raises(TypeError):                    # mixed dtypes
        tdgops.doitgen(a, c4.bfloat16())
    assert counts == {k.name: k.launches for k in (
        tstencil.JACOBI, tstencil.CONV, dgkernel.DOITGEN)}


# ------------------------------------------------------------- adamw

# (60, 100) pads to a [12, 512] blocking, (128, 128) is [32, 512], the
# bench size (4096, 1024) is [8192, 512]; (3, 64) is one 192-column row
ADAMW_SHAPES = [(60, 100), (128, 128), (4096, 1024), (3, 64)]


def _adamw_inputs(gen, shape, dev, dtype):
    p, g, m = (_rand(gen, shape, dev, t)
               for t in (dtype, dtype, torch.float32))
    v = torch.rand(*shape, generator=gen, device=dev)
    return p, g, m, v


def _adamw_equal(got, want, dtype):
    """p' in p's dtype, m' and v' f32, each equal to the plain version's
    bit for bit."""
    for o, w, dt in zip(got, want, (dtype, torch.float32, torch.float32)):
        assert o.dtype == dt and o.shape == w.shape
        assert torch.equal(o, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", DPS)
@pytest.mark.parametrize("shape", ADAMW_SHAPES)
def test_adamw_kernel_matches_plain(cuda_device, dtype, arr, d, p, shape):
    """The K1 adamw kernel equals its plain version bit for bit (p' one
    rounding from f32), one launch a call, with 0-d scalar tensors on the
    card as the optimizer passes them and with Python numbers."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + p)
    args = _adamw_inputs(gen, shape, cuda_device, dtype)
    cfg = TConfig(d, p, arrangement=arr)
    hyper = dict(_HYPER)
    on_card = dict(zip(hyper, taops.scalars(cuda_device, *hyper.values())))
    for kw in (hyper, on_card):
        before = akernel.ADAMW.launches
        got = taops.adamw_update(*args, config=cfg, **kw)
        assert akernel.ADAMW.launches == before + 1
        _adamw_equal(got, taops.adamw_update(*args, config=cfg, mode="ref",
                                             **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("lookahead", [1, 3, 4])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", DPS)
@pytest.mark.parametrize("shape", ADAMW_SHAPES)
def test_adamw_ring_matches_plain(cuda_device, lookahead, arr, d, p, shape):
    """The K4 ring's adamw body (four inputs, three outputs) equals the
    plain version bit for bit and launches once; where even a
    128-column step does not fit shared memory it raises ValueError
    naming the bytes and launches nothing."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + p + 1)
    args = _adamw_inputs(gen, shape, cuda_device, torch.float32)
    cfg = TConfig(d, p, lookahead=lookahead, arrangement=arr)
    limit = torch.cuda.get_device_properties(
        cuda_device).shared_memory_per_block_optin
    kernel = tmanual.BODIES["adamw_update"]
    before = kernel.launches
    from repro_torch.codegen import plan_blocks
    from repro_torch.kernels.common import effective_config
    rows, cols = taops._blocking(shape[0] * shape[1])
    bp = plan_blocks(taspecs.adamw_spec(torch.empty(rows, cols), None, None,
                                        None), effective_config(cfg, rows,
                                                                cfg))
    need = tmanual.ring_smem((4,) * 4, (4,) * 3, bp.d, bp.bm, 128, lookahead)
    if need <= limit:
        got = taops.adamw_update(*args, config=cfg, **_HYPER)
        assert kernel.launches == before + 1
        _adamw_equal(got, taops.adamw_update(*args, config=cfg, mode="ref",
                                             **_HYPER), torch.float32)
    else:
        with pytest.raises(ValueError, match=f"{need} bytes"):
            taops.adamw_update(*args, config=cfg, **_HYPER)
        assert kernel.launches == before


@pytest.mark.gpu
def test_adamw_ring_fits_at_d2_and_refuses_d4(cuda_device):
    """At the bench blocking [8192, 512], D=2 bm=8: the ring of four
    inputs and three outputs fits at lookahead 3 (144 KiB) and 4
    (176 KiB), one block an SM; at D=4 and lookahead 3 it does not, and the ValueError
    says so without changing D or the lookahead.  A bf16 parameter now
    runs on the ring (p, g and p' bf16, m and v f32) and equals the
    plain version bit for bit."""
    limit = torch.cuda.get_device_properties(
        cuda_device).shared_memory_per_block_optin
    x = torch.zeros(8192, 512, device=cuda_device)
    for la, kib in ((3, 144), (4, 176)):
        smem = tmanual.ring_smem((4,) * 4, (4,) * 3, 2, 8, 128, la)
        assert smem // 1024 == kib and tmanual.ring_blocks_per_sm(smem) == 1
        out = taops.adamw_update(x, x, x, x + 1, config=TConfig(
            2, 2, lookahead=la), **_HYPER)
        assert all(torch.isfinite(o).all() for o in out)
    # bf16 p and g: 112 KiB at lookahead 3, so two blocks share an SM
    assert tmanual.ring_blocks_per_sm(tmanual.ring_smem(
        (2, 2, 4, 4), (2, 4, 4), 2, 8, 128, 3)) == 2
    cfg = TConfig(4, 2, lookahead=3)
    with pytest.raises(ValueError, match="does not fit shared memory"):
        taops.adamw_update(x, x, x, x + 1, config=cfg, **_HYPER)
    assert cfg.stride_unroll == 4 and cfg.lookahead == 3
    assert tmanual.ring_smem((4,) * 4, (4,) * 3, 4, 8, 128, 3) > limit
    kernel = tmanual.BODIES["adamw_update"]
    before = kernel.launches
    y = x + torch.linspace(-1, 1, 512, device=cuda_device)
    args = (y.bfloat16(), (2 * y).bfloat16(), y, y.abs() + 1)
    cfg = TConfig(2, 2, lookahead=3)
    _adamw_equal(taops.adamw_update(*args, config=cfg, **_HYPER),
                 taops.adamw_update(*args, config=cfg, mode="ref", **_HYPER),
                 torch.bfloat16)
    assert kernel.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("lookahead", [1, 3, 4])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("shape", ADAMW_SHAPES)
def test_adamw_ring_mixed_dtypes_match_plain(cuda_device, dtype, lookahead,
                                             arr, shape):
    """The ring's adamw body with p and g of a 16-bit type and f32 m and
    v (each operand's stages in its own element size) equals the plain
    version bit for bit: p' one rounding from f32, m' and v' f32."""
    gen = torch.Generator(device=cuda_device).manual_seed(lookahead + 40)
    args = _adamw_inputs(gen, shape, cuda_device, dtype)
    cfg = TConfig(2, 2, lookahead=lookahead, arrangement=arr)
    kernel = tmanual.BODIES["adamw_update"]
    before = kernel.launches
    got = taops.adamw_update(*args, config=cfg, **_HYPER)
    assert kernel.launches == before + 1
    _adamw_equal(got, taops.adamw_update(*args, config=cfg, mode="ref",
                                         **_HYPER), dtype)


ROWSTAT_SHAPES = [(16, 256), (512, 1024), (96, 384), (4096, 640)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lookahead", [1, 3, 4])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,bm", [(1, 1), (2, 1), (2, 3), (4, 8)])
@pytest.mark.parametrize("shape", ROWSTAT_SHAPES)
def test_rowstat_ring_matches_plain(cuda_device, dtype, lookahead, arr, d,
                                    bm, shape):
    """The ring's ``t_rowstat`` body (a rank-1 ``(stride,)`` side write
    next to the full-row map): ``o = 2·x`` equals the plain version bit
    for bit; the f32 row sums agree within the f32 sum limit (another
    order of the same sum) and repeat bit for bit.  One launch a call;
    steps of whole rows, and a whole-row ring that does not fit shared
    memory raises ValueError naming the bytes and launches nothing."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 7 + bm)
    x = _rand(gen, shape, cuda_device, dtype)
    cfg = TConfig(d, 1, lookahead=lookahead, arrangement=arr, block_rows=bm)
    spec = tmanual.rowstat_spec(x)
    assert tcg_template(spec, cfg) == "K4"
    from repro_torch.codegen import plan_blocks
    bp = plan_blocks(spec, cfg)
    ins, outs, n_row = tmanual.ring_sizes("t_rowstat", dtype)
    need = tmanual.ring_smem(ins, outs, bp.d, bp.bm, bp.cols, lookahead,
                             n_row)
    kernel = tmanual.BODIES["t_rowstat"]
    before = kernel.launches
    if need > torch.cuda.get_device_properties(
            cuda_device).shared_memory_per_block_optin:
        with pytest.raises(ValueError, match=f"{need} bytes"):
            run_spec(tmanual.rowstat_spec, (x,), cfg)
        assert kernel.launches == before
        return
    o, r = run_spec(tmanual.rowstat_spec, (x,), cfg)
    assert kernel.launches == before + 1
    ro, rr = run_spec(tmanual.rowstat_spec, (x,), cfg, mode="ref")
    assert o.dtype == r.dtype == torch.float32 and r.shape == (shape[0],)
    assert torch.equal(o, ro)
    n = shape[1]
    limit = 2 * _dot_factor(n) * GAMMA * x.float().abs().sum(-1)
    assert bool(((r - rr).abs() <= limit).all())
    assert torch.equal(r, run_spec(tmanual.rowstat_spec, (x,), cfg)[1])


@pytest.mark.gpu
def test_adamw_wrappers_raise_on_what_they_do_not_take(cuda_device):
    x = torch.randn(64, 128, device=cuda_device)
    before = akernel.ADAMW.launches
    with pytest.raises(TypeError):                    # f64 not compiled
        taops.adamw_update(x.double(), x.double(), x, x, **_HYPER)
    with pytest.raises(TypeError):                    # p and g differ
        taops.adamw_update(x, x.bfloat16(), x, x, **_HYPER)
    assert akernel.ADAMW.launches == before


# -------------------------------- the registry and the *_gen instances

def _leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


REGISTRY_POINTS = tregistry.conformance_points()


@pytest.mark.gpu
@pytest.mark.parametrize("point,kernel,sizes,config", REGISTRY_POINTS,
                         ids=[p[0] for p in REGISTRY_POINTS])
def test_registry_rows_match_plain(cuda_device, point, kernel, sizes,
                                   config):
    """Every registry row at every conformance point: its kernels on the
    card against its plain version on the card, at the row's
    tolerances."""
    row = tregistry.get(kernel)
    inputs = row.make_inputs(sizes, torch.float32, cuda_device)
    got = _leaves(row.run(inputs, config, None))
    want = _leaves(row.run(inputs, config, "ref"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=row.rtol,
                                   atol=row.atol)


GEN_DS = [1, 2, 4, 8]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", GEN_DS)
@pytest.mark.parametrize("m,n", [(512, 1024), (200, 1000), (37, 33)])
def test_transpose_kernel_equals_plain(cuda_device, dtype, d, m, n):
    """A transpose moves bits: equal to the plain version, ragged shapes
    and every D included, one launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + d)
    x = _rand(gen, (m, n), cuda_device, dtype)
    before = genkernel.TRANSPOSE.launches
    y = tgen.transpose_gen(x, config=TConfig(d, 1))
    assert genkernel.TRANSPOSE.launches == before + 1
    assert y.shape == (n, m) and y.dtype == dtype
    assert torch.equal(y, x.t())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", DPS)
@pytest.mark.parametrize("m,n", [(512, 1024), (96, 384)])
def test_rowstat_kernel_matches_plain(cuda_device, dtype, arr, d, p, m, n):
    """The row max equals the plain version's; the row sum lies within
    the f32 sum limit over |x|.  Both f32 whatever x is."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + p)
    x = _rand(gen, (m, n), cuda_device, dtype) - 3.0
    cfg = TConfig(d, p, arrangement=arr)
    before = genkernel.ROWSTAT.launches
    mx, sm = tgen.rowstat_gen(x, config=cfg)
    assert genkernel.ROWSTAT.launches == before + 1
    rmx, rsm = tgen.rowstat_gen(x, config=cfg, mode="ref")
    assert mx.dtype == sm.dtype == torch.float32
    assert torch.equal(mx, rmx)
    _assert_dot(sm, rsm, x.float().abs().sum(-1), n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [1, 4, 8])
@pytest.mark.parametrize("m,n", [(256, 2048), (96, 1152), (4096, 4096)])
def test_rowstat_arrangements_give_the_same_bits(cuda_device, dtype, d, m,
                                                 n):
    """Grouped and interleaved loads give the same bits in 16-bit types
    as in f32, with one part a slot and with several (these shapes and
    D values take 1, 2, 4 and 8 parts)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + m)
    x = _rand(gen, (m, n), cuda_device, dtype)
    got = [tgen.rowstat_gen(x, config=TConfig(d, 2, arrangement=arr))
           for arr in ("grouped", "interleaved")]
    assert all(torch.equal(g, i) for g, i in zip(*got))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d", [1, 4, 8])
@pytest.mark.parametrize("n", [384, 1152])
def test_rowstat_16bit_odd_subportions_nan_and_neg_inf(cuda_device, dtype,
                                                       arr, d, n):
    """16-bit rows of an odd count of sub-portions (the last one an
    8-byte load of the last part): a NaN in the upper half of a lane's
    16-byte unit and one in the odd last sub-portion propagate to the
    max and the sum; a row of -inf gives -inf for both; every other row
    agrees with the plain version (max equal, sum within the sum
    limit)."""
    m = 96
    gen = torch.Generator(device=cuda_device).manual_seed(n + d)
    x = _rand(gen, (m, n), cuda_device, dtype) - 3.0
    x[5, 8 * 3 + 7] = float("nan")      # lane 3's first unit, element 7
    x[17, n - 1] = float("nan")         # the odd last sub-portion
    x[40] = float("-inf")
    x[71, n - 2] = float("inf")
    cfg = TConfig(d, 2, arrangement=arr)
    before = genkernel.ROWSTAT.launches
    mx, sm = tgen.rowstat_gen(x, config=cfg)
    assert genkernel.ROWSTAT.launches == before + 1
    rmx, rsm = tgen.rowstat_gen(x, config=cfg, mode="ref")
    for got, ref in ((mx, rmx), (sm, rsm)):
        assert torch.equal(got.isnan(), ref.isnan())
        assert bool(got.isnan()[[5, 17]].all())
    assert mx[40] == rmx[40] == float("-inf") == sm[40]
    assert mx[71] == sm[71] == float("inf")
    ok = ~rsm.isnan() & rsm.isfinite()
    assert torch.equal(mx[~rmx.isnan()], rmx[~rmx.isnan()])
    _assert_dot(sm[ok], rsm[ok], x.float().abs().sum(-1)[ok], n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scalar", ["float", "tensor"])
@pytest.mark.parametrize("d,p", DPS)
@pytest.mark.parametrize("m,n", LINALG_SHAPES)
def test_gemver_mxv_kernels_match_plain(cuda_device, dtype, scalar, d, p, m,
                                        n):
    """gemver_mxv2 (K2, α A x), gemver_mxv1 (K3, x + β Aᵀ y) and
    gemver_mxv1_sum (K3, + z and the total) through their ``*_gen`` ops,
    with α and β as Python floats or 0-d tensors on the card, against
    their plain versions within the f32 dot limits (the kernels apply β
    to each partial, the plain versions once)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + p + 7)
    a = _rand(gen, (m, n), cuda_device, dtype)
    xn, zn = (_rand(gen, (n,), cuda_device, dtype) for _ in range(2))
    ym = _rand(gen, (m,), cuda_device, dtype)
    alpha, beta = 1.5, 1.2
    if scalar == "tensor":
        alpha = torch.tensor(alpha, device=cuda_device)
        beta = torch.tensor(beta, device=cuda_device)
    cfg = TConfig(d, p)
    kernels = (mkernel.MXV2, mkernel.MXV1, mkernel.MXV1_SUM)
    before = [k.launches for k in kernels]
    n_all = sum(k.launches for k in cuda.KERNELS.values())
    w = tgen.gemver_mxv2_gen(a, xn, alpha, config=cfg)
    x1 = tgen.gemver_mxv1_gen(a, ym, xn, beta, config=cfg)
    x2, total = tgen.gemver_mxv1_sum_gen(a, ym, xn, zn, beta, config=cfg)
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    # one launch each: the row, its merge and gemver_mxv1_sum's total in
    # the column-dot's own launch
    assert sum(k.launches for k in cuda.KERNELS.values()) == n_all + 3
    rw = tgen.gemver_mxv2_gen(a, xn, alpha, config=cfg, mode="ref")
    rx1 = tgen.gemver_mxv1_gen(a, ym, xn, beta, config=cfg, mode="ref")
    rx2, rtotal = tgen.gemver_mxv1_sum_gen(a, ym, xn, zn, beta, config=cfg,
                                           mode="ref")
    aa = a.float().abs()
    _assert_dot(w, rw, 1.5 * (aa * xn.float().abs()).sum(-1), n)
    col = 1.2 * (ym.float().abs()[:, None] * aa).sum(0)     # >= |s|
    # x + s (+ z): the sum's limit, then the roundings of s and of the
    # adds into x's dtype (unit roundoff u) on each side
    u = 2.0 ** -8 if dtype == torch.bfloat16 else GAMMA
    for got, want, z_abs in ((x1, rx1, 0.0), (x2, rx2, zn.float().abs())):
        limit = 2 * _dot_factor(m) * GAMMA * col + 4 * u * (
            xn.float().abs() + col + z_abs)
        assert bool(((got.float() - want.float()).abs() <= limit).all())
    assert total.shape == () and total.dtype == torch.float32
    # the total of n row entries, each within the column limit
    t_lim = (2 * _dot_factor(m) * GAMMA * float(col.sum())
             + 2 * _dot_factor(n) * GAMMA * float(col.sum()))
    assert abs(float(total) - float(rtotal)) <= t_lim
    again = tgen.gemver_mxv1_sum_gen(a, ym, xn, zn, beta, config=cfg)[1]
    assert torch.equal(again, total)           # no atomics: same bits


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", [4096, 16384])
@pytest.mark.parametrize("d", [1, 4, 8])
def test_column_dot_clusters_match_plain(cuda_device, dtype, n, d):
    """The column-dot at 4096^2 and 16384^2 at every cluster size (1, 2,
    4, 8 and the geometry's own) against its plain version in the same
    rank order, within the f32 dot limit of a rank's rows; a lost-chunk
    control (one rank's partial row dropped from the fold) lies outside
    the limit; two calls give the same bits."""
    from repro_torch.codegen import plan_blocks
    from repro_torch.kernels.mxv import specs as tmspecs
    gen = torch.Generator(device=cuda_device).manual_seed(n + d)
    a = _rand(gen, (n, n), cuda_device, dtype)
    x = (1 + torch.rand(n, generator=gen, device=cuda_device)).to(dtype)
    spec = tmspecs.mxv_t_spec(a, x)
    bp = plan_blocks(spec, TConfig(d, 2))
    for cs in (None, 1, 2, 4, 8):
        g = mkernel.launch_geometry(bp, a, cs)
        n0 = mkernel.COLDOT.launches
        y = mkernel.coldot(spec, bp, [a, x], cluster=cs)
        assert mkernel.COLDOT.launches == n0 + 1 and y.dtype == dtype
        part = mkernel.split_plain(spec, bp, [a, x], g)
        ref = mkernel.merge_plain(part, torch.float32)
        terms = (x.float().abs()[:, None] * a.float().abs()).sum(0)
        limit = (2 * _dot_factor(n // g.cluster) * GAMMA * terms
                 + (2.0 ** -7 if dtype != torch.float32 else 2 * GAMMA)
                 * ref.abs())
        assert bool(((y.float() - ref).abs() <= limit).all())
        if g.cluster > 1:
            lost = merge_plain_without(part, 1)
            assert not bool(((lost - ref).abs() <= limit).all())
        assert torch.equal(mkernel.coldot(spec, bp, [a, x], cluster=cs), y)


def merge_plain_without(part, rank):
    """The plain fold with one rank's partial row lost."""
    kept = part.clone()
    kept[rank] = 0
    return mkernel.merge_plain(kept, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 16384])
def test_column_dot_total_bits_repeat_and_ticket_resets(cuda_device, n):
    """gemver_mxv1_sum's row and total: two calls, a call on a second
    stream (its own ticket counter) and three replays of a CUDA graph
    give the same bits, and every counter is back at 0 after each."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    a = 1 + torch.rand(n, n, generator=gen, device=cuda_device)
    ym, xn, zn = (torch.rand(n, generator=gen, device=cuda_device)
                  for _ in range(3))
    cfg = TConfig(4, 2)

    def run():
        return tgen.gemver_mxv1_sum_gen(a, ym, xn, zn, 1.2, config=cfg)
    x1, t1 = run()
    x2, t2 = run()
    assert torch.equal(x1, x2) and torch.equal(t1, t2)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        x3, t3 = run()
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    assert torch.equal(x3, x1) and torch.equal(t3, t1)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        xg, tg = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(xg, x1) and torch.equal(tg, t1)
    assert all(int(t.item()) == 0 for t in mkernel._TICKETS.values())
    rx, rt = tgen.gemver_mxv1_sum_gen(a, ym, xn, zn, 1.2, config=cfg,
                                      mode="ref")
    assert abs(float(t1) - float(rt)) <= 1e-4 * abs(float(rt))


@pytest.mark.gpu
def test_column_dot_total_graphs_own_their_tickets(cuda_device,
                                                   monkeypatch):
    """Two CUDA graphs of gemver_mxv1_sum captured one after the other
    (torch.cuda.graph captures both on one stream), with no counter made
    before: each owns its ticket counter, zeroed inside the graph, so the
    second replayed alone before the first ever is, and the two replayed
    at once on two streams, give the eager call's bits; capture caches
    no counter."""
    n = 4096
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    a = 1 + torch.rand(n, n, generator=gen, device=cuda_device)
    ym, xn, zn = (torch.rand(n, generator=gen, device=cuda_device)
                  for _ in range(3))
    cfg = TConfig(4, 2)

    def run():
        return tgen.gemver_mxv1_sum_gen(a, ym, xn, zn, 1.2, config=cfg)
    x1, t1 = run()
    torch.cuda.synchronize()
    monkeypatch.setattr(mkernel, "_TICKETS", {})
    graphs, outs = [], []
    for _ in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(run())
        graphs.append(graph)
    assert mkernel._TICKETS == {}
    for _ in range(3):
        graphs[1].replay()
        torch.cuda.synchronize()
        assert torch.equal(outs[1][0], x1) and torch.equal(outs[1][1], t1)
    main = torch.cuda.current_stream(cuda_device)
    streams = [torch.cuda.Stream(cuda_device) for _ in graphs]
    for _ in range(5):
        for stream, graph in zip(streams, graphs):
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                graph.replay()
        for stream in streams:
            main.wait_stream(stream)
        torch.cuda.synchronize()
        for xg, tg in outs:
            assert torch.equal(xg, x1) and torch.equal(tg, t1)


@pytest.mark.gpu
def test_bf16_attention_scores_are_f32(cuda_device):
    """bf16 scores come out in f32 from the bf16 operands (no bf16
    rounding in between), as the f32-widened product computes them, and
    their gradients are the f32 cotangent times the other operand in
    f32, narrowed to bf16."""
    from repro_torch.models import attention
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k = (_rand(gen, (2, 4, 64, 32), cuda_device, torch.bfloat16)
            .requires_grad_() for _ in range(2))
    s = attention._scores_f32(q, k)
    assert s.dtype == torch.float32 and s.shape == (8, 64, 64)
    assert s._base is None                  # in place is safe
    q2, k2 = (t.detach().clone().requires_grad_() for t in (q, k))
    ref = torch.matmul(q2.float(), k2.float().transpose(-1, -2)).reshape(
        8, 64, 64)
    torch.testing.assert_close(s, ref, rtol=1e-5, atol=1e-5)
    g = torch.randn(s.shape, generator=gen, device=cuda_device)
    s.backward(g)
    ref.backward(g)
    for got, want in ((q.grad, q2.grad), (k.grad, k2.grad)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -7, atol=1e-5)
