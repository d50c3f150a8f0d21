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


@pytest.fixture(autouse=True)
def no_fallback(request, monkeypatch):
    """Fail a test in which a guarded launch failed on the card: another
    config would then have served a call that asked for one config by
    name, or that should have run the one resolution chose, and the
    test would pass on a kernel that failed.  A test that arms a fault
    on purpose asks for ``allow_fallback``."""
    from repro_torch import obs
    failed = []
    real = obs.counter

    def counter(name, *args, **attrs):
        if name == "kernel.fallback.count":
            failed.append(attrs.get("kernel"))
        return real(name, *args, **attrs)
    monkeypatch.setattr(obs, "counter", counter)
    yield
    if "allow_fallback" not in request.fixturenames:
        assert not failed, f"a guarded launch failed and fell back: {failed}"


@pytest.fixture
def allow_fallback():
    """Lets :func:`no_fallback` pass a test that arms a fault."""


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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shards,j", [(4, 1), (4, 3), (2, 0), (8, 5)])
@pytest.mark.parametrize("masked", [True, False])
def test_decode_split_reads_a_pitched_slice_in_place(cuda_device, dtype,
                                                     shards, j, masked):
    """Shard j of a [B, S, Hkv, dh] cache, ``kc[:, j·S/K:(j+1)·S/K]``, is
    not contiguous (its batch rows lie S rows apart): the split reads it
    in place, against its plain version, and bit-equal to the same
    kernel on a contiguous copy of the slice."""
    from repro_torch.codegen import plan_blocks
    from repro_torch.kernels.decode_attn import specs as tdspecs
    b, s, hkv, g, dh = 3, 2048, 2, 8, 128
    q, k, v = _decode_case(cuda_device, dtype, b, s, hkv, g, dh,
                           shards * 8 + j)
    sp = s // shards
    ks, vs = k[:, j * sp:(j + 1) * sp], v[:, j * sp:(j + 1) * sp]
    assert not ks.is_contiguous()
    kv_len = torch.tensor([j * sp + 17, s, 0], device=cuda_device)
    mask = (tdops.validity_mask((kv_len - j * sp).clamp(0, sp), b, sp,
                                cuda_device),) if masked else ()
    pitched = tdops._flatten(q, ks, vs) + mask
    copied = tdops._flatten(q, ks.contiguous(), vs.contiguous()) + mask
    assert dkernel.batch_pitch(pitched[0], pitched[1]) == s
    spec = tdspecs.decode_spec(hkv, dh, masked)(*pitched)
    bp = plan_blocks(spec, TConfig(4, 1))
    n = dkernel.SPLIT.launches
    got = dkernel.split(spec, bp, pitched)
    same = dkernel.split(spec, bp, copied)
    assert dkernel.SPLIT.launches == n + 2
    for a, c in zip(got, same):
        assert torch.equal(a, c)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    mo, ml = dkernel.merge(spec.combine, *got)
    ro, rl = dkernel.merge_plain(spec.combine,
                                 *dkernel.split_plain(spec, bp, pitched,
                                                      sms=sms))
    torch.testing.assert_close(mo, ro, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ml, rl, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_decode_split_refuses_what_is_not_a_pitched_slice(cuda_device):
    """Rows of Hkv·dh that are not dense, K and V at other strides, and
    a batch stride under S rows are refused; a slice is not copied."""
    b, s, hkv, dh = 2, 256, 2, 64
    q, k, v = _decode_case(cuda_device, torch.bfloat16, b, s, hkv, 2, dh, 1)
    with pytest.raises(ValueError):                  # heads not dense
        tdops.decode_attn(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError):                  # K and V strides
        tdops.decode_attn(q, k[:, :128], v.contiguous()[:, 64:192]
                          .contiguous())
    e = hkv * dh                                     # batch rows 1 row apart
    buf = torch.zeros(s + b, e, dtype=k.dtype, device=cuda_device)
    over = buf.as_strided((b, s, hkv, dh), (e, e, dh, 1))
    with pytest.raises(ValueError):
        tdops.decode_attn(q, over, over)


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("ragged", [True, False])
def test_static_split_matches_unsharded_at_the_serve_heads(cuda_device,
                                                           shards, ragged):
    """Yi-9B's heads (32 / 4 × 128, bf16) at B=4, S=4096: the static
    split (K split and K merge launches, no slice copied) against the
    unsharded kernel and the plain version; a ragged kv_len of 17-64
    leaves shards 2.. wholly masked."""
    from repro_torch.kernels.decode_attn import sharded as tdsharded
    b, s, hkv, g, dh = 4, 4096, 4, 8, 128
    q, k, v = _decode_case(cuda_device, torch.bfloat16, b, s, hkv, g, dh,
                           shards + ragged)
    kv_len = (torch.tensor([17, 64, 40, 33], device=cuda_device) if ragged
              else torch.full((b,), s, device=cuda_device))
    n = (dkernel.SPLIT.launches, dkernel.MERGE.launches)
    got, lse = tdsharded.decode_attn_sharded(q, k, v, kv_len=kv_len,
                                             shards=shards, with_lse=True)
    assert (dkernel.SPLIT.launches, dkernel.MERGE.launches) == (
        n[0] + shards, n[1] + shards)
    one, one_lse = tdops.decode_attn(q, k, v, kv_len=kv_len, with_lse=True)
    ro, rl = tdsharded.decode_attn_sharded(q, k, v, kv_len=kv_len,
                                           shards=shards, mode="ref",
                                           with_lse=True)
    assert torch.isfinite(got.float()).all()
    for want, want_lse in ((one, one_lse), (ro, rl)):
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=BF16_RTOL, atol=1e-3)
        torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_engine_serves_sharded_as_unsharded_on_the_card(cuda_device):
    """Reduced Yi-9B (f32) served at shards=2 through the static split on
    one card: the shards=1 greedy tokens, every step through the split
    kernel twice a layer."""
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = dataclasses.replace(reduced(get_config("yi-9b")),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda_device)
    gen = torch.Generator().manual_seed(0)
    prompts = {uid: torch.randint(0, cfg.vocab_size, (3 + uid,),
                                  generator=gen).numpy() for uid in range(4)}

    def run(shards):
        eng = ServingEngine(model, params, ServeConfig(
            slots=2, max_len=64, max_new_tokens=6, shards=shards))
        for uid, p in prompts.items():
            eng.submit(uid, p)
        n = dkernel.SPLIT.launches
        out = eng.run()
        steps = eng.stats()["decode_steps"] + eng.stats()["prefill_steps"]
        assert dkernel.SPLIT.launches - n == shards * cfg.n_layers * steps
        return out
    one = run(1)
    assert run(2) == one and all(len(t) == 6 for t in one.values())


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
    adamw kernel once per parameter dtype (every tensor in one launch)."""
    from repro_torch.launch import train
    before = (rkernel.RMSNORM.launches, akernel.ADAMW.launches)
    state = train.main(["--device", str(cuda_device), "--steps", "2",
                        "--batch", "2", "--seq", "16", "--log-every", "1",
                        "--ckpt-dir", str(tmp_path)])
    n_layers = 2
    groups = len({p.dtype for p in state["params"].parameters()})
    assert rkernel.RMSNORM.launches - before[0] == 2 * (4 * n_layers + 1)
    assert akernel.ADAMW.launches - before[1] == 2 * groups
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
    """The f32 K1 kernels on the flat walk (D = 16: sixteen segments, D
    blocks a step): copy, triad and init through their ops equal their
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
    """The 16-bit K1 kernels (16 bytes, 8 elements, a thread a vector):
    copy, triad and init equal their plain versions bit for bit.  384
    and 640 columns are 3 and 5 sub-portions, so a segment is not whole
    steps at P = 2 and 3; D=16 is sixteen segments."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES)
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("m,n", [(200, 1000), (37, 4100)])
def test_stream_walk_kernels_equal_plain_bits(cuda_device, dtype, arr, d, p,
                                              m, n):
    """copy, triad and init on the flat walk equal their plain versions
    bit for bit in f32, bf16 and f16 at ragged sizes (rows padded to D
    segments, columns to whole sub-portions), at every D and P, in both
    arrangements, one launch each."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + d * 8 + p)
    x, c = (_rand(gen, (m, n), cuda_device, dtype) for _ in range(2))
    cfg = TConfig(d, p, arrangement=arr)
    kernels = (skernel.COPY, skernel.TRIAD, skernel.INIT)
    before = [k.launches for k in kernels]
    y = tsops.stream_copy(x, config=cfg)
    a = run_spec(tsspecs.triad_spec, (x, c, ALPHA), cfg)
    f = tsops.stream_init((m, n), -0.7, dtype, config=cfg,
                          device=cuda_device)
    assert [k.launches for k in kernels] == [b + 1 for b in before]
    assert torch.equal(y, x)
    assert torch.equal(a, run_spec(tsspecs.triad_spec, (x, c, ALPHA), cfg,
                                   mode="ref"))
    assert torch.equal(f, torch.full((m, n), -0.7, device=cuda_device,
                                     dtype=dtype))


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


# ZeRO-3 shards of Yi-9B's matrices at data = 2 and 4 (the sharding
# rules cut wq, wk, wv, w_in, w_gate by rows and wo, w_out by columns),
# and d_model 66 at data = 4: pieces of 17 rows, the last with 2 pad rows
ZERO_SHARDS = [(2048, 4096), (2048, 512), (2048, 11008), (4096, 2048),
               (11008, 2048), (1024, 4096), (1024, 512), (1024, 11008),
               (4096, 1024), (11008, 1024), (17, 64), (64, 17)]


def _many_inputs(gen, shapes, dev, pdt, gdt):
    ps, gs, ms, vs = [], [], [], []
    for s in shapes:
        ps.append(_rand(gen, s, dev, pdt))
        gs.append(_rand(gen, s, dev, gdt))
        ms.append(_rand(gen, s, dev, torch.float32))
        vs.append(torch.rand(*s, generator=gen, device=dev))
    return ps, gs, ms, vs


def _many_equal_plain(ps, gs, ms, vs, wds, gscale, cfg=None):
    """Run adamw_update_many on the card and its plain version on clones:
    one launch, in place, p, m and v equal bit for bit."""
    ref = [[t.clone() for t in x] for x in (ps, gs, ms, vs)]
    ptrs = [t.data_ptr() for t in ps + ms + vs]
    s7 = torch.stack(taops.scalars(ps[0].device, *_HYPER.values()))
    before = akernel.ADAMW.launches
    taops.adamw_update_many(ps, gs, ms, vs, wds, s7, gscale=gscale,
                            config=cfg)
    launches = akernel.ADAMW.launches - before
    taops.adamw_update_many(*ref, wds, s7, gscale=gscale, mode="ref")
    assert [t.data_ptr() for t in ps + ms + vs] == ptrs
    for got, want in zip(ps + ms + vs, ref[0] + ref[2] + ref[3]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    return launches


# tiny, ragged and [H] leaves: 1, 3, 4, 5 elements, 513, 1000 (neither a
# whole vector in bf16 nor a whole unit), Mamba-2's [80], a 64 x 64
MANY_LEAVES = [(1,), (3,), (2, 2), (5,), (513,), (10, 100), (80,),
               (64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("pdt,gdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float16, torch.float16),
                                     (torch.float16, torch.float32)])
@pytest.mark.parametrize("arr", ["grouped", "interleaved"])
@pytest.mark.parametrize("d,p", [(1, 1), (2, 2), (4, 1), (8, 4)])
@pytest.mark.parametrize("scaled", [False, True])
def test_adamw_many_ragged_leaves_equal_plain(cuda_device, pdt, gdt, arr, d,
                                              p, scaled):
    """adamw_update_many over tiny, ragged and [H] leaves with a weight
    decay per leaf, with and without the clip scale: one launch, in
    place, p, m and v equal to the plain version bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * 10 + p)
    leaves = _many_inputs(gen, MANY_LEAVES, cuda_device, pdt, gdt)
    wds = [0.1 * (i % 3) for i in range(len(MANY_LEAVES))]
    gscale = torch.tensor(0.4321, device=cuda_device) if scaled else None
    assert _many_equal_plain(*leaves, wds, gscale,
                             TConfig(d, p, arrangement=arr)) == 1


@pytest.mark.gpu
def test_adamw_many_on_yi9b_one_card_leaves_equal_plain(cuda_device):
    """The one-card train step's 75 leaves of Yi-9B (8 layers), at
    reduced width, as the optimizer passes them: one launch, the clip
    scale fused, each leaf's weight decay by the JAX rule."""
    from repro_torch.models.lm import build_model
    from repro_torch.train import optimizer as topt
    cfg = dataclasses.replace(reduced(get_config("yi-9b")), n_layers=8)
    params = dict(build_model(cfg).init(seed=0, device=cuda_device,
                                        trainable=True).named_parameters())
    assert len(params) == 75
    gen = torch.Generator(device=cuda_device).manual_seed(75)
    ps = [p.detach() for p in params.values()]
    gs = [_rand(gen, p.shape, cuda_device, p.dtype) for p in ps]
    ms = [_rand(gen, p.shape, cuda_device, torch.float32) for p in ps]
    vs = [torch.rand(*p.shape, generator=gen, device=cuda_device)
          for p in ps]
    wds = [0.1 if topt.decays(k, p) else 0.0 for k, p in params.items()]
    for gscale in (None, torch.tensor(0.25, device=cuda_device)):
        assert _many_equal_plain(ps, gs, ms, vs, wds, gscale) == 1


@pytest.mark.gpu
def test_adamw_many_splits_a_list_longer_than_one_table(cuda_device):
    """1100 leaves: three launches (512, 512, 76 leaves a table), every
    leaf equal to the plain version."""
    assert cuda.library("adamw").adamw_table_max() == akernel.TABLE_MAX
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    shapes = [((i * 37) % 300 + 1,) for i in range(1100)]
    leaves = _many_inputs(gen, shapes, cuda_device, torch.float32,
                          torch.float32)
    assert _many_equal_plain(*leaves, None, None) == 3


@pytest.mark.gpu
def test_adamw_many_refuses_unaligned_or_strided_leaves(cuda_device):
    """A leaf that is not contiguous or not 16-byte aligned makes the op
    raise before any launch: there is no copying fallback."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    ps, gs, ms, vs = _many_inputs(gen, [(64, 64), (80,)], cuda_device,
                                  torch.float32, torch.float32)
    s7 = torch.stack(taops.scalars(cuda_device, *_HYPER.values()))
    before = akernel.ADAMW.launches
    with pytest.raises(ValueError, match="contiguous"):
        taops.adamw_update_many([ps[0].t()], gs[:1], ms[:1], vs[:1], None,
                                s7)
    off = torch.zeros(84, device=cuda_device)[1:81]
    with pytest.raises(ValueError, match="16-byte aligned"):
        taops.adamw_update_many([ps[1]], [gs[1]], [off], [vs[1]], None, s7)
    assert akernel.ADAMW.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ZERO_SHARDS)
def test_adamw_kernel_at_zero3_shard_shapes_matches_plain(cuda_device,
                                                          shape):
    """The sharded train step runs the K1 adamw kernel on each rank's
    contiguous shard: at every shard shape it launches once and equals
    its plain version bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(shape[0])
    args = _adamw_inputs(gen, shape, cuda_device, torch.float32)
    kw = dict(zip(_HYPER, taops.scalars(cuda_device, *_HYPER.values())))
    before = akernel.ADAMW.launches
    got = taops.adamw_update(*args, **kw)
    assert akernel.ADAMW.launches == before + 1
    _adamw_equal(got, taops.adamw_update(*args, mode="ref", **kw),
                 torch.float32)


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


# ------------------------------------------ config resolution on the card

@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    from repro_torch.kernels import common
    from repro_torch.registry import tunecache
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    tunecache.reset_default_cache()
    common.reset_plan_memo()
    yield tunecache.default_cache()
    tunecache.reset_default_cache()
    common.reset_plan_memo()


def _leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


@pytest.mark.gpu
def test_cuda_event_tune_hits_the_cache_and_resolves_tuned(cuda_device,
                                                          fresh_cache):
    """A tune on the card (CUDA events, inputs rotated past L2, outputs
    held): trials measured, the launched sources in its provenance; a
    re-tune from the cache launches nothing; the op with no config runs
    the tuned config, equal to its plain version."""
    from repro_torch import obs
    from repro_torch.registry import autotune
    sizes = {"rows": 1024, "cols": 1024}
    res = autotune.tune("stream_copy", sizes, device=cuda_device, iters=3,
                        warmup=1, max_candidates=3)
    assert not res.from_cache and res.trials and res.mode == "cuda"
    assert all(s > 0 for _, s in res.trials)
    entry = fresh_cache.lookup(res.key)
    assert entry["provenance"]["sources"] == {
        "stream": cuda.source_hash("stream")}
    before = {n: k.launches for n, k in cuda.KERNELS.items()}
    again = autotune.tune("stream_copy", sizes, device=cuda_device)
    assert again.from_cache and again.config == res.config
    assert {n: k.launches for n, k in cuda.KERNELS.items()} == before
    x = torch.randn(1024, 1024, device=cuda_device)
    with obs.collect() as col:
        got = tsops.stream_copy(x)
    ev = col.named("kernel.resolve")[0].attrs
    assert ev["source"] == "tuned"
    assert (ev["d"], ev["p"], ev["block_rows"]) == (
        res.config.stride_unroll, res.config.portion_unroll,
        res.config.block_rows)
    assert torch.equal(got, x)


@pytest.mark.gpu
@pytest.mark.parametrize("name", tregistry.names())
def test_registry_row_at_its_top_two_card_configs_matches_plain(
        cuda_device, fresh_cache, name):
    """Each row at its default sizes with no config (its resolved
    config) and at the H100 model's two top-ranked configs, against its
    plain version at that config, at the row's rtol / atol."""
    from repro_torch import obs
    from repro_torch.core.planner import rank_configs
    row = tregistry.get(name)
    sizes = dict(row.default_sizes)
    trav = row.traversal(sizes, torch.float32) if row.traversal else None
    ranked = [c for c, _, _ in rank_configs(row.traffic(sizes, torch.float32),
                                            spec=trav)][:2]
    inputs = row.make_inputs(sizes, torch.float32, cuda_device)
    for cfg in [None, *ranked]:
        with obs.collect() as col:
            got = row.run(inputs, cfg, None)
        ev = col.named("kernel.resolve")[0].attrs
        ran = TConfig(ev["d"], ev["p"], block_rows=ev["block_rows"])
        want = row.run(inputs, ran, "ref")
        for g, w in zip(_leaves(got), _leaves(want), strict=True):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.float(), w.float(), rtol=row.rtol,
                                       atol=row.atol)


@pytest.mark.gpu
def test_lower_fault_lands_on_an_alt_config_of_the_row_dot(cuda_device,
                                                           fresh_cache,
                                                           monkeypatch,
                                                           allow_fallback):
    """chip_smoke.py's guard phase, part (c): with ``lower:mxv_gen:1``
    armed, mxv_gen at 4096^2 f32 is served by one alt-config fallback
    within the f32 dot limit of the plain version, the failed config is
    quarantined, and the next call resolves ``quarantine_alt`` and
    launches the row-dot once; no tier runs the plain version."""
    from repro_torch import obs
    from repro_torch.codegen import loopir
    from repro_torch.registry import tunecache
    from repro_torch.runtime import faults
    n = 4096
    gen = torch.Generator(device=cuda_device).manual_seed(25)
    a = torch.randn(n, n, generator=gen, device=cuda_device)
    x = torch.randn(n, generator=gen, device=cuda_device)
    want = tgen.mxv_gen(a, x, mode="ref")
    # n 2^-24 sum|a x|: the worst case of an f32 dot of length n, plus
    # one rounding of each side into the output
    limit = n * 2.0 ** -24 * (a.abs() @ x.abs()) + 2.0 ** -23 * want.abs()

    def plain(*args, **kw):
        raise AssertionError("a tier ran the plain version")
    monkeypatch.setattr(loopir, "evaluate", plain)
    before = mkernel.ROWDOT.launches
    with obs.collect() as col:
        with faults.inject("lower:mxv_gen:1"):
            got = tgen.mxv_gen(a, x)
    assert bool(((got - want).abs() <= limit).all())
    (ev,) = col.named("kernel.fallback")
    assert ev.attrs["tier"] == "alt_config"
    assert mkernel.ROWDOT.launches == before + 1
    qkey = tunecache.cache_key("mxv_gen", a.shape, a.dtype, cuda_device,
                               "cuda")
    (rec,) = tunecache.default_cache().quarantined(qkey).values()
    assert (rec["d"], rec["p"], rec["reason"]) == (
        ev.attrs["failed_d"], ev.attrs["failed_p"], "injected")
    with obs.collect() as col:
        again = tgen.mxv_gen(a, x)
    (res,) = col.named("kernel.resolve")
    assert res.attrs["source"] == "quarantine_alt"
    assert mkernel.ROWDOT.launches == before + 2
    assert bool(((again - want).abs() <= limit).all())


# ------------------------------------------------------ prefill on the card

def _prefill_model(dev, compute_dtype="bfloat16"):
    from repro_torch.models.lm import build_model
    cfg = dataclasses.replace(reduced(get_config("yi-9b")),
                              compute_dtype=compute_dtype)
    model = build_model(cfg)
    return model, model.init(seed=7, device=dev)


def _prompt(model, dev, b=3, s=40):
    gen = torch.Generator(device=dev).manual_seed(7)
    return {"tokens": torch.randint(0, model.cfg.vocab_size, (b, s),
                                    generator=gen, device=dev)}


@pytest.mark.gpu
def test_prefill_kernels_match_ref(cuda_device):
    """Prefill with the rmsnorm kernel against ``mode="ref"`` on the same
    weights: the kernel's output differs from the plain version's by at
    most one bf16 ulp (its f32 row sum is taken in another order), which
    after two layers and the head stays within the bf16 tolerance the
    decode tests hold the port to (5e-2)."""
    model, params = _prefill_model(cuda_device)
    batch = _prompt(model, cuda_device)
    lk, ck = model.prefill(params, batch, max_len=48)
    lr, cr = model.prefill(params, batch, max_len=48, mode="ref")
    torch.testing.assert_close(lk.float(), lr.float(), rtol=5e-2,
                               atol=5e-2)
    for got, want in zip(ck, cr):
        for n in ("k", "v"):
            torch.testing.assert_close(got[n].float(), want[n].float(),
                                       rtol=5e-2, atol=5e-2)
            assert not got[n][:, 40:].any()


@pytest.mark.gpu
def test_prefill_and_decode_launch_counts(cuda_device):
    """2·L+1 rmsnorm launches and no decode launch a prefill call; then
    2·L+1 rmsnorm, L decode_attn and L merge launches a decode step."""
    model, params = _prefill_model(cuda_device)
    n_l = model.cfg.n_layers
    batch = _prompt(model, cuda_device)

    def launches(fn):
        for k in cuda.KERNELS.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {n: k.launches for n, k in cuda.KERNELS.items()
                     if k.launches}

    (logits, cache), counts = launches(
        lambda: model.prefill(params, batch, max_len=48))
    assert counts == {"rmsnorm": 2 * n_l + 1}
    with torch.inference_mode():
        _, counts = launches(lambda: model.decode_step(
            params, logits.argmax(-1, keepdim=True), cache, 40))
    assert counts == {"rmsnorm": 2 * n_l + 1, "decode_attn": n_l,
                      "decode_attn_merge": n_l}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b",
                                  "mamba2-2.7b", "jamba-1.5-large-398b",
                                  "internvl2-2b"])
def test_family_launch_counts_and_ref(cuda_device, arch):
    """The other families at reduced size (bf16): a prefill launches
    rmsnorm for each norm1, norm2 and Mamba-2 gated norm and the final
    norm, no decode kernel; a decode step the same rmsnorms and
    decode_attn and its merge once per attention layer.  Without a MoE
    router (whose near-ties turn on rounding) the logits are the plain
    path's within 5e-2 of their norm."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import blocks
    from repro_torch.models.lm import build_model
    model = build_model(reduced(get_config(arch)))
    params = model.init(seed=0, device=cuda_device)
    cfg = model.cfg
    descs = blocks.stack_descriptors(cfg)
    rms = 1 + sum(1 + (d.ffn != "none") + (d.mixer == "mamba")
                  for d in descs)
    n_attn = sum(d.mixer == "attn" for d in descs)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda_device,
                         generator=gen)
    batch = {"tokens": toks}
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = torch.randn(
            2, cfg.n_prefix_embeds, cfg.d_model, device=cuda_device,
            generator=gen)
    pos = cfg.n_prefix_embeds + 24

    def launches(fn):
        for k in cuda.KERNELS.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {n: k.launches for n, k in cuda.KERNELS.items()
                     if k.launches}

    (logits, cache), counts = launches(
        lambda: model.prefill(params, batch, max_len=pos + 4))
    assert counts == {"rmsnorm": rms}
    step_want = {"rmsnorm": rms}
    if n_attn:
        step_want.update(decode_attn=n_attn, decode_attn_merge=n_attn)
    tok = logits.argmax(-1, keepdim=True)
    with torch.inference_mode():
        (step, _), counts = launches(
            lambda: model.decode_step(params, tok, cache, pos))
    assert counts == step_want
    assert bool(torch.isfinite(logits).all() and torch.isfinite(step).all())
    if cfg.moe is None:
        ref, _ = model.prefill(params, batch, max_len=pos + 4, mode="ref")
        rel = float((logits.float() - ref.float()).norm()
                    / ref.float().norm())
        assert rel <= 5e-2, rel


@pytest.mark.gpu
def test_count_flops_counts_the_f32_scores_of_16bit_operands(cuda_device):
    """In bf16 the scores go through ``torch.bmm(..., out_dtype=float32)``
    (``aten.bmm.dtype``), which ``count_flops`` counts as the f32 path's
    ``aten.bmm``: the two prefills count the same FLOPs, the hand count
    of their matrix products."""
    from repro_torch.roofline import analysis
    counts = {}
    for dt in ("bfloat16", "float32"):
        model, params = _prefill_model(cuda_device, dt)
        batch = _prompt(model, cuda_device, b=2, s=24)
        counts[dt] = analysis.count_flops(model.prefill, params, batch,
                                          max_len=24)
    cfg, b, s = model.cfg, 2, 24
    d, dh, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    per_tok = 2 * d * dh * (hq + 2 * hkv) + 2 * hq * dh * d + 6 * d * f
    want = (cfg.n_layers * (b * s * per_tok + 4 * b * hq * s * s * dh)
            + 2 * b * d * cfg.padded_vocab)
    assert counts["bfloat16"]["flops"] == counts["float32"]["flops"] == want
    assert counts["bfloat16"]["by_op"]["aten.bmm"] == \
        counts["float32"]["by_op"]["aten.bmm"] > 0


@pytest.mark.gpu
def test_build_cell_runs_each_kind_on_the_card(cuda_device):
    from repro_torch.launch import steps
    cfg = reduced(get_config("yi-9b"))
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        shape = dataclasses.replace(steps.get_shape(kind), global_batch=2,
                                    seq_len=32)
        fn, args = steps.build_cell(cfg, shape)
        tokens = args[1] if kind == "decode_32k" else args[1]["tokens"]
        assert tokens.is_cuda
        out = fn(*args)
        torch.cuda.synchronize()
        first = out[1]["loss"] if kind == "train_4k" else out[0]
        assert bool(torch.isfinite(first).all()), kind


# ------------------------------------- whisper and training every family

@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("t", [4, 16, 6000])
def test_rmsnorm_at_whisper_rows_matches_plain(cuda_device, t, d):
    """Whisper-medium's rows of 1024 (bf16): a decode step's 4, the
    decoder prompt's 4 x 4 and the encoder's 4 x 1500 frames."""
    _rms_matches_plain(cuda_device, torch.bfloat16, t, 1024, d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["5-36", "uniform"])
def test_decode_kernel_matches_plain_at_whisper_heads(cuda_device, dtype,
                                                     kind):
    """Whisper-medium's self-attention decode: Hq = Hkv = 16 (g = 1),
    dh = 64, B = 4 over its 448-position text context, kv_len in [5, 36]
    (the prompt of 4 and 32 steps) or anywhere in [1, 448]."""
    b, s, hkv, dh = 4, 448, 16, 64
    q, k, v = _decode_case(cuda_device, dtype, b, s, hkv, 1, dh, seed=448)
    gen = torch.Generator(device=cuda_device).manual_seed(449)
    lo, hi = (5, 37) if kind == "5-36" else (1, s + 1)
    kv_len = torch.randint(lo, hi, (b,), generator=gen, device=cuda_device)
    n = (dkernel.SPLIT.launches, dkernel.MERGE.launches)
    out, lse = tdops.decode_attn(q, k, v, kv_len=kv_len, with_lse=True)
    assert (dkernel.SPLIT.launches, dkernel.MERGE.launches) == (
        n[0] + 1, n[1] + 1)
    ro, rl = tdops.decode_attn(q, k, v, kv_len=kv_len, mode="ref",
                               with_lse=True)
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ro.float(), rtol=rtol, atol=1e-4)
    torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)


def _launch_counts(fn):
    for k in cuda.KERNELS.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: k.launches for n, k in cuda.KERNELS.items()
                 if k.launches}


@pytest.mark.gpu
def test_whisper_launch_counts_and_ref(cuda_device):
    """Whisper at reduced depth (bf16): a prefill launches rmsnorm for
    each encoder layer's norm1 and norm2, enc_norm, each decoder layer's
    norm1, norm_x and norm2 and the final norm, no decode kernel; a
    decode step the decoder's rmsnorms and decode_attn and its merge once
    a layer (cross-attention is plain SDPA).  The logits are the plain
    path's within 5e-2 of their norm."""
    from repro_torch.models.lm import build_model
    cfg = reduced(get_config("whisper-medium"))
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 6),
                                     generator=gen, device=cuda_device),
             "frames": torch.randn(2, cfg.enc_seq, cfg.d_model,
                                   generator=gen, device=cuda_device)}
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
    (logits, cache), counts = _launch_counts(
        lambda: model.prefill(params, batch, max_len=12))
    assert counts == {"rmsnorm": 2 * n_enc + 1 + 3 * n_dec + 1}
    with torch.inference_mode():
        (step, _), counts = _launch_counts(lambda: model.decode_step(
            params, logits.argmax(-1, keepdim=True), cache, 6))
    assert counts == {"rmsnorm": 3 * n_dec + 1, "decode_attn": n_dec,
                      "decode_attn_merge": n_dec}
    assert bool(torch.isfinite(logits).all() and torch.isfinite(step).all())
    ref, ref_cache = model.prefill(params, batch, max_len=12, mode="ref")
    rel = float((logits.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 5e-2, rel
    with torch.inference_mode():
        rstep, _ = model.decode_step(params, logits.argmax(-1, keepdim=True),
                                     ref_cache, 6, mode="ref")
    rel = float((step.float() - rstep.float()).norm() / rstep.float().norm())
    assert rel <= 5e-2, rel


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b",
                                  "mamba2-2.7b", "jamba-1.5-large-398b",
                                  "internvl2-2b", "whisper-medium"])
def test_family_train_step_matches_ref(cuda_device, arch):
    """One train step of each non-dense family at reduced size, f32
    compute (no MoE router near-tie turns on bf16 rounding), with the
    kernels and with mode="ref" from the same seed: rmsnorm launched
    twice per layer norm (remat) plus the final norm and enc_norm,
    adamw_update once per parameter dtype (every tensor in one launch);
    the loss and grad norm within 1e-5
    relative, every parameter within 0.1 lr of the plain step's and all
    but 0.1% of each tensor's entries within 1e-3 lr (an entry whose
    clipped gradient is near AdamW's eps swings with its last bits)."""
    from repro_torch.models.lm import build_model, norm_calls
    from repro_torch.train import optimizer as topt
    from repro_torch.train import trainstep
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 17),
                                     generator=gen, device=cuda_device)}
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = torch.randn(
            2, cfg.n_prefix_embeds, cfg.d_model, generator=gen,
            device=cuda_device)
    if cfg.encdec:
        batch["frames"] = torch.randn(2, cfg.enc_seq, cfg.d_model,
                                      generator=gen, device=cuda_device)
    ocfg = topt.AdamWConfig(lr=3e-3, warmup_steps=1)
    runs = {}
    for mode in (None, "ref"):
        state = trainstep.init_state(model, seed=0, device=cuda_device)
        step = trainstep.make_train_step(model, ocfg, mode=mode)
        (state, m), counts = _launch_counts(lambda: step(state, batch))
        runs[mode] = (m, dict(state["params"].named_parameters()), counts)
    (mk, pk, ck), (mr, pr, cr) = runs[None], runs["ref"]
    norms = norm_calls(model.init(seed=0, device="meta"))
    # remat runs each layer's norms twice; the final norm and enc_norm once
    assert ck == {"rmsnorm": 2 * norms - 1 - cfg.encdec,
                  "adamw_update": len({p.dtype for p in pk.values()})}
    assert cr == {}
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(mk[k], mr[k], rtol=1e-5, atol=0)
    lr = float(mr["lr"])
    for name, p in pk.items():
        d = (p.detach() - pr[name].detach()).abs()
        assert float(d.max()) <= 0.1 * lr, (name, float(d.max()) / lr)
        assert int((d > 1e-3 * lr).sum()) <= max(1, 1e-3 * d.numel()), name
