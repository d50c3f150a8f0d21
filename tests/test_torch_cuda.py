"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test here is marked ``gpu`` and skips where no CUDA card is present
(decided in the ``cuda_device`` fixture, never at import).  This file
imports no JAX, so it also runs on a card host without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.codegen import OnlineSoftmax
from repro_torch.core.striding import StridingConfig as TConfig
from repro_torch.kernels.decode_attn import kernel as dkernel
from repro_torch.kernels.decode_attn import ops as tdops
from repro_torch.kernels.rmsnorm import kernel as rkernel
from repro_torch.kernels.rmsnorm import ops as trops

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
    # f32 reassociation: the kernel folds tile by tile and merges D
    # segment states; the plain version sums whole rows
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ro.float(), rtol=rtol, atol=1e-4)
    torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)


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
    q = torch.randn(2, 4, 48, device=cuda_device)     # dh=48 not compiled
    k = torch.randn(2, 64, 2, 48, device=cuda_device)
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
