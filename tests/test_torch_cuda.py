"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 outputs atol = rtol = 1e-4 (summation order); bf16 outputs
atol = rtol = 1.6e-2 (one bf16 rounding of the f32 result may land on
either side).
"""
import pytest

torch = pytest.importorskip("torch")

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1.6e-2, rtol=1.6e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,kind,act,trans_b,bias", [
    (2, 96, 136, "linear", None, False, False),
    (37, 129, 100, "linear", "relu", True, True),
    (5, 200, 77, "residual", "gelu", False, True),
    (64, 300, 260, "gated", "silu", False, False),
    (17, 1, 3, "linear", None, True, False),
])
def test_mpgemm_kernel_matches_plain(gen, dtype, m, k, n, kind, act,
                                     trans_b, bias):
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_plain

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    a = rand(m, k)
    b = rand(*((n, k) if trans_b else (k, n)))
    bi = torch.randn(n, generator=gen, device="cuda") if bias else None
    extras = () if kind == "linear" else (rand(m, n),)
    ep = EpilogueSpec(kind=kind, activation=act)
    before = mpgemm.launches
    got = mpgemm(a, b, bias=bi, extras=extras, spec=GemmSpec(trans_b=trans_b),
                 epilogue=ep)
    torch.cuda.synchronize()
    assert mpgemm.launches == before + 1
    want = mpgemm_plain(a, b, bias=bi, extras=extras, trans_b=trans_b,
                        epilogue=ep)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_mpgemm_kernel_refuses_what_it_does_not_take(gen):
    from repro_torch.kernels.mpgemm import mpgemm

    a = torch.ones(4, 8, device="cuda", dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        mpgemm(a, a.t().contiguous())
    b = torch.ones(16, 8, device="cuda").t()           # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        mpgemm(torch.ones(4, 8, device="cuda"), b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d,tq,window", [
    (4, 2, 24, 1, None), (4, 2, 24, 8, 6), (32, 8, 120, 16, 64),
    (8, 8, 96, 3, None), (64, 2, 256, 1, None),
])
def test_paged_flash_kernel_matches_plain(gen, dtype, h, hkv, d, tq, window):
    from repro_torch.kernels.flash_attention import (
        paged_flash_attention, paged_flash_attention_plain,
    )

    ps, w = 8, 12
    lengths = [tq + 70, max(1, tq - 2), 0]            # ragged, short, idle
    b = len(lengths)
    n_pages = 1 + b * w
    kp = torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda")
    vp = torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda")
    kp[0], vp[0] = float("nan"), float("nan")          # scratch page
    kp, vp = kp.to(dtype), vp.to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros(b, w, dtype=torch.int32, device="cuda")
    for i, ln in enumerate(lengths):
        used = -(-ln // ps)
        bt[i, :used] = perm[i * w:i * w + used].int()
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qs = (ln - tq).clamp_min(0).int()
    q = torch.randn(b, h, tq, d, generator=gen, device="cuda").to(dtype)
    got = paged_flash_attention(q, kp, vp, bt, qs, ln, window=window)
    torch.cuda.synchronize()
    want = paged_flash_attention_plain(q, kp, vp, bt, qs, ln, window=window)
    pos = qs[:, None].long() + torch.arange(tq, device="cuda")
    live = (pos < ln[:, None])[:, None, :, None].expand_as(got)
    torch.testing.assert_close(got.float()[live], want.float()[live],
                               **TOL[dtype])
    assert (got[2] == 0).all()                          # idle request
