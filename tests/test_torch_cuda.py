"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 outputs atol = rtol = 1e-4 (summation order); bf16 outputs
atol = rtol = 1.6e-2 (one bf16 rounding of the f32 result may land on
either side).  The packer (K6) has none: its payload and scales must be
byte-identical to its plain version's.
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


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,kind,act,trans_b,bias", [
    (2, 96, 136, "linear", None, False, False),
    (37, 129, 100, "gated", "silu", True, True),
    (32, 3072, 64, "residual", None, False, False),
])
def test_mpgemm_int8_kernel_matches_plain(gen, out_dtype, m, k, n, kind, act,
                                          trans_b, bias):
    """K1's int8 variant: an exact int32 sum, then the device scale."""
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_plain

    def q(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    a, b = q(m, k), q(*((n, k) if trans_b else (k, n)))
    scale = torch.rand((), generator=gen, device="cuda") * 1e-4
    bi = torch.randn(n, generator=gen, device="cuda") if bias else None
    extras = () if kind == "linear" else (
        torch.randn(m, n, generator=gen, device="cuda").to(out_dtype),)
    ep = EpilogueSpec(kind=kind, activation=act)
    before = mpgemm.launches
    got = mpgemm(a, b, bias=bi, scale=scale, extras=extras,
                 spec=GemmSpec(trans_b=trans_b), epilogue=ep,
                 out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert mpgemm.launches == before + 1
    want = mpgemm_plain(a, b, bias=bi, scale=scale, extras=extras,
                        trans_b=trans_b, epilogue=ep, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[out_dtype])


PACK_SHAPES = [  # (source shape, blocks, trans_w)
    ((100, 70), (32, 32), False),
    ((48, 101), (17, 16), True),
    ((300, 260), (128, 128), False),
    ((129, 33), (33, 128), False),
]


def _bytes(t):
    return t.contiguous().view(torch.uint8).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4",
                                   "fp8e4m3"])
@pytest.mark.parametrize("shape,blocks,trans_w", PACK_SHAPES)
def test_pack_kernel_is_byte_identical_to_plain(gen, src_dtype, dtype, shape,
                                                blocks, trans_w):
    """K6 against its plain version on the card and on the CPU: payload and
    scales byte for byte (no tolerance)."""
    from repro_torch.packing.pack import pack_operand, pack_reference

    w = (torch.randn(*shape, generator=gen, device="cuda") * 0.05).to(
        src_dtype)
    w[-1, -1] = 0.37
    before = pack_operand.launches
    got = pack_operand(w, blocks, trans_w=trans_w, dtype=dtype)
    torch.cuda.synchronize()
    assert pack_operand.launches == before + 1
    for want in (pack_reference(w, got.layout),
                 pack_reference(w.cpu(), got.layout)):
        assert got.payload.dtype == want[0].dtype
        assert torch.equal(_bytes(got.payload), _bytes(want[0]))
        if want[1] is None:
            assert got.scales is None
        else:
            assert torch.equal(_bytes(got.scales), _bytes(want[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("a_dtype,payload", [
    (torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"),
    (torch.bfloat16, "int4"), (torch.bfloat16, "fp8e4m3"),
    (torch.float32, "float32"), (torch.float32, "int4"),
    (torch.int8, "int8"), (torch.int8, "int4"),
])
@pytest.mark.parametrize("kind,act,blocks", [
    ("linear", None, (128, 64)), ("gated", "silu", (33, 16)),
    ("residual", "gelu", (64, 128)),
])
def test_mpgemm_packed_kernel_matches_plain(gen, m, a_dtype, payload, kind,
                                            act, blocks):
    """K2 against its plain version: K = 300 (a K tail), N = 200 (ragged
    column tiles), an odd bk for int4's dangling nibble."""
    from repro_torch.core.gemm_spec import EpilogueSpec
    from repro_torch.kernels.mpgemm import mpgemm_packed, \
        mpgemm_packed_plain
    from repro_torch.packing.pack import pack_operand

    k, n = 300, 200
    out_dtype = torch.float32 if a_dtype == torch.float32 else torch.bfloat16
    w = torch.randn(k, n, generator=gen, device="cuda") * 0.05
    b = pack_operand(w, blocks, dtype=payload)
    scale = None
    if a_dtype == torch.int8:
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        scale = torch.full((), 0.01, device="cuda")
    else:
        a = torch.randn(m, k, generator=gen, device="cuda").to(a_dtype)
    bi = torch.randn(n, generator=gen, device="cuda")
    extras = () if kind == "linear" else (
        torch.randn(m, n, generator=gen, device="cuda").to(out_dtype),)
    ep = EpilogueSpec(kind=kind, activation=act)
    kw = dict(bias=bi, scale=scale, extras=extras, epilogue=ep,
              out_dtype=out_dtype)
    before = mpgemm_packed.launches
    got = mpgemm_packed(a, b, **kw)
    torch.cuda.synchronize()
    assert mpgemm_packed.launches == before + 1
    want = mpgemm_packed_plain(a, b, **kw)
    assert got.dtype == out_dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), **TOL[out_dtype])


# --- grouped (MoE) variants --------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype,out_dtype", [
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32), (torch.int8, torch.bfloat16),
    (torch.int8, torch.float32),
])
@pytest.mark.parametrize("g,m,k,n,kind,act,trans_b,bias", [
    (32, 2, 1024, 512, "gated", "silu", False, "gn"),
    (32, 32, 512, 1024, "linear", None, False, None),
    (3, 37, 129, 100, "residual", "relu", True, "n"),
    (5, 1, 300, 77, "linear", "gelu", False, "gn"),
])
def test_mpgemm_grouped_kernel_matches_plain(gen, a_dtype, out_dtype, g, m,
                                             k, n, kind, act, trans_b, bias):
    """Grouped K1 (the group on the third grid axis) against its plain
    version; the int8 variant's exact int32 sums make it bit-equal up to
    the output rounding.  Each group equals the 2-D kernel on its own
    slice: bit for bit where both launches sum K in the same slices (the
    scalar design, or wgmma with the same split), else within the
    output's tolerance (the wgmma design splits K by the grid's tile
    count, so G groups and one group may be cut differently)."""
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec
    from repro_torch.kernels.mpgemm import k1_design, k1_split, mpgemm, \
        mpgemm_grouped, mpgemm_grouped_plain

    def rand(*shape):
        if a_dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen,
                                 device="cuda", dtype=torch.int8)
        return torch.randn(*shape, generator=gen, device="cuda").to(a_dtype)

    a = rand(g, m, k)
    b = rand(*((g, n, k) if trans_b else (g, k, n)))
    scale = (torch.full((), 1e-4, device="cuda") if a_dtype == torch.int8
             else None)
    bi = None
    if bias:
        bi = torch.randn(*((g, n) if bias == "gn" else (n,)), generator=gen,
                         device="cuda")
    extras = () if kind == "linear" else (
        torch.randn(g, m, n, generator=gen, device="cuda").to(out_dtype),)
    ep = EpilogueSpec(kind=kind, activation=act)
    kw = dict(bias=bi, scale=scale, extras=extras, epilogue=ep,
              out_dtype=out_dtype)
    before = (mpgemm.launches, mpgemm_grouped.launches)
    got = mpgemm_grouped(a, b, spec=GemmSpec(grouped=True, trans_b=trans_b),
                         **kw)
    torch.cuda.synchronize()
    assert (mpgemm.launches, mpgemm_grouped.launches) == \
        (before[0], before[1] + 1)
    want = mpgemm_grouped_plain(a, b, trans_b=trans_b, **kw)
    assert got.dtype == out_dtype and got.shape == (g, m, n)
    torch.testing.assert_close(got.float(), want.float(), **TOL[out_dtype])
    # Each group equals the 2-D kernel on its own slice.
    for i in (0, g - 1):
        one = mpgemm(a[i].contiguous(), b[i].contiguous(),
                     bias=None if bi is None else (bi[i] if bi.dim() == 2
                                                   else bi),
                     scale=scale, extras=tuple(e[i].contiguous()
                                               for e in extras),
                     spec=GemmSpec(trans_b=trans_b), epilogue=ep,
                     out_dtype=out_dtype)
        if (k1_design(a, b) == "simt"
                or k1_split(m, n, k, g) == k1_split(m, n, k, 1)):
            assert torch.equal(one, got[i])
        else:
            torch.testing.assert_close(one.float(), got[i].float(),
                                       **TOL[out_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 32])
@pytest.mark.parametrize("a_dtype,payload", [
    (torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"),
    (torch.bfloat16, "int4"), (torch.bfloat16, "fp8e4m3"),
    (torch.float32, "float32"), (torch.float32, "int4"),
    (torch.int8, "int8"), (torch.int8, "int4"),
])
@pytest.mark.parametrize("kind,act,blocks,bias", [
    ("gated", "silu", (128, 128), "gn"), ("linear", None, (33, 16), "n"),
    ("residual", "gelu", (64, 128), None),
])
def test_mpgemm_packed_grouped_kernel_matches_plain(gen, m, a_dtype,
                                                    payload, kind, act,
                                                    blocks, bias):
    """Grouped K2 over G = 6 groups: K = 300 (a K tail), N = 200 (ragged
    column tiles), an odd bk for int4's dangling nibble."""
    from repro_torch.core.gemm_spec import EpilogueSpec
    from repro_torch.kernels.mpgemm import (
        mpgemm_packed, mpgemm_packed_grouped, mpgemm_packed_grouped_plain,
    )
    from repro_torch.packing.pack import pack_operand

    g, k, n = 6, 300, 200
    out_dtype = torch.float32 if a_dtype != torch.bfloat16 else \
        torch.bfloat16
    w = torch.randn(g, k, n, generator=gen, device="cuda") * 0.05
    b = pack_operand(w, blocks, dtype=payload)
    assert b.layout.g == g
    scale = None
    if a_dtype == torch.int8:
        a = torch.randint(-127, 128, (g, m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        scale = torch.full((), 0.01, device="cuda")
    else:
        a = torch.randn(g, m, k, generator=gen, device="cuda").to(a_dtype)
    bi = None
    if bias:
        bi = torch.randn(*((g, n) if bias == "gn" else (n,)), generator=gen,
                         device="cuda")
    extras = () if kind == "linear" else (
        torch.randn(g, m, n, generator=gen, device="cuda").to(out_dtype),)
    ep = EpilogueSpec(kind=kind, activation=act)
    kw = dict(bias=bi, scale=scale, extras=extras, epilogue=ep,
              out_dtype=out_dtype)
    before = (mpgemm_packed.launches, mpgemm_packed_grouped.launches)
    got = mpgemm_packed_grouped(a, b, **kw)
    torch.cuda.synchronize()
    assert (mpgemm_packed.launches, mpgemm_packed_grouped.launches) == \
        (before[0], before[1] + 1)
    want = mpgemm_packed_grouped_plain(a, b, **kw)
    assert got.dtype == out_dtype and got.shape == (g, m, n)
    torch.testing.assert_close(got.float(), want.float(), **TOL[out_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4",
                                   "fp8e4m3"])
@pytest.mark.parametrize("shape,blocks,trans_w", [
    ((3, 100, 70), (32, 32), False),
    ((4, 48, 101), (17, 16), True),
    ((32, 1024, 512), (128, 128), False),
])
def test_pack_kernel_grouped_is_byte_identical_to_plain(gen, src_dtype, dtype,
                                                        shape, blocks,
                                                        trans_w):
    """Grouped K6: one launch packs the whole stack, byte-equal to the
    plain version on the card and on the CPU."""
    from repro_torch.packing.pack import pack_operand, pack_reference

    w = (torch.randn(*shape, generator=gen, device="cuda") * 0.05).to(
        src_dtype)
    w[-1, -1, -1] = 0.37
    before = pack_operand.launches
    got = pack_operand(w, blocks, trans_w=trans_w, dtype=dtype)
    torch.cuda.synchronize()
    assert pack_operand.launches == before + 1
    assert got.layout.g == shape[0]
    for want in (pack_reference(w, got.layout),
                 pack_reference(w.cpu(), got.layout)):
        assert got.payload.dtype == want[0].dtype
        assert torch.equal(_bytes(got.payload), _bytes(want[0]))
        if want[1] is None:
            assert got.scales is None
        else:
            assert torch.equal(_bytes(got.scales), _bytes(want[1]))


# K4: flash attention over dense K/V.  Shapes of the ported models: whisper
# (D 64, MHA, non-causal encoder, 1500 frames: not a multiple of the
# kernel's 32-key chunk), phi3 (D 96), granite (D 64, GQA 2), danube3 (D
# 120, GQA 4, a window shorter than tk), decode-time cross-attention (tq =
# 1), tq < tk under causal (right-aligned), and the kernel's widest D.
K4_CASES = [
    # b, h, hkv, tq, tk, d, causal, window
    (2, 4, 4, 77, 77, 64, False, None),
    (1, 4, 4, 1, 1500, 64, False, None),
    (2, 4, 4, 32, 1500, 64, False, None),
    (2, 8, 8, 40, 40, 96, True, None),
    (2, 8, 4, 33, 33, 64, True, None),
    (2, 8, 2, 20, 150, 120, True, 37),
    (1, 8, 2, 1, 90, 120, True, 16),
    (1, 4, 1, 5, 9, 256, True, None),
    (3, 6, 3, 64, 64, 24, False, 10),
    (2, 4, 2, 7, 45, 20, True, None),      # bf16 rows of 40 bytes: scalar
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal,window", K4_CASES)
def test_flash_attention_kernel_matches_plain(gen, dtype, b, h, hkv, tq, tk,
                                              d, causal, window):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain,
    )

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rand(b, h, tq, d), rand(b, hkv, tk, d), rand(b, hkv, tk, d)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_takes_unaligned_kv(gen, dtype):
    """K/V that start one element into their storage are not 16-byte
    aligned: the kernel loads them element by element."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain,
    )

    shape = (2, 4, 70, 64)
    n = 2 * 4 * 70 * 64
    q = torch.randn(2, 8, 3, 64, generator=gen, device="cuda").to(dtype)
    k = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)[1:]
    v = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)[1:]
    k, v = k.view(shape), v.view(shape)
    assert k.is_contiguous() and k.data_ptr() % 16 != 0
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_kernel_fully_masked_rows_are_finite(gen):
    """tq > tk under causal leaves the first rows without a key: finite
    there, equal to the plain version on every row that sees a key."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain,
    )

    q = torch.randn(1, 2, 40, 64, generator=gen, device="cuda")
    k = torch.randn(1, 2, 8, 64, generator=gen, device="cuda")
    v = torch.randn(1, 2, 8, 64, generator=gen, device="cuda")
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    sees = 32                          # rows t >= tq - tk see key 0
    torch.testing.assert_close(got[:, :, sees:], want[:, :, sees:],
                               **TOL[torch.float32])


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take(gen):
    from repro_torch.kernels.flash_attention import flash_attention

    half = torch.ones(1, 2, 4, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        flash_attention(half, half, half)
    wide = torch.ones(1, 2, 4, 264, device="cuda")
    with pytest.raises(NotImplementedError):
        flash_attention(wide, wide, wide)
    q = torch.ones(1, 64, 4, 32, device="cuda")
    kv = torch.ones(1, 1, 4, 32, device="cuda")
    with pytest.raises(NotImplementedError):            # group of 64
        flash_attention(q, kv, kv)
    strided = torch.ones(1, 4, 2, 32, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(strided, strided, strided)


# --- K3: tile-sparse B -------------------------------------------------------

def _sparse_operand(gen, shape, blocks, dtype, mask):
    """A tile-sparse operand built on the card (K6 packs it) from a random
    keep-mask: column tile 1 empty, the K- and N-tail tile stored; or no
    tile at all (``mask == "empty"``)."""
    import numpy as np

    from repro_torch.sparse import sparsify_with_mask

    *lead, k, n = shape
    lattice = (*lead, -(-k // blocks[0]), -(-n // blocks[1]))
    keep = np.random.default_rng(0).random(lattice) < 0.5
    keep[..., 1] = False
    keep[..., -1, -1] = True
    if mask == "empty":
        keep[...] = False
    w = torch.randn(*shape, generator=gen, device="cuda") * 0.05
    return sparsify_with_mask(w, blocks, keep, dtype=dtype)


def _sparse_a(gen, shape, dtype):
    if dtype == "int8":
        a = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8)
        return a, torch.full((), 0.01, device="cuda")
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return torch.randn(*shape, generator=gen, device="cuda").to(dt), None


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k,n,blocks,kind,act,mask", [
    (300, 200, (128, 64), "linear", None, "half"),     # K and N tails
    (256, 96, (64, 48), "gated", "silu", "half"),      # bn not 32-aligned
    (130, 70, (32, 32), "residual", "gelu", "empty"),  # no stored tile
])
def test_mpgemm_sparse_kernel_matches_plain(gen, m, dtype, k, n, blocks,
                                            kind, act, mask):
    """K3 against its plain version; an empty column (and an empty
    operand) still gets its epilogue on a zero sum."""
    from repro_torch.core.gemm_spec import EpilogueSpec
    from repro_torch.kernels.mpgemm import mpgemm_sparse, \
        mpgemm_sparse_plain

    b = _sparse_operand(gen, (k, n), blocks, dtype, mask)
    a, scale = _sparse_a(gen, (m, k), dtype)
    out_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    bi = torch.randn(n, generator=gen, device="cuda")
    extras = () if kind == "linear" else (
        torch.randn(m, n, generator=gen, device="cuda").to(out_dtype),)
    ep = EpilogueSpec(kind=kind, activation=act)
    kw = dict(bias=bi, scale=scale, extras=extras, epilogue=ep,
              out_dtype=out_dtype)
    before = mpgemm_sparse.launches
    got = mpgemm_sparse(a, b, **kw)
    torch.cuda.synchronize()
    assert mpgemm_sparse.launches == before + 1
    want = mpgemm_sparse_plain(a, b, **kw)
    assert got.dtype == out_dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), **TOL[out_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("g,k,n,blocks,kind,act,bias", [
    (4, 300, 100, (128, 64), "gated", "silu", "gn"),
    (3, 130, 136, (64, 64), "residual", None, "n"),
    (32, 1024, 512, (128, 128), "linear", None, None),
])
def test_mpgemm_sparse_grouped_kernel_matches_plain(gen, m, dtype, g, k, n,
                                                    blocks, kind, act, bias):
    from repro_torch.core.gemm_spec import EpilogueSpec
    from repro_torch.kernels.mpgemm import mpgemm_sparse_grouped, \
        mpgemm_sparse_plain

    b = _sparse_operand(gen, (g, k, n), blocks, dtype, "half")
    a, scale = _sparse_a(gen, (g, m, k), dtype)
    bi = None if bias is None else torch.randn(
        *((g, n) if bias == "gn" else (n,)), generator=gen, device="cuda")
    extras = () if kind == "linear" else (
        torch.randn(g, m, n, generator=gen, device="cuda"),)
    ep = EpilogueSpec(kind=kind, activation=act)
    kw = dict(bias=bi, scale=scale, extras=extras, epilogue=ep,
              out_dtype=torch.float32)
    before = mpgemm_sparse_grouped.launches
    got = mpgemm_sparse_grouped(a, b, **kw)
    torch.cuda.synchronize()
    assert mpgemm_sparse_grouped.launches == before + 1
    want = mpgemm_sparse_plain(a, b, **kw)
    assert got.shape == (g, m, n)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.cuda
def test_mpgemm_sparse_kernel_refuses_what_it_does_not_take(gen):
    """Payload and index tensors off the card are refused.  Float A against
    an int8 payload, once refused too, is K3's float x int8 variant now:
    it launches and matches its plain version."""
    from repro_torch.kernels.mpgemm import mpgemm_sparse, mpgemm_sparse_plain

    b = _sparse_operand(gen, (64, 64), (32, 32), "int8", "half")
    f = torch.randn(2, 64, generator=gen, device="cuda")
    before = mpgemm_sparse.launches
    got = mpgemm_sparse(f, b)
    torch.cuda.synchronize()
    assert mpgemm_sparse.launches == before + 1
    torch.testing.assert_close(got, mpgemm_sparse_plain(f, b),
                               **TOL[torch.float32])
    a = torch.ones(2, 64, device="cuda", dtype=torch.int8)
    with pytest.raises(ValueError, match="payload"):
        mpgemm_sparse(a, type(b)(b.payload.cpu(), b.scales, b.layout,
                                 b.indptr, b.indices))
    with pytest.raises(ValueError, match="indptr"):
        mpgemm_sparse(a, type(b)(b.payload, b.scales, b.layout,
                                 b.indptr.cpu(), b.indices))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,m,k,n", [
    (None, 1024, 512, 1024), (None, 37, 129, 100), (None, 5, 3, 77),
    (None, 49280 // 64, 64, 96), (3, 40, 17, 24), (4, 64, 1, 33),
])
def test_mpgemm_trans_a_kernel_matches_plain(gen, dtype, out_dtype, g, m, k,
                                             n):
    """K1 with A read as (K, M) (the backward's dW), 2-D and grouped, with
    K tails and M and N off the tiles; deterministic: two launches give the
    same bits."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import (
        mpgemm, mpgemm_grouped, mpgemm_plain,
    )
    lead = () if g is None else (g,)
    a = torch.randn(*lead, k, m, generator=gen, device="cuda").to(dtype)
    b = torch.randn(*lead, k, n, generator=gen, device="cuda").to(dtype)
    spec = GemmSpec(grouped=g is not None, trans_a=True)
    fn = mpgemm_grouped if g is not None else mpgemm
    before = (fn.launches, fn.trans_a_launches)
    got = fn(a, b, spec=spec, out_dtype=out_dtype)
    again = fn(a, b, spec=spec, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert (fn.launches, fn.trans_a_launches) == (before[0] + 2,
                                                  before[1] + 2)
    want = mpgemm_plain(a, b, trans_a=True, out_dtype=out_dtype)
    assert got.shape == (*lead, m, n) and got.dtype == out_dtype
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), **TOL[out_dtype])


@pytest.mark.cuda
def test_mpgemm_trans_a_refuses_what_it_does_not_take(gen):
    """int8 ``trans_a`` and ``trans_a`` with ``trans_b``, once refused, now
    launch K1 and match the plain version (int32 outputs equal); so does
    ``trans_a`` against a packed B, once refused too (K2 on the copied
    Aᵀ)."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import (
        mpgemm, mpgemm_packed, mpgemm_packed_plain, mpgemm_plain,
    )
    from repro_torch.packing.pack import pack_operand
    a = torch.randint(-3, 4, (8, 4), dtype=torch.int8, device="cuda")
    spec = GemmSpec(trans_a=True)
    got = mpgemm(a, a, spec=spec)
    assert got.dtype == torch.int32
    assert torch.equal(got, mpgemm_plain(a, a, trans_a=True))
    f = torch.randn(8, 4, generator=gen, device="cuda")
    spec = GemmSpec(trans_a=True, trans_b=True)
    ft = f.t().contiguous()                # B stored (N, K)
    torch.testing.assert_close(
        mpgemm(f, ft, spec=spec),
        mpgemm_plain(f, ft, trans_a=True, trans_b=True), **TOL[torch.float32])
    p = pack_operand(torch.randn(8, 16, generator=gen, device="cuda"),
                     (8, 8), dtype="float32")
    before = mpgemm_packed.trans_a_launches
    torch.testing.assert_close(
        mpgemm(f, p, spec=GemmSpec(trans_a=True)),
        mpgemm_packed_plain(f, p, trans_a=True), **TOL[torch.float32])
    assert mpgemm_packed.trans_a_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("payload", ["float32", "bfloat16", "int8", "int4",
                                     "fp8e4m3"])
@pytest.mark.parametrize("shape,blocks,trans_w", [
    ((100, 70), (32, 32), False), ((48, 101), (17, 16), True),
    ((3, 40, 24), (16, 8), False), ((2, 30, 52), (15, 16), True),
    ((3072, 8192), (128, 128), False),
])
def test_unpack_kernel_is_bit_equal_to_plain(gen, payload, out, shape,
                                             blocks, trans_w):
    """K7: the dense operand of every payload, 2-D and grouped, both
    orientations, ragged edges -- bit-equal to ``unpack_reference``."""
    from repro_torch.packing import pack as tpack
    w = torch.randn(*shape, generator=gen, device="cuda") * 0.3
    p = tpack.pack_operand(w, blocks, trans_w=trans_w, dtype=payload)
    before = tpack.unpack_operand.launches
    got = tpack.unpack_operand(p, dtype=out)
    torch.cuda.synchronize()
    assert tpack.unpack_operand.launches == before + 1
    want = tpack.unpack_reference(p.payload, p.scales, p.layout, out)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("weight", ["dense", "packed_bf16", "packed_int4"])
def test_mp_dot_backward_on_the_card_matches_the_cpu(gen, policy, weight):
    """One full ``mp_dot`` forward and backward on the card (K1, K1
    trans_b and trans_a, K7 and K6 for a packed weight) against the same
    step on CPU copies (the plain versions), with a gated epilogue and a
    bias; the gradients' tolerance is the bf16 one under bf16 and int8."""
    from repro_torch.core.gemm import mp_dot
    from repro_torch.kernels.mpgemm import mpgemm
    from repro_torch.packing import pack as tpack
    k, n = 384, 520
    xd = torch.float32 if policy == "fp32" else torch.bfloat16
    x = torch.randn(40, k, generator=gen, device="cuda").to(xd)
    w = torch.randn(k, n, generator=gen, device="cuda") * 0.05
    bias = torch.randn(n, generator=gen, device="cuda")
    gate = torch.randn(40, n, generator=gen, device="cuda").to(xd)
    dy = torch.randn(40, n, generator=gen, device="cuda")

    def run(dev):
        # detach: on the card .to() returns the tensor itself, whose
        # requires_grad would stick to the next run.
        xx = x.detach().to(dev).requires_grad_(True)
        bb = bias.detach().to(dev).requires_grad_(True)
        gg = gate.detach().to(dev).requires_grad_(True)
        if weight == "dense":
            ww = w.detach().to(dev).requires_grad_(True)
            leaf = ww
        else:
            ww = tpack.pack_operand(w.to(dev), (128, 128),
                                    dtype={"packed_bf16": "bfloat16",
                                           "packed_int4": "int4"}[weight])
            leaf = ww.payload
            if ww.layout.codec is None:
                leaf.requires_grad_(True)
        y = mp_dot(xx, ww, bb, policy=policy, activation="silu", gate=gg)
        (y.float() * dy.to(dev)).sum().backward()
        return [t.grad for t in (xx, bb, gg, leaf)]

    k1 = (mpgemm.launches, mpgemm.trans_a_launches, mpgemm.trans_b_launches)
    k7 = tpack.unpack_operand.launches
    got = run("cuda")
    torch.cuda.synchronize()
    want = run("cpu")
    tol = TOL[torch.float32 if policy == "fp32" else torch.bfloat16]
    for gk, gp in zip(got, want):
        if gp is None:
            assert gk is None
            continue
        torch.testing.assert_close(gk.float().cpu(), gp.float(), **tol)
    trainable = weight != "packed_int4"
    # K1 in the forward for a dense weight, and for a float payload under
    # int8 (unpacked, K7); in the backward the z recompute, dx (trans_b)
    # and, when trainable, dW (trans_a); a packed weight is unpacked once
    # more for the backward.
    unpacked_fwd = weight == "packed_bf16" and policy == "int8"
    fwd = int(weight == "dense" or unpacked_fwd)
    assert (mpgemm.launches - k1[0], mpgemm.trans_b_launches - k1[2],
            mpgemm.trans_a_launches - k1[1]) == (fwd + 2 + trainable, 1,
                                                 int(trainable))
    assert tpack.unpack_operand.launches - k7 == (
        0 if weight == "dense" else 1 + unpacked_fwd)


# --- the op-level API's variants (K1-K3) -------------------------------------

def _int8(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize("kw", [
    dict(), dict(alpha=2.0, beta=3.0, bias=True), dict(alpha=0.5),
    dict(activation="relu", beta=-1.0), dict(out_dtype=torch.float32,
                                             alpha=2.5, bias=True)],
    ids=["plain", "alpha_beta_bias", "alpha_truncated", "relu_beta",
         "f32_out"])
@pytest.mark.parametrize("m,n,k", [(2, 77, 129), (64, 96, 513),
                                   (133, 40, 17)])
def test_ops_mpgemm_int8_is_bit_equal_to_plain(gen, m, n, k, trans_a,
                                               trans_b, kw):
    """``ops.mpgemm`` of int8 operands: K1's exact int32 sum and integer
    epilogue (alpha, bias and beta truncated to int32), equal to the plain
    version, transposes included."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mpgemm import mpgemm
    kw = dict(kw)
    a = _int8(gen, *((k, m) if trans_a else (m, k)))
    b = _int8(gen, *((n, k) if trans_b else (k, n)))
    c = None
    if kw.get("beta"):
        c = torch.randint(-1000, 1000, (m, n), generator=gen, device="cuda",
                          dtype=torch.int32)
    if kw.pop("bias", False):
        kw["bias"] = torch.randn(n, generator=gen, device="cuda") * 50
    before = mpgemm.launches
    got = ops.mpgemm(a, b, c, trans_a=trans_a, trans_b=trans_b, **kw)
    torch.cuda.synchronize()
    assert mpgemm.launches == before + 1
    want = ops.mpgemm(a.cpu(), b.cpu(), None if c is None else c.cpu(),
                      trans_a=trans_a, trans_b=trans_b,
                      **{k: v.cpu() if torch.is_tensor(v) else v
                         for k, v in kw.items()})
    assert got.dtype == want.dtype
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, True),
                                             (True, False)])
@pytest.mark.parametrize("grouped", [False, True])
def test_mpgemm_beta_c_kernel_matches_plain(gen, dtype, trans_a, trans_b,
                                            grouped):
    """K1's beta·C, 2-D and grouped, with alpha, a bias and gelu; C in the
    output's dtype and, 2-D, in another one."""
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped, \
        mpgemm_plain
    m, n, k = 37, 100, 129
    lead = (3,) if grouped else ()
    a = torch.randn(*lead, *((k, m) if trans_a else (m, k)), generator=gen,
                    device="cuda").to(dtype)
    b = torch.randn(*lead, *((n, k) if trans_b else (k, n)), generator=gen,
                    device="cuda").to(dtype)
    for c_dtype in ((dtype,) if grouped else (dtype, torch.int32)):
        c = (torch.randn(*lead, m, n, generator=gen, device="cuda") * 10
             ).to(c_dtype)
        ep = EpilogueSpec(alpha=1.5, beta=2.0, activation="gelu")
        bias = torch.randn(n, generator=gen, device="cuda")
        spec = GemmSpec(grouped=grouped, trans_a=trans_a, trans_b=trans_b)
        fn = mpgemm_grouped if grouped else mpgemm
        got = fn(a, b, c=c, bias=bias, spec=spec, epilogue=ep)
        want = mpgemm_plain(a, b, c=c, bias=bias, trans_a=trans_a,
                            trans_b=trans_b, epilogue=ep)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("payload", ["bfloat16", "int8", "int4", "fp8e4m3"])
@pytest.mark.parametrize("grouped", [False, True])
def test_mpgemm_packed_beta_c_kernel_matches_plain(gen, payload, grouped):
    from repro_torch.core.gemm_spec import EpilogueSpec
    from repro_torch.kernels.mpgemm import mpgemm_packed, \
        mpgemm_packed_grouped, mpgemm_packed_plain
    from repro_torch.packing.pack import pack_operand
    lead = (4,) if grouped else ()
    w = torch.randn(*lead, 200, 136, generator=gen, device="cuda") * 0.05
    p = pack_operand(w, (64, 64), dtype=payload)
    for m in (2, 33):
        a = torch.randn(*lead, m, 200, generator=gen,
                        device="cuda").to(torch.bfloat16)
        c = torch.randn(*lead, m, 136, generator=gen, device="cuda")
        ep = EpilogueSpec(alpha=0.5, beta=3.0, activation="relu")
        fn = mpgemm_packed_grouped if grouped else mpgemm_packed
        got = fn(a, p, c=c, epilogue=ep, out_dtype=torch.float32)
        want = mpgemm_packed_plain(a, p, c=c, epilogue=ep,
                                   out_dtype=torch.float32)
        torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 33])
@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("grouped", [False, True])
def test_mpgemm_sparse_beta_c_and_float_int8_kernel_matches_plain(
        gen, m, a_dtype, grouped):
    """K3 with beta·C against int8 tiles: int8 A (the exact partials) and
    float A (K3's float x int8 dequant), 2-D and grouped, an empty column
    and a K tail included."""
    from repro_torch.core.gemm_spec import EpilogueSpec
    from repro_torch.kernels.mpgemm import mpgemm_sparse, \
        mpgemm_sparse_grouped, mpgemm_sparse_plain
    lead = (3,) if grouped else ()
    b = _sparse_operand(gen, (*lead, 150, 96), (32, 32), "int8", "half")
    a, scale = _sparse_a(gen, (*lead, m, 150), a_dtype)
    c = torch.randn(*lead, m, 96, generator=gen, device="cuda")
    ep = EpilogueSpec(alpha=2.0, beta=0.5, activation="silu")
    kw = dict(c=c, scale=scale, epilogue=ep, out_dtype=torch.float32)
    fn = mpgemm_sparse_grouped if grouped else mpgemm_sparse
    got = fn(a, b, **kw)
    torch.testing.assert_close(got, mpgemm_sparse_plain(a, b, **kw),
                               **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 37])
@pytest.mark.parametrize("kind,act", [("linear", None), ("residual", "relu")])
@pytest.mark.parametrize("grouped", [False, True])
def test_mpgemm_packed_int8_a_fp8_kernel_matches_plain(gen, m, kind, act,
                                                       grouped):
    """K2's int8 A x fp8 payload (quant_in over an fp8 weight): both sides
    in f32, the tile scale applied to B."""
    from repro_torch.core.gemm_spec import EpilogueSpec
    from repro_torch.kernels.mpgemm import mpgemm_packed, \
        mpgemm_packed_grouped, mpgemm_packed_plain
    from repro_torch.packing.pack import pack_operand
    lead = (2,) if grouped else ()
    w = torch.randn(*lead, 300, 200, generator=gen, device="cuda") * 0.05
    p = pack_operand(w, (128, 64), dtype="fp8e4m3")
    a = _int8(gen, *lead, m, 300)
    extras = () if kind == "linear" else (
        torch.randn(*lead, m, 200, generator=gen, device="cuda"),)
    kw = dict(extras=extras, epilogue=EpilogueSpec(kind=kind, activation=act),
              out_dtype=torch.float32)
    fn = mpgemm_packed_grouped if grouped else mpgemm_packed
    before = fn.launches
    got = fn(a, p, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    torch.testing.assert_close(got, mpgemm_packed_plain(a, p, **kw),
                               **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("weight", ["dense", "packed_int8", "packed_int4",
                                    "packed_fp8", "packed_bf16",
                                    "sparse_int8", "sparse_bf16"])
@pytest.mark.parametrize("tail", ["silu", "residual"])
@pytest.mark.parametrize("grouped", [False, True])
def test_quant_in_on_the_card_matches_the_cpu(gen, weight, tail, grouped):
    """``mp_dot(_grouped)(..., quant_in=True)`` on the card (the quant_in
    tails of K1, K2 and K3, one launch) against the same call on CPU
    copies (the plain versions); bf16 outputs."""
    from repro_torch.core.gemm import mp_dot, mp_dot_grouped
    from repro_torch.kernels import mpgemm as tk
    from repro_torch.packing.pack import pack_operand
    from repro_torch.sparse import sparsify_magnitude
    lead = (4,) if grouped else ()
    k, n, m = 320, 200, 33
    w = torch.randn(*lead, k, n, generator=gen, device="cuda") * 0.05
    kind, fmt = weight.split("_") if "_" in weight else (weight, None)
    fmt = {"fp8": "fp8e4m3", "bf16": "bfloat16"}.get(fmt, fmt)
    if kind == "packed":
        w = pack_operand(w, (64, 64), dtype=fmt)
    elif kind == "sparse":
        w = sparsify_magnitude(w, (64, 64), density=0.5, dtype=fmt)
    x = torch.randn(*lead, m, k, generator=gen, device="cuda").to(
        torch.bfloat16)
    r = torch.randn(*lead, m, n, generator=gen, device="cuda").to(
        torch.bfloat16)
    op = mp_dot_grouped if grouped else mp_dot
    kw = (dict(activation="silu") if tail == "silu" else dict(residual=r))
    counters = (tk.mpgemm_grouped, tk.mpgemm_packed_grouped,
                tk.mpgemm_sparse_grouped) if grouped else (
                    tk.mpgemm, tk.mpgemm_packed, tk.mpgemm_sparse)
    before = sum(f.launches for f in counters)
    got = op(x, w, policy="bf16", quant_in=True, **kw)
    torch.cuda.synchronize()
    assert sum(f.launches for f in counters) == before + 1
    cpu_w = w.to("cpu") if kind != "dense" else w.cpu()
    want = op(x.cpu(), cpu_w, policy="bf16", quant_in=True,
              **{k_: v.cpu() if torch.is_tensor(v) else v
                 for k_, v in kw.items()})
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_ops_flash_attention_on_the_card(gen):
    """``ops.flash_attention`` launches K4 for float operands and raises on
    the card for non-float ones, naming the reason (it never runs the
    plain formula there)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, \
        flash_attention_plain
    q = torch.randn(1, 4, 9, 64, generator=gen, device="cuda")
    k = torch.randn(1, 2, 9, 64, generator=gen, device="cuda")
    before = flash_attention.launches
    got = ops.flash_attention(q, k, k)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got, flash_attention_plain(q, k, k),
                               **TOL[torch.float32])
    with pytest.raises(NotImplementedError, match="non-float q"):
        ops.flash_attention(q.int(), k, k)


@pytest.mark.cuda
def test_mp_einsum_grouped_spec_launches_grouped_k1(gen):
    from repro_torch.core.gemm import mp_einsum
    from repro_torch.kernels.mpgemm import mpgemm_grouped
    a = torch.randn(4, 8, 64, generator=gen, device="cuda")
    b = torch.randn(4, 64, 32, generator=gen, device="cuda")
    before = mpgemm_grouped.launches
    got = mp_einsum("gmk,gkn->gmn", a, b, policy="fp32")
    torch.cuda.synchronize()
    assert mpgemm_grouped.launches == before + 1
    torch.testing.assert_close(got, torch.einsum("gmk,gkn->gmn", a, b),
                               **TOL[torch.float32])


# --- K1's wgmma design (csrc/mpgemm_wgmma.cu) ---------------------------------

def _bf16(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


def _k1_operands(gen, lead, m, n, k, trans_a, trans_b):
    a = _bf16(gen, *lead, *((k, m) if trans_a else (m, k)))
    b = _bf16(gen, *lead, *((n, k) if trans_b else (k, n)), scale=k ** -0.5)
    return a, b


def _run_k1(a, b, spec, **kw):
    """One K1 launch; -> (output, the design it ran)."""
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped
    fn = mpgemm_grouped if spec.grouped else mpgemm
    before = (fn.launches, fn.wgmma_launches)
    out = fn(a, b, spec=spec, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before[0] + 1
    return out, "wgmma" if fn.wgmma_launches > before[1] else "simt"


TRANSPOSES = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("trans_a,trans_b", TRANSPOSES)
@pytest.mark.parametrize("m", [1, 2, 8, 63, 64, 65, 72, 129, 136])
def test_mpgemm_wgmma_kernel_matches_plain(gen, m, trans_a, trans_b):
    """bf16 K1 at M off the 64-row tile and N = 200, K = 136 off BN and BK,
    in all four transposes: the design the rule names runs (wgmma, except
    ``trans_a`` with rows of M values that are no multiple of 8), and it
    matches the plain version."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import k1_design, mpgemm_plain
    n, k = 200, 136
    a, b = _k1_operands(gen, (), m, n, k, trans_a, trans_b)
    got, design = _run_k1(a, b, GemmSpec(trans_a=trans_a, trans_b=trans_b))
    assert design == k1_design(a, b)
    assert design == ("simt" if trans_a and m % 8 else "wgmma")
    want = mpgemm_plain(a, b, trans_a=trans_a, trans_b=trans_b)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("trans_a,trans_b", TRANSPOSES)
@pytest.mark.parametrize("m,k,n", [(2, 1024, 512), (32, 512, 1024),
                                   (40, 200, 136)])
def test_mpgemm_wgmma_grouped_kernel_matches_plain(gen, m, k, n, trans_a,
                                                   trans_b):
    """Grouped bf16 K1 over G = 32 groups (granite's expert count), f32
    outputs: no tile crosses a group, split-K included (M = 2); ``trans_a``
    at M = 2 (rows of 2 values) is the scalar K1's by the rule."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import k1_design, mpgemm_plain
    a, b = _k1_operands(gen, (32,), m, n, k, trans_a, trans_b)
    spec = GemmSpec(grouped=True, trans_a=trans_a, trans_b=trans_b)
    got, design = _run_k1(a, b, spec, out_dtype=torch.float32)
    assert design == k1_design(a, b)
    assert design == ("simt" if trans_a and m % 8 else "wgmma")
    want = mpgemm_plain(a, b, trans_a=trans_a, trans_b=trans_b,
                        out_dtype=torch.float32)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,act", [
    ("linear", "gelu"), ("gated", "silu"), ("residual", None),
    ("quant_in", "silu"), ("quant_in_residual", "relu")])
@pytest.mark.parametrize("m,grouped", [(2, False), (100, False), (2, True)])
def test_mpgemm_wgmma_epilogues_match_plain(gen, kind, act, out_dtype, m,
                                            grouped):
    """Every epilogue kind on the wgmma design, with alpha, a bias and
    beta·C, f32 and bf16 outputs; M = 2 runs split-K (the epilogue in the
    reducing launch), M = 100 one slice."""
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec, \
        get_epilogue
    from repro_torch.kernels.mpgemm import mpgemm_plain
    n, k = 264, 1024
    lead = (4,) if grouped else ()
    a, b = _k1_operands(gen, lead, m, n, k, False, False)
    ed = get_epilogue(kind)
    extras = tuple(
        torch.rand(*lead, m, 1, generator=gen, device="cuda") + 0.5
        if name in ed.row_operands else
        torch.randn(*lead, m, n, generator=gen, device="cuda").to(out_dtype)
        for name in ed.extra_operands)
    c = torch.randn(*lead, m, n, generator=gen, device="cuda").to(out_dtype)
    kw = dict(c=c, bias=torch.randn(n, generator=gen, device="cuda"),
              extras=extras, out_dtype=out_dtype,
              epilogue=EpilogueSpec(kind=kind, activation=act, alpha=1.5,
                                    beta=0.5))
    got, design = _run_k1(a, b, GemmSpec(grouped=grouped), **kw)
    assert design == "wgmma"
    want = mpgemm_plain(a, b, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[out_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["split-k", "trans_a", "grouped-trans_a"])
def test_mpgemm_wgmma_is_deterministic(gen, case):
    """Two launches give the same bits: split-K at phi3's decode shape (the
    slices summed in a fixed order), and ``trans_a`` at training's dW
    shapes (a resumed run must repeat a continuous one)."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import k1_split
    if case == "split-k":
        lead, m, n, k, ta = (), 2, 3072, 3072, False
        assert k1_split(m, n, k)[0] > 1
    elif case == "trans_a":
        lead, m, n, k, ta = (), 1024, 512, 512, True
    else:
        lead, m, n, k, ta = (32,), 1024, 512, 160, True
    a, b = _k1_operands(gen, lead, m, n, k, ta, False)
    spec = GemmSpec(grouped=bool(lead), trans_a=ta)
    first, design = _run_k1(a, b, spec, out_dtype=torch.float32)
    again, _ = _run_k1(a, b, spec, out_dtype=torch.float32)
    assert design == "wgmma"
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_mpgemm_wgmma_rule_sends_misaligned_rows_to_simt(gen):
    """A contiguous view that starts 2 bytes off a 16-byte boundary, and
    rows of 101 values, run the scalar K1 and still match."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import mpgemm_plain
    base = _bf16(gen, 64 * 128 + 1)
    a = base[1:].view(64, 128)               # contiguous, misaligned
    b = _bf16(gen, 128, 96)
    for x, y in ((a, b), (_bf16(gen, 48, 101), _bf16(gen, 101, 40))):
        got, design = _run_k1(x, y, GemmSpec())
        assert design == "simt"
        torch.testing.assert_close(got.float(), mpgemm_plain(x, y).float(),
                                   **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("a_dtype,payload", [
    ("bfloat16", "int4"), ("bfloat16", "bfloat16"), ("int8", "int8"),
    ("int8", "fp8e4m3")])
def test_mpgemm_packed_trans_a_kernel_matches_plain(gen, a_dtype, payload,
                                                    grouped):
    """K2 with A read (K, M): the wrapper copies Aᵀ, the kernel matches
    the plain version's transposed read."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import (
        mpgemm, mpgemm_grouped, mpgemm_packed, mpgemm_packed_grouped,
        mpgemm_packed_plain,
    )
    from repro_torch.packing.pack import pack_operand
    lead = (3,) if grouped else ()
    w = torch.randn(*lead, 200, 136, generator=gen, device="cuda") * 0.05
    p = pack_operand(w, (64, 64), dtype=payload)
    a, scale = _sparse_a(gen, (*lead, 200, 33), a_dtype)
    counter = mpgemm_packed_grouped if grouped else mpgemm_packed
    before = counter.trans_a_launches
    fn = mpgemm_grouped if grouped else mpgemm
    got = fn(a, p, scale=scale, out_dtype=torch.float32,
             spec=GemmSpec(grouped=grouped, trans_a=True))
    torch.cuda.synchronize()
    assert counter.trans_a_launches == before + 1
    want = mpgemm_packed_plain(a, p, scale=scale, out_dtype=torch.float32,
                               trans_a=True)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_mpgemm_sparse_trans_a_kernel_matches_plain(gen, dtype, grouped):
    """K3 with A read (K, M), bf16 and int8 tiles, 2-D and grouped."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import (
        mpgemm, mpgemm_grouped, mpgemm_sparse, mpgemm_sparse_grouped,
        mpgemm_sparse_plain,
    )
    lead = (3,) if grouped else ()
    b = _sparse_operand(gen, (*lead, 150, 96), (32, 32), dtype, "half")
    a, scale = _sparse_a(gen, (*lead, 150, 37), dtype)
    counter = mpgemm_sparse_grouped if grouped else mpgemm_sparse
    before = counter.trans_a_launches
    fn = mpgemm_grouped if grouped else mpgemm
    got = fn(a, b, scale=scale, out_dtype=torch.float32,
             spec=GemmSpec(grouped=grouped, trans_a=True))
    torch.cuda.synchronize()
    assert counter.trans_a_launches == before + 1
    want = mpgemm_sparse_plain(a, b, scale=scale, out_dtype=torch.float32,
                               trans_a=True)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


# --- K1's wgmma design for int8 (csrc/mpgemm_wgmma_int8.cu) ------------------

def _int8(gen, *shape):
    return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_a,trans_b", TRANSPOSES)
@pytest.mark.parametrize("m,n,k", [
    (2, 208, 400), (16, 208, 400), (64, 208, 400), (80, 208, 400),
    (144, 208, 400), (1152, 2048, 320)])
def test_mpgemm_wgmma_int8_is_bit_equal_to_plain(gen, m, n, k, trans_a,
                                                 trans_b):
    """int8 K1 in all four transposes, M off the 64-row tile, N and K off
    BN and BK, split-K (the small grids) and one slice (1152 x 2048): the
    rule's design runs (wgmma, except ``trans_a`` with rows of M values
    that are no multiple of 16), its int32 output is bit-equal to the
    plain version, and a scaled output is within the output's
    tolerance."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import k1_design, mpgemm_plain
    a = _int8(gen, *((k, m) if trans_a else (m, k)))
    b = _int8(gen, *((n, k) if trans_b else (k, n)))
    spec = GemmSpec(trans_a=trans_a, trans_b=trans_b)
    got, design = _run_k1(a, b, spec)
    assert design == k1_design(a, b)
    assert design == ("simt" if trans_a and m % 16 else "wgmma")
    want = mpgemm_plain(a, b, trans_a=trans_a, trans_b=trans_b)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    scale = torch.full((), 2.0 ** -12, device="cuda")
    for out_dtype in (torch.float32, torch.bfloat16):
        got, _ = _run_k1(a, b, spec, scale=scale, out_dtype=out_dtype)
        want = mpgemm_plain(a, b, trans_a=trans_a, trans_b=trans_b,
                            scale=scale, out_dtype=out_dtype)
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[out_dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("trans_a,trans_b", TRANSPOSES)
@pytest.mark.parametrize("m,k,n", [(2, 1024, 512), (32, 512, 1024),
                                   (48, 208, 144)])
def test_mpgemm_wgmma_int8_grouped_is_bit_equal_to_plain(gen, m, k, n,
                                                         trans_a, trans_b):
    """Grouped int8 K1 over G = 32 groups (granite's expert count): int32
    outputs bit-equal to the plain version, split-K included (M = 2);
    ``trans_a`` at M = 2 is the scalar K1's by the rule."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import k1_design, mpgemm_plain
    a = _int8(gen, 32, *((k, m) if trans_a else (m, k)))
    b = _int8(gen, 32, *((n, k) if trans_b else (k, n)))
    spec = GemmSpec(grouped=True, trans_a=trans_a, trans_b=trans_b)
    got, design = _run_k1(a, b, spec)
    assert design == k1_design(a, b)
    assert design == ("simt" if trans_a and m % 16 else "wgmma")
    assert torch.equal(got, mpgemm_plain(a, b, trans_a=trans_a,
                                         trans_b=trans_b))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,act", [
    ("linear", "relu"), ("gated", None), ("residual", "gelu"),
    ("quant_in", "silu")])
@pytest.mark.parametrize("m", [2, 100])
def test_mpgemm_wgmma_int8_epilogues_match_plain(gen, kind, act, m):
    """The integer epilogue on the wgmma design (alpha, a bias and beta·C
    truncated to int32; the int32 output bit-equal; the tanh GELU and the
    quant_in row scale turn it into f32) with split-K (M = 2, the epilogue
    in the reducing block) and without (M = 100)."""
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec, \
        get_epilogue
    from repro_torch.kernels.mpgemm import mpgemm_plain
    n, k = 272, 1024
    a, b = _int8(gen, m, k), _int8(gen, k, n)
    ed = get_epilogue(kind)
    out_dtype = torch.float32 if kind == "quant_in" or act == "gelu" \
        else torch.int32
    extras = tuple(
        torch.rand(m, 1, generator=gen, device="cuda") + 0.5
        if name in ed.row_operands else
        torch.randint(-3, 4, (m, n), generator=gen, device="cuda").to(
            out_dtype)
        for name in ed.extra_operands)
    c = torch.randint(-1000, 1000, (m, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    kw = dict(c=c, bias=torch.randn(n, generator=gen, device="cuda") * 100,
              extras=extras, out_dtype=out_dtype,
              epilogue=EpilogueSpec(kind=kind, activation=act, alpha=2.0,
                                    beta=3.0))
    got, design = _run_k1(a, b, GemmSpec(), **kw)
    assert design == "wgmma"
    want = mpgemm_plain(a, b, **kw)
    if out_dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


# --- K4's wgmma and split designs (csrc/flash_attention_wgmma.cu) ------------

K4_NEW_CASES = [
    # b, h, hkv, tq, tk, d, causal, window: whisper-medium's encoder,
    # cross-attention at prefill (wgmma, split over the keys) and at decode
    # (the split design), phi3-mini's prefill (D 96), a GQA head of 120 with
    # a window, granite's training shape, D 128, a split-design GQA group
    # with a window, 16 folded rows of D 72, fewer keys than a tile, and a
    # window shorter than a tile with tq < tk.
    (2, 16, 16, 1500, 1500, 64, False, None),
    (2, 16, 16, 32, 1500, 64, False, None),
    (2, 16, 16, 1, 1500, 64, False, None),
    (2, 32, 32, 32, 32, 96, True, None),
    (2, 32, 8, 64, 600, 120, True, 256),
    (4, 16, 8, 128, 128, 64, True, None),
    (1, 4, 4, 200, 700, 128, True, 100),
    (1, 8, 2, 1, 90, 120, True, 16),
    (2, 4, 1, 4, 300, 72, False, None),
    (1, 2, 2, 100, 3, 64, False, None),
    (3, 6, 2, 70, 333, 96, True, 20),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal,window", K4_NEW_CASES)
def test_flash_attention_new_designs_match_plain(gen, b, h, hkv, tq, tk, d,
                                                 causal, window):
    """bf16 K4 on the design ``k4_design`` names ("wgmma" above 16 folded
    rows, "split" at most), counted as such, within bf16's tolerance of
    the plain version (P rounded to bf16 in the wgmma design: 2**-9 an
    element), and the same bits from a second launch (the slices over the
    keys combined in slice order)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, k4_design, k4_split,
    )

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v = rand(b, h, tq, d), rand(b, hkv, tk, d), rand(b, hkv, tk, d)
    design = k4_design(q, k, v)
    assert design == ("split" if h // hkv * tq <= 16 else "wgmma")
    counter = f"{design}_launches"
    before = getattr(flash_attention, counter)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert getattr(flash_attention, counter) == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again), k4_split(h // hkv * tq, tk, b, hkv)
