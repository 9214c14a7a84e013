"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a card.  On a machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 outputs atol = rtol = 1e-4 (summation order); bf16 outputs
atol = rtol = 1.6e-2 (one bf16 rounding of the f32 result may land on
either side).  The packer (K6) has none: its payload and scales must be
byte-identical to its plain version's.
"""
import functools
import importlib.util
from pathlib import Path

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
    # K6's stream design (``k6_design``) for both source dtypes: ragged
    # edge tiles, an odd bk (int4's last high nibble), narrow tiles,
    # trans_w with ragged tiles on both axes.
    ((300, 256), (128, 128), False),
    ((97, 160), (128, 128), False),
    ((64, 96), (32, 32), False),
    ((264, 1000), (128, 128), True),
    ((48, 80), (16, 48), True),
]


def _bytes(t):
    return t.contiguous().view(torch.uint8).cpu()


def _pack_design_launch(w, blocks, trans_w, dtype):
    """One ``pack_operand`` on the card -> (the packed operand, the design
    ``k6_design`` gives it); the launch counts must have moved by one, the
    stream count by one exactly when the design is "stream"."""
    from repro_torch.packing.pack import _layout_for, k6_design, pack_operand
    design = k6_design(w, _layout_for(w, *blocks, trans_w=trans_w,
                                      dtype=dtype))
    before = (pack_operand.launches, pack_operand.stream_launches)
    got = pack_operand(w, blocks, trans_w=trans_w, dtype=dtype)
    torch.cuda.synchronize()
    assert (pack_operand.launches, pack_operand.stream_launches) == (
        before[0] + 1, before[1] + (design == "stream"))
    return got, design


@pytest.mark.cuda
@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8", "int4",
                                   "fp8e4m3"])
@pytest.mark.parametrize("shape,blocks,trans_w", PACK_SHAPES)
def test_pack_kernel_is_byte_identical_to_plain(gen, src_dtype, dtype, shape,
                                                blocks, trans_w):
    """K6 against its plain version on the card and on the CPU: payload and
    scales byte for byte (no tolerance), whichever design ``k6_design``
    picks; the shapes added for the stream design take it."""
    from repro_torch.packing.pack import pack_reference

    w = (torch.randn(*shape, generator=gen, device="cuda") * 0.05).to(
        src_dtype)
    w[-1, -1] = 0.37
    got, design = _pack_design_launch(w, blocks, trans_w, dtype)
    if PACK_SHAPES.index((shape, blocks, trans_w)) >= 4:
        assert design == "stream", (shape, blocks, trans_w)
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
@pytest.mark.parametrize("shape,blocks,trans_w,design", [
    ((3, 100, 70), (32, 32), False, None),
    ((4, 48, 101), (17, 16), True, None),
    ((32, 1024, 512), (128, 128), False, "stream"),
    ((3, 136, 264), (128, 128), False, "stream"),
    ((2, 264, 136), (128, 128), True, "stream"),
])
def test_pack_kernel_grouped_is_byte_identical_to_plain(gen, src_dtype, dtype,
                                                        shape, blocks,
                                                        trans_w, design):
    """Grouped K6: one launch packs the whole stack, byte-equal to the
    plain version on the card and on the CPU; ``design`` is the one
    ``k6_design`` must give (None: whichever)."""
    from repro_torch.packing.pack import pack_reference

    w = (torch.randn(*shape, generator=gen, device="cuda") * 0.05).to(
        src_dtype)
    w[-1, -1, -1] = 0.37
    got, ran = _pack_design_launch(w, blocks, trans_w, dtype)
    assert design in (None, ran)
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
@pytest.mark.parametrize("shape,blocks,trans_w,design", [
    ((100, 70), (32, 32), False, "simt"),
    ((48, 101), (17, 16), True, "stream"),
    ((3, 40, 24), (16, 8), False, "stream"),
    ((2, 30, 52), (15, 16), True, "simt"),
    ((3072, 8192), (128, 128), False, "stream"),
    # The stream design's edges: ragged tiles on both axes, an odd bk
    # (int4: the last payload row holds one row), a grouped stack.
    ((300, 264), (128, 128), False, "stream"),
    ((97, 160), (128, 128), False, "stream"),
    ((3, 136, 264), (128, 128), False, "stream"),
])
def test_unpack_kernel_is_bit_equal_to_plain(gen, payload, out, shape,
                                             blocks, trans_w, design):
    """K7: the dense operand of every payload, 2-D and grouped, both
    orientations, ragged edges -- bit-equal to ``unpack_reference``, on
    the design ``k7_design`` gives (``design``)."""
    from repro_torch.packing import pack as tpack
    w = torch.randn(*shape, generator=gen, device="cuda") * 0.3
    p = tpack.pack_operand(w, blocks, trans_w=trans_w, dtype=payload)
    assert tpack.k7_design(p, out) == design
    before = (tpack.unpack_operand.launches,
              tpack.unpack_operand.stream_launches)
    got = tpack.unpack_operand(p, dtype=out)
    torch.cuda.synchronize()
    assert (tpack.unpack_operand.launches,
            tpack.unpack_operand.stream_launches) == (
        before[0] + 1, before[1] + (design == "stream"))
    want = tpack.unpack_reference(p.payload, p.scales, p.layout, out)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("payload", ["bfloat16", "int4", "fp8e4m3"])
def test_pack_and_unpack_replay_in_a_cuda_graph(gen, payload):
    """A stream pack followed by a stream unpack captured in one CUDA graph
    (the wrappers allocate from the graph's pool, the kernels launch on
    the capturing stream and never synchronise), replayed on new source
    values: payload, scales and the dense operand byte for byte those of
    an eager run on the same values."""
    from repro_torch.packing import pack as tpack
    src = torch.randn(3, 256, 384, generator=gen, device="cuda")
    w = torch.empty_like(src)

    def step():
        p = tpack.pack_operand(w, (128, 128), dtype=payload)
        return p, tpack.unpack_operand(p, dtype=torch.bfloat16)

    w.copy_(src * 0.1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up: build, load, launch
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = (tpack.pack_operand.stream_launches,
              tpack.unpack_operand.stream_launches)
    with torch.cuda.graph(graph):
        p_g, out_g = step()
    assert (tpack.pack_operand.stream_launches,
            tpack.unpack_operand.stream_launches) == (before[0] + 1,
                                                      before[1] + 1)
    for scale in (0.3, 2.0):
        w.copy_(src * scale)
        graph.replay()
        torch.cuda.synchronize()
        p_e, out_e = step()
        torch.cuda.synchronize()
        assert torch.equal(_bytes(p_g.payload), _bytes(p_e.payload))
        if p_e.scales is not None:
            assert torch.equal(_bytes(p_g.scales), _bytes(p_e.scales))
        assert torch.equal(_bytes(out_g), _bytes(out_e))
    del graph


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


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
def test_fp32_policy_keeps_f32_fma_where_tf32x3_would_run(gen, grouped):
    """The fp32 policy's forward and backward over a dense f32 weight, with
    a gated epilogue and a bias, at sizes where K1's f32 products would
    otherwise run tf32x3 (2-D M 256, K 2048, N 1024; granite's 32 experts
    of M 64, K 1024, N 512): every K1 launch (the forward, the recompute
    of z, dx and dW) keeps f32 FMA on the fma design, bit-equal to the
    scalar loop, and the step matches the same step on CPU copies at f32's
    tolerance.  Then each of those four products, made again as a direct
    call, runs tf32x3 within the same tolerance of its fp32-policy
    result."""
    from repro_torch.core.gemm import mp_dot, mp_dot_grouped
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped
    lead, m, k, n = ((32,), 64, 1024, 512) if grouped else ((), 256, 2048,
                                                             1024)
    x = torch.randn(*lead, m, k, generator=gen, device="cuda")
    w = torch.randn(*lead, k, n, generator=gen, device="cuda") * k ** -0.5
    bias = torch.randn(n, generator=gen, device="cuda")
    gate = torch.randn(*lead, m, n, generator=gen, device="cuda")
    dy = torch.randn(*lead, m, n, generator=gen, device="cuda")
    op = mp_dot_grouped if grouped else mp_dot
    fn = mpgemm_grouped if grouped else mpgemm

    def run(dev):
        leaves = [t.detach().to(dev).requires_grad_(True)
                  for t in (x, w, bias, gate)]
        xx, ww, bb, gg = leaves
        y = op(xx, ww, bb, policy="fp32", activation="silu", gate=gg)
        (y * dy.to(dev)).sum().backward()
        return [y.detach()] + [t.grad for t in leaves]

    handed = []
    real = fn

    def recorded(a, b, **kw):
        out = real(a, b, **kw)
        handed.append((a, b, kw, out))
        return out

    import repro_torch.core.gemm as gemm_mod
    name = "mpgemm_grouped" if grouped else "mpgemm"
    setattr(gemm_mod, name, recorded)
    try:
        before = (fn.launches, fn.tf32x3_launches, fn.fma_launches)
        got = run("cuda")
        torch.cuda.synchronize()
        # forward, z again, dx (trans_b) and dW (trans_a): f32 FMA.
        assert (fn.launches - before[0], fn.tf32x3_launches - before[1],
                fn.fma_launches - before[2]) == (4, 0, 4)
    finally:
        setattr(gemm_mod, name, real)
    want = run("cpu")
    for gk, gp in zip(got, want):
        torch.testing.assert_close(gk.cpu(), gp, **TOL[torch.float32])
    assert len(handed) == 4 and all(h[2]["f32_fma"] for h in handed)
    for a, b, kw, exact in handed:
        rest = {k: v for k, v in kw.items() if k not in ("spec", "f32_fma")}
        spec = kw["spec"]
        assert torch.equal(exact, _k1_scalar(
            a, b, trans_a=spec.trans_a, trans_b=spec.trans_b, **rest))
        fast, design = _run_k1_f32(a, b, kw["spec"], **rest)
        assert design == "tf32x3"
        torch.testing.assert_close(fast, exact, **TOL[torch.float32])


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k1_scalar(a, b, **kw):
    """K1's scalar loop on these operands through its library, whatever
    ``k1_design`` says: the fma design's oracle (``chip_smoke.py``'s)."""
    return _chip_smoke()._k1_scalar(torch, a, b, **kw)


# The fma design's cases: (G, M, N, K, the tile k1_fma_tile gives).  M, N
# and K are off every tile's and stage's multiple (the last K stage
# partial; K not a multiple of the scalar loop's 16 or 64, so that it pads
# K); M = 2 (4 under trans_a, whose A rows must hold a multiple of 4).
FMA_BIT_CASES = [(1, 2, 32, 1024, (16, 4)), (3, 36, 44, 1004, (16, 4)),
                 (2, 200, 300, 1004, (32, 32)), (1, 520, 1040, 68, (64, 64)),
                 (1, 2040, 2044, 36, (128, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize("kind", ["linear", "bias_gelu", "gated_silu",
                                  "residual", "quant_in", "quant_in_residual",
                                  "beta_c", "bf16_out"])
@pytest.mark.parametrize("case", FMA_BIT_CASES,
                         ids=[f"g{c[0]}m{c[1]}n{c[2]}k{c[3]}"
                              for c in FMA_BIT_CASES])
def test_k1_fma_design_is_bit_equal_to_the_scalar_loop(gen, case, kind,
                                                       trans_a, trans_b):
    """K1's fma design (``mpgemm(..., f32_fma=True)`` on aligned f32
    operands, 2-D and grouped, every transpose pair, every tile, each
    epilogue kind) gives the scalar loop's bits, the same bits from two
    launches, and the plain version's result within f32's 1e-4 (bf16
    outputs: one bf16 rounding)."""
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec
    from repro_torch.kernels.mpgemm import (
        k1_fma_tile, mpgemm, mpgemm_grouped, mpgemm_plain,
    )

    g, m, n, k, tile = case
    m = 4 if trans_a and m == 2 else m
    assert k1_fma_tile(m, n, k, g) == tile
    lead = (g,) if g > 1 else ()
    a = torch.randn(*lead, *((k, m) if trans_a else (m, k)), generator=gen,
                    device="cuda")
    b = torch.randn(*lead, *((n, k) if trans_b else (k, n)), generator=gen,
                    device="cuda") * k ** -0.5
    out_dtype = torch.bfloat16 if kind == "bf16_out" else torch.float32

    def rand(*shape):
        return torch.randn(*lead, *shape, generator=gen, device="cuda")

    kw = dict(out_dtype=out_dtype, epilogue=EpilogueSpec(
        kind=kind if kind in ("residual", "quant_in", "quant_in_residual")
        else "gated" if kind == "gated_silu" else "linear",
        activation={"bias_gelu": "gelu", "gated_silu": "silu",
                    "quant_in": "silu"}.get(kind),
        alpha=1.5 if kind == "beta_c" else 1.0,
        beta=0.5 if kind == "beta_c" else 0.0))
    if kind in ("bias_gelu", "residual", "beta_c"):
        kw["bias"] = rand(n)
    extras = ()
    if kind.startswith("quant_in"):
        extras = (rand(m, 1).abs() + 0.5,)
    if kind in ("gated_silu", "residual", "quant_in_residual"):
        extras += (rand(m, n).to(out_dtype),)
    kw["extras"] = extras
    if kind == "beta_c":
        kw["c"] = rand(m, n)
    fn = mpgemm_grouped if lead else mpgemm
    before = (fn.launches, fn.fma_launches)
    got = fn(a, b, spec=GemmSpec(grouped=bool(lead), trans_a=trans_a,
                                 trans_b=trans_b), f32_fma=True, **kw)
    again = fn(a, b, spec=GemmSpec(grouped=bool(lead), trans_a=trans_a,
                                   trans_b=trans_b), f32_fma=True, **kw)
    scalar = _k1_scalar(a, b, trans_a=trans_a, trans_b=trans_b, **kw)
    torch.cuda.synchronize()
    assert (fn.launches - before[0], fn.fma_launches - before[1]) == (2, 2)
    assert torch.equal(got, again)
    assert torch.equal(got, scalar)
    want = mpgemm_plain(a, b, trans_a=trans_a, trans_b=trans_b, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[out_dtype])


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
    # llama-3.2-vision-11b's cross-attention over its 1600 image keys (GQA
    # 4:1, D 128) at a 32-token prefill and at decode.
    (2, 32, 8, 32, 1600, 128, False, None),
    (2, 32, 8, 1, 1600, 128, False, None),
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


K4_TF32X3_CASES = [
    # b, h, hkv, tq, tk, d, causal, window: granite's training attention
    # (GQA 16:8, D 64), GQA 4:1 with tq < tk under causal, cross-attention
    # over a ragged 1500 keys, D 96, D 128 over several key tiles, a window
    # at D 120 (padded to 128), D 24 with a window and no causal mask, and
    # tq > tk under causal (rows that see no key: their block's range holds
    # every key, so they average all of V, as the plain version does).
    (4, 16, 8, 128, 128, 64, True, None),
    (2, 8, 2, 48, 300, 64, True, None),
    (2, 4, 4, 32, 1500, 64, False, None),
    (2, 8, 8, 40, 40, 96, True, None),
    (1, 4, 4, 200, 700, 128, False, None),
    (2, 8, 2, 20, 150, 120, True, 37),
    (3, 6, 3, 64, 64, 24, False, 10),
    (1, 2, 2, 40, 8, 64, True, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal,window", K4_TF32X3_CASES)
def test_flash_attention_tf32x3_matches_plain(gen, b, h, hkv, tq, tk, d,
                                              causal, window):
    """f32 K4 on its tf32x3 design, counted as such, within f32's
    tolerance of the plain version on every row (1e-4: plain TF32 would
    miss it), and the same bits from a second launch."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, k4_design,
    )

    q = torch.randn(b, h, tq, d, generator=gen, device="cuda")
    k = torch.randn(b, hkv, tk, d, generator=gen, device="cuda")
    v = torch.randn(b, hkv, tk, d, generator=gen, device="cuda")
    assert k4_design(q, k, v) == "tf32x3"
    before = flash_attention.tf32x3_launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.tf32x3_launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


# --- K5's and K2's Hopper designs ---------------------------------------------

K5_NEW_CASES = [
    # h, hkv, d, ps, w, tq, lengths, window: phi3-mini's decode and 16-token
    # chunk (MHA, D 96, pages of 16: split), granite's decode (split) and
    # chunk (32 folded rows: wgmma), a GQA 4:1 head of 120 with a window
    # (decode: split; chunk: 64 rows, wgmma), pages of 8, 64 and 128, a
    # long table (split over the keys) and a group that folds 128 rows.
    (32, 32, 96, 16, 4, 1, [45, 30, 0], None),
    (32, 32, 96, 16, 4, 16, [48, 9, 0], None),
    (16, 8, 64, 16, 4, 1, [45, 30, 0], None),
    (16, 8, 64, 16, 4, 16, [48, 9, 0], None),
    (32, 8, 120, 16, 16, 1, [201, 64, 0, 9], 64),
    (32, 8, 120, 16, 16, 16, [200, 70, 0, 16], 64),
    (8, 2, 24, 8, 12, 3, [73, 1, 0], 6),
    (4, 4, 64, 64, 5, 1, [300, 65, 0], None),
    (8, 2, 128, 128, 3, 40, [383, 40, 0], 100),
    (4, 1, 64, 16, 128, 1, [2000, 1, 0], None),
    (16, 2, 64, 32, 8, 16, [250, 17, 0], None),
    # starcoder2-3b (GQA 12:1), phi3-medium-14b (4:1) and mixtral-8x22b
    # (6:1, window 4096) at decode and in a 16-token chunk, D 128, and
    # mixtral past its window.
    (24, 2, 128, 16, 4, 1, [45, 30, 0], None),
    (24, 2, 128, 16, 4, 16, [48, 9, 0], None),
    (40, 10, 128, 16, 4, 1, [45, 30, 0], None),
    (40, 10, 128, 16, 4, 16, [48, 9, 0], None),
    (48, 8, 128, 16, 4, 1, [45, 30, 0], 4096),
    (48, 8, 128, 16, 4, 16, [48, 9, 0], 4096),
    (48, 8, 128, 16, 288, 1, [4600, 4200, 0], 4096),
    (48, 8, 128, 16, 288, 16, [4608, 4111, 0], 4096),
]


def _k5_inputs(gen, h, hkv, d, ps, w, tq, lengths):
    """bf16 pools with a NaN scratch page 0 that every dead table slot
    names, ragged lengths (an idle request last but one), each request's
    chunk its last tq positions."""
    b = len(lengths)
    n_pages = 1 + b * w
    kp = torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda")
    vp = torch.randn(n_pages, hkv, ps, d, generator=gen, device="cuda")
    kp[0], vp[0] = float("nan"), float("nan")
    kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros(b, w, dtype=torch.int32, device="cuda")
    for i, ln in enumerate(lengths):
        used = -(-ln // ps)
        bt[i, :used] = perm[i * w:i * w + used].int()
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qs = (ln - tq).clamp_min(0).int()
    q = torch.randn(b, h, tq, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    return q, kp, vp, bt, qs, ln


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d,ps,w,tq,lengths,window", K5_NEW_CASES)
def test_paged_flash_new_designs_match_plain(gen, h, hkv, d, ps, w, tq,
                                             lengths, window):
    """bf16 K5 on the design ``k5_design`` names, counted as such, within
    bf16's tolerance of the plain version on live rows, idle rows exactly
    0 (never NaN from the scratch page), and the same bits from a second
    launch."""
    from repro_torch.kernels.flash_attention import (
        k5_design, paged_flash_attention, paged_flash_attention_plain,
    )

    q, kp, vp, bt, qs, ln = _k5_inputs(gen, h, hkv, d, ps, w, tq, lengths)
    design = k5_design(q, kp, vp)
    assert design == ("split" if h // hkv * tq <= 16 else "wgmma")
    counter = f"{design}_launches"
    before = getattr(paged_flash_attention, counter)
    got = paged_flash_attention(q, kp, vp, bt, qs, ln, window=window)
    torch.cuda.synchronize()
    assert getattr(paged_flash_attention, counter) == before + 1
    want = paged_flash_attention_plain(q, kp, vp, bt, qs, ln, window=window)
    pos = qs[:, None].long() + torch.arange(tq, device="cuda")
    live = (pos < ln[:, None])[:, None, :, None].expand_as(got)
    torch.testing.assert_close(got.float()[live], want.float()[live],
                               **TOL[torch.bfloat16])
    idle = ln == 0
    assert (got[idle] == 0).all()
    again = paged_flash_attention(q, kp, vp, bt, qs, ln, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


K2_NEW_PAIRS = [(torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"),
                (torch.bfloat16, "int4"), (torch.bfloat16, "fp8e4m3"),
                (torch.int8, "int8"), (torch.int8, "int4")]


def _k2_case(gen, g, m, k, n, a_dtype, payload, kind, act, out_dtype):
    from repro_torch.core.gemm_spec import EpilogueSpec
    from repro_torch.packing.pack import pack_operand

    lead = (g,) if g > 1 else ()
    w = torch.randn(*lead, k, n, generator=gen, device="cuda") * 0.05
    b = pack_operand(w, (128, 128), dtype=payload)
    scale = None
    if a_dtype == torch.int8:
        a = torch.randint(-127, 128, (*lead, m, k), generator=gen,
                          device="cuda", dtype=torch.int8)
        scale = torch.full((), 0.01, device="cuda")
    else:
        a = torch.randn(*lead, m, k, generator=gen, device="cuda").to(a_dtype)
    bi = torch.randn(n, generator=gen, device="cuda")
    extras = () if kind == "linear" else (
        torch.randn(*lead, m, n, generator=gen, device="cuda").to(out_dtype),)
    return a, b, dict(bias=bi, scale=scale, extras=extras,
                      epilogue=EpilogueSpec(kind=kind, activation=act),
                      out_dtype=out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype,payload", K2_NEW_PAIRS)
@pytest.mark.parametrize("g,m,k,n,kind,act", [
    (1, 2, 3072, 3072, "linear", None),       # phi3 decode (split over K)
    (1, 32, 3072, 8192, "gated", "silu"),     # a phi3 prefill chunk
    (1, 130, 304, 200, "residual", "gelu"),   # K and N tails, BM = 128
    (4, 2, 1024, 512, "linear", None),        # granite's experts, grouped
    (3, 37, 512, 1024, "gated", "silu"),
])
def test_mpgemm_packed_wgmma_matches_plain(gen, a_dtype, payload, g, m, k,
                                           n, kind, act):
    """K2 on its wgmma design (``k2_design``) against its plain version,
    2-D and grouped, counted as such, and the same bits from a second
    launch (split-K slices summed in slice order)."""
    from repro_torch.kernels.mpgemm import (
        k2_design, mpgemm_packed, mpgemm_packed_grouped, mpgemm_packed_plain,
    )

    out_dtype = torch.bfloat16 if g == 1 else torch.float32
    a, b, kw = _k2_case(gen, g, m, k, n, a_dtype, payload, kind, act,
                        out_dtype)
    fn = mpgemm_packed_grouped if g > 1 else mpgemm_packed
    assert k2_design(a, b) == "wgmma"
    before = fn.wgmma_launches
    got = fn(a, b, **kw)
    torch.cuda.synchronize()
    assert fn.wgmma_launches == before + 1
    want = mpgemm_packed_plain(a, b, **kw)
    assert got.dtype == out_dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[out_dtype])
    again = fn(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("payload", ["int8", "int4"])
def test_mpgemm_packed_wgmma_quant_in_and_beta_c(gen, payload):
    """The wgmma K2 runs gemm_epilogue.cuh's every kind: a quant_in row
    scale with a residual, and beta · C."""
    from repro_torch.core.gemm_spec import EpilogueSpec
    from repro_torch.kernels.mpgemm import (
        k2_design, mpgemm_packed, mpgemm_packed_plain,
    )
    from repro_torch.packing.pack import pack_operand

    m, k, n = 32, 1024, 640
    b = pack_operand(torch.randn(k, n, generator=gen, device="cuda") * 0.05,
                     (128, 128), dtype=payload)
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    rows = torch.rand(m, 1, generator=gen, device="cuda") * 1e-2
    res = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
    ep = EpilogueSpec(kind="quant_in_residual")
    kw = dict(extras=(rows, res), epilogue=ep, out_dtype=torch.bfloat16)
    assert k2_design(a, b) == "wgmma"
    got = mpgemm_packed(a, b, **kw)
    torch.testing.assert_close(got.float(),
                               mpgemm_packed_plain(a, b, **kw).float(),
                               **TOL[torch.bfloat16])
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    c = torch.randn(m, n, generator=gen, device="cuda")
    kw = dict(c=c, epilogue=EpilogueSpec(alpha=1.5, beta=0.5),
              out_dtype=torch.float32)
    got = mpgemm_packed(x, b, **kw)
    torch.testing.assert_close(got, mpgemm_packed_plain(x, b, **kw),
                               **TOL[torch.float32])


# --- K3's wgmma design (csrc/mpgemm_sparse_wgmma.cu, _int8.cu) ---------------

K3_NEW_PAIRS = [("bfloat16", "bfloat16"), ("bfloat16", "int8"),
                ("int8", "int8")]


def _k3_case(gen, lead, m, k, n, a_dtype, payload, mask):
    """A tile-sparse (K, N) operand in 128 x 128 tiles (column tile 1
    empty, the K- and N-tail tile stored; ``mask == "empty"``: none) and
    A of ``a_dtype`` with the int8 policy's scale."""
    b = _sparse_operand(gen, (*lead, k, n), (128, 128), payload, mask)
    a, scale = _sparse_a(gen, (*lead, m, k), a_dtype)
    return a, b, scale


def _run_k3(a, b, grouped, **kw):
    """One K3 launch; -> (output, the design it ran)."""
    from repro_torch.kernels.mpgemm import mpgemm_sparse, \
        mpgemm_sparse_grouped
    fn = mpgemm_sparse_grouped if grouped else mpgemm_sparse
    before = (fn.launches, fn.wgmma_launches)
    out = fn(a, b, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before[0] + 1
    return out, "wgmma" if fn.wgmma_launches > before[1] else "simt"


@pytest.mark.cuda
@pytest.mark.parametrize("a_dtype,payload", K3_NEW_PAIRS)
@pytest.mark.parametrize("g,m,k,n,kind,act,mask", [
    (1, 2, 3072, 3072, "linear", None, "half"),    # phi3 decode, split
    (1, 32, 3072, 8192, "gated", "silu", "half"),  # a phi3 prefill chunk
    (1, 130, 2960, 200, "residual", "gelu", "half"),  # K, N tails, BM 128
    (1, 5, 256, 384, "linear", "relu", "empty"),   # no stored tile
    (4, 2, 1024, 512, "linear", None, "half"),     # granite experts
    (3, 37, 512, 1024, "gated", "silu", "half"),
])
def test_mpgemm_sparse_wgmma_matches_plain(gen, a_dtype, payload, g, m, k,
                                           n, kind, act, mask):
    """K3 on its wgmma design (``k3_design``) against its plain version,
    2-D and grouped, counted as such; an empty column (and an operand with
    no stored tile) gets its epilogue on a zero sum; a second launch gives
    the same bits (the slices summed in slice order)."""
    from repro_torch.core.gemm_spec import EpilogueSpec
    from repro_torch.kernels.mpgemm import k3_design, mpgemm_sparse_plain
    lead = (g,) if g > 1 else ()
    a, b, scale = _k3_case(gen, lead, m, k, n, a_dtype, payload, mask)
    out_dtype = torch.bfloat16 if g == 1 else torch.float32
    extras = () if kind == "linear" else (
        torch.randn(*lead, m, n, generator=gen, device="cuda").to(out_dtype),)
    kw = dict(bias=torch.randn(n, generator=gen, device="cuda"),
              scale=scale, extras=extras, out_dtype=out_dtype,
              epilogue=EpilogueSpec(kind=kind, activation=act))
    assert k3_design(a, b) == "wgmma"
    got, design = _run_k3(a, b, bool(lead), **kw)
    assert design == "wgmma"
    want = mpgemm_sparse_plain(a, b, **kw)
    assert got.dtype == out_dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[out_dtype])
    again, _ = _run_k3(a, b, bool(lead), **kw)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("a_dtype,payload", K3_NEW_PAIRS)
def test_mpgemm_sparse_wgmma_beta_c_quant_in_and_trans_a(gen, a_dtype,
                                                         payload, grouped):
    """The wgmma K3 runs gemm_epilogue.cuh's every kind: beta · C, a
    quant_in row scale with a residual; and ``trans_a`` (the wrapper's
    copy of Aᵀ) on the same design."""
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec
    from repro_torch.kernels.mpgemm import (
        mpgemm, mpgemm_grouped, mpgemm_sparse, mpgemm_sparse_grouped,
        mpgemm_sparse_plain,
    )
    lead = (3,) if grouped else ()
    m, k, n = 32, 1024, 640
    a, b, scale = _k3_case(gen, lead, m, k, n, a_dtype, payload, "half")
    c = torch.randn(*lead, m, n, generator=gen, device="cuda")
    kw = dict(c=c, scale=scale, out_dtype=torch.float32,
              epilogue=EpilogueSpec(alpha=1.5, beta=0.5, activation="relu"))
    got, design = _run_k3(a, b, grouped, **kw)
    assert design == "wgmma"
    torch.testing.assert_close(got, mpgemm_sparse_plain(a, b, **kw),
                               **TOL[torch.float32])
    if a_dtype == "int8":
        rows = torch.rand(*lead, m, 1, generator=gen, device="cuda") * 1e-2
        res = torch.randn(*lead, m, n, generator=gen,
                          device="cuda").to(torch.bfloat16)
        kw = dict(extras=(rows, res), out_dtype=torch.bfloat16,
                  epilogue=EpilogueSpec(kind="quant_in_residual"))
        got, design = _run_k3(a, b, grouped, **kw)
        assert design == "wgmma"
        torch.testing.assert_close(
            got.float(), mpgemm_sparse_plain(a, b, **kw).float(),
            **TOL[torch.bfloat16])
    at = a.transpose(-1, -2).contiguous()
    counter = mpgemm_sparse_grouped if grouped else mpgemm_sparse
    before = (counter.trans_a_launches, counter.wgmma_launches)
    fn = mpgemm_grouped if grouped else mpgemm
    got = fn(at, b, scale=scale, out_dtype=torch.float32,
             spec=GemmSpec(grouped=grouped, trans_a=True))
    torch.cuda.synchronize()
    assert (counter.trans_a_launches, counter.wgmma_launches) == (
        before[0] + 1, before[1] + 1)
    want = mpgemm_sparse_plain(at, b, scale=scale, out_dtype=torch.float32,
                               trans_a=True)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.cuda
def test_mpgemm_sparse_wgmma_skewed_columns(gen):
    """A pattern with one full column and the rest one tile each: the
    split cuts the longest column, the short columns' later slices count
    themselves in with zero partials, and the result matches."""
    import numpy as np

    from repro_torch.kernels.mpgemm import k3_split, mpgemm_sparse_plain
    from repro_torch.sparse import sparsify_with_mask
    k, n = 4096, 1024
    keep = np.zeros((k // 128, n // 128), bool)
    keep[:, 3] = True
    keep[5, :] = True
    w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
    b = sparsify_with_mask(w, (128, 128), keep, dtype="bfloat16")
    assert b.layout.max_column_tiles == k // 128
    assert k3_split(2, n, b.layout.max_column_tiles)[0] > 1
    a = torch.randn(2, k, generator=gen, device="cuda").to(torch.bfloat16)
    got, design = _run_k3(a, b, False, out_dtype=torch.float32)
    assert design == "wgmma"
    torch.testing.assert_close(
        got, mpgemm_sparse_plain(a, b, out_dtype=torch.float32),
        **TOL[torch.float32])


# --- K1's f32 design, 3xTF32 (csrc/mpgemm_wgmma_f32.cu) ---------------------

def _f32_operands(gen, lead, m, n, k, trans_a, trans_b):
    a = torch.randn(*lead, *((k, m) if trans_a else (m, k)), generator=gen,
                    device="cuda")
    b = torch.randn(*lead, *((n, k) if trans_b else (k, n)), generator=gen,
                    device="cuda") * k ** -0.5
    return a, b


def _run_k1_f32(a, b, spec, **kw):
    """One f32 K1 launch; -> (output, the design it ran)."""
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped
    fn = mpgemm_grouped if spec.grouped else mpgemm
    before = (fn.launches, fn.tf32x3_launches, fn.fma_launches)
    out = fn(a, b, spec=spec, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before[0] + 1
    return out, ("tf32x3" if fn.tf32x3_launches > before[1] else
                 "fma" if fn.fma_launches > before[2] else "simt")


@pytest.mark.cuda
@pytest.mark.parametrize("trans_a,trans_b", TRANSPOSES)
@pytest.mark.parametrize("lead,m,n,k", [
    ((), 1, 40000, 1024), ((), 16, 3072, 3072), ((), 64, 1032, 1024),
    ((), 65, 1000, 1024), ((), 130, 264, 1000), ((32,), 2, 512, 1024),
    ((4,), 72, 136, 1040), ((), 2, 3072, 3072), ((), 2, 32, 1024)])
def test_mpgemm_tf32x3_matches_plain(gen, lead, m, n, k, trans_a, trans_b):
    """f32 K1 on the tensor cores (``k1_design``: rows of a multiple of 4
    values, an f32 output) in all four transposes, 2-D and grouped,
    split-K at M = 16, at phi3's decode width (M = 2) and at granite's
    experts (M = 2, 32 groups), granite's router (N = 32), M, N and K
    tails, within 1e-4 of the plain version; ``trans_a`` with M off a
    multiple of 4 is the scalar K1's; a caller that keeps f32 FMA
    arithmetic (``f32_fma``, the fp32 policy's) gets the fma design on
    the same rule, bit-equal to the scalar loop."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import k1_design, mpgemm_plain
    a, b = _f32_operands(gen, lead, m, n, k, trans_a, trans_b)
    spec = GemmSpec(grouped=bool(lead), trans_a=trans_a, trans_b=trans_b)
    got, design = _run_k1_f32(a, b, spec)
    assert design == k1_design(a, b)
    assert design == ("simt" if trans_a and m % 4 else "tf32x3")
    want = mpgemm_plain(a, b, trans_a=trans_a, trans_b=trans_b)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    got, design = _run_k1_f32(a, b, spec, f32_fma=True)
    assert design == k1_design(a, b, f32_fma=True)
    assert design == ("simt" if trans_a and m % 4 else "fma")
    assert torch.equal(got, _k1_scalar(a, b, trans_a=trans_a,
                                       trans_b=trans_b))
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("wid,m,n,k", [(4, 64, 7168, 16384),
                                       (24, 5120, 256, 13824),
                                       (10, 128, 7168, 16384)])
def test_mpgemm_tf32x3_holds_the_gate_at_table_iii_depth(gen, wid, m, n, k):
    """Table III's deepest K (W4, W10: 16384, W24: 13824), A ~ N(0, 1) and
    B ~ N(0, 1/K) as chip_smoke.py draws them: within atol = rtol = 1e-4
    of the plain version (f32 on the card, TF32 off)."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import mpgemm_plain
    a, b = _f32_operands(gen, (), m, n, k, False, False)
    got, design = _run_k1_f32(a, b, GemmSpec())
    assert design == "tf32x3"
    want = mpgemm_plain(a, b)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,act", [
    ("linear", "gelu"), ("gated", "silu"), ("residual", None),
    ("quant_in", "silu"), ("quant_in_residual", "relu")])
@pytest.mark.parametrize("m,n,k,grouped", [(2, 4104, 4096, False),
                                           (100, 264, 2048, False),
                                           (2, 2056, 2048, True)])
def test_mpgemm_tf32x3_epilogues_match_plain(gen, kind, act, m, n, k,
                                             grouped):
    """Every epilogue kind on the f32 design, with alpha, a bias and
    beta · C; M = 2 runs split-K."""
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec, \
        get_epilogue
    from repro_torch.kernels.mpgemm import mpgemm_plain
    lead = (4,) if grouped else ()
    a, b = _f32_operands(gen, lead, m, n, k, False, False)
    ed = get_epilogue(kind)
    extras = tuple(
        torch.rand(*lead, m, 1, generator=gen, device="cuda") + 0.5
        if name in ed.row_operands else
        torch.randn(*lead, m, n, generator=gen, device="cuda")
        for name in ed.extra_operands)
    kw = dict(c=torch.randn(*lead, m, n, generator=gen, device="cuda"),
              bias=torch.randn(n, generator=gen, device="cuda"),
              extras=extras, epilogue=EpilogueSpec(
                  kind=kind, activation=act, alpha=1.5, beta=0.5))
    got, design = _run_k1_f32(a, b, GemmSpec(grouped=grouped), **kw)
    assert design == "tf32x3"
    torch.testing.assert_close(got, mpgemm_plain(a, b, **kw),
                               **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["split-k", "dw", "grouped", "router-dw"])
def test_mpgemm_tf32x3_is_deterministic(gen, case):
    """Two launches give the same bits: split-K at phi3's width (M = 16),
    a weight gradient (A read (K, M): 512 tokens, 1024 x 1024), which a
    resumed training run must repeat bit for bit, granite's experts, and
    the router's weight gradient (1024 x 32 x 512)."""
    from repro_torch.core.gemm_spec import GemmSpec
    lead, m, n, k, ta, want = {
        "split-k": ((), 16, 3072, 3072, False, "tf32x3"),
        "dw": ((), 1024, 1024, 512, True, "tf32x3"),
        "grouped": ((32,), 2, 512, 1024, False, "tf32x3"),
        "router-dw": ((), 1024, 32, 512, True, "tf32x3")}[case]
    a, b = _f32_operands(gen, lead, m, n, k, ta, False)
    spec = GemmSpec(grouped=bool(lead), trans_a=ta)
    first, design = _run_k1_f32(a, b, spec)
    again, _ = _run_k1_f32(a, b, spec)
    assert design == want
    assert torch.equal(first, again)


# --- the continuous engine's step captured in CUDA graphs --------------------

# Smoke-size models (2 layers, 96 wide) on every weight form the captured
# step serves: dense bf16, packed int8 under the int8 policy, tile-sparse
# bf16 and the MoE model.
GRAPH_CASES = {
    "phi3-bf16": ("phi3-mini-3.8b", "bf16", {}),
    "phi3-int8-packed": ("phi3-mini-3.8b", "int8", dict(pack=True)),
    "phi3-sparse": ("phi3-mini-3.8b", "bf16", dict(sparsity=0.5)),
    "granite-bf16": ("granite-moe-1b-a400m", "bf16", {}),
}


def _graph_model(case):
    from repro_torch.configs import base as cb
    from repro_torch.models.transformer import build_model
    arch, policy, kw = GRAPH_CASES[case]
    model = build_model(cb.get(arch, smoke=True), policy=policy,
                        device="cuda")
    return model, model.init(torch.Generator(device="cuda").manual_seed(0),
                             **kw)


def _decode_inputs(model, params, gen, caches):
    """A two-row decode step (contexts of 20 and 9 tokens, written by one
    eager chunk first) -> its inputs (tokens, block tables, q_start,
    n_valid)."""
    i32 = dict(dtype=torch.int32, device="cuda")
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], **i32)
    vocab = model.cfg.vocab
    with torch.inference_mode():
        model.paged_step(params, torch.randint(
            2, vocab, (2, 20), generator=gen, device="cuda",
            dtype=torch.int32), caches, bt, torch.tensor([0, 0], **i32),
            torch.tensor([20, 9], **i32))
    return [torch.randint(2, vocab, (2, 1), generator=gen, device="cuda",
                          dtype=torch.int32), bt,
            torch.tensor([20, 9], **i32), torch.tensor([1, 1], **i32)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_captured_serving_matches_eager(gen, case):
    """Four requests served with and without capture: the same greedy
    tokens, the same steps, the same launch counts; each step either
    captured its width (the first of it) or replayed, and the decode graph
    replayed."""
    import numpy as np

    from repro_torch.kernels import counters
    from repro_torch.serve.engine import Request, ServeEngine
    model, params = _graph_model(case)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, model.cfg.vocab, (n,)).astype(np.int32)
               for n in (5, 19, 12, 30)]
    runs = []
    for graphs in (False, None):
        counters.reset_launch_counts()
        eng = ServeEngine(model, params, max_len=48, max_batch=2,
                          page_size=8, cuda_graphs=graphs)
        out = eng.generate([Request(uid=i, prompt=p, max_new_tokens=6)
                            for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        runs.append((out, counters.launch_counts(), eng))
    (want, want_counts, eager), (got, counts, eng) = runs
    assert eager.graphs is None and eng.graphs
    assert eng.graphs[1].replays > 0 and len(eng.graphs) >= 2
    assert (len(eng.graphs) + sum(g.replays for g in eng.graphs.values())
            == len(eng.step_telemetry))
    assert got == want and sorted(got) == [0, 1, 2, 3]
    assert len(eng.step_telemetry) == len(eager.step_telemetry)
    assert counts == want_counts
    assert counts["k5"] == model.cfg.n_layers * len(eng.step_telemetry)
    assert eng.graph_pool_bytes() > 0


def _captured_decode(case, gen):
    """A smoke model, its pools after one eager chunk, a decode step's
    inputs, a stream, and that step captured on the stream after one eager
    warm-up there."""
    from repro_torch.serve.engine import StepGraph
    model, params = _graph_model(case)
    caches = model.init_paged_caches(9, 8)
    ins = _decode_inputs(model, params, gen, caches)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.inference_mode():
        model.paged_step(params, ins[0], caches, *ins[1:])
        graph = StepGraph(model, params, caches, ins, stream=stream,
                          pool=torch.cuda.graph_pool_handle())
    return model, params, caches, ins, stream, graph


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_replayed_step_logits_equal_the_eager_step(gen, case):
    """A replay on new tokens gives the eager step's logits bit for bit (a
    launch that escaped the graph would keep the capture's inputs), and
    counts the eager step's launches."""
    from repro_torch.kernels import counters
    model, params, caches, ins, stream, graph = _captured_decode(case, gen)
    new = torch.randint(2, model.cfg.vocab, (2, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    with torch.cuda.stream(stream), torch.inference_mode():
        ins[0].copy_(new)
        before = counters.launch_counts()
        got = graph.replay().clone()
        replayed = counters.count_delta(counters.launch_counts(), before)
        before = counters.launch_counts()
        want, _ = model.paged_step(params, ins[0], caches, *ins[1:])
        eager = counters.count_delta(counters.launch_counts(), before)
    torch.cuda.synchronize()
    assert replayed == eager == graph.launches
    assert eager["k5"] == model.cfg.n_layers
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_workspace_grown_after_a_capture_keeps_the_replay(gen, case):
    """A larger eager launch on the capture stream grows the split
    workspace the graph captured (the kept pair is replaced; a case whose
    launches do not split has none, and gets one after the capture);
    tensors allocated after it on that stream are not written by the next
    replay, whose logits stay those of the replay before."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import _split_buffers, mpgemm
    model, params, caches, ins, stream, graph = _captured_decode(case, gen)
    key = (torch.device("cuda", torch.cuda.current_device()),
           stream.cuda_stream)
    with torch.cuda.stream(stream), torch.inference_mode():
        ref = graph.replay().clone()
        held = [(t.numel(), t.dtype) for t in _split_buffers.get(key, ())]
        # 2 output tiles x 86 slices of K: 2.8 M f32 partials.
        a = torch.randn(128, 16384, generator=gen, device="cuda").bfloat16()
        b = torch.randn(16384, 256, generator=gen, device="cuda").bfloat16()
        mpgemm(a, b, spec=GemmSpec())
        assert _split_buffers[key][0].numel() > (held[0][0] if held else 0)
        junk = [torch.full((n,), 7, dtype=dt, device="cuda")
                for n, dt in held for _ in range(4)]
        got = graph.replay().clone()
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert all(bool((j == 7).all()) for j in junk)


# --- the wave engine's decode step captured in a CUDA graph ------------------

# Each wave block kind by the smoke model that runs it, bf16: recurrentgemma
# with a local window of 5, which the 12-token prompt and the steps wrap.
WAVE_GRAPH_CASES = {
    "dense": ("phi3-mini-3.8b", {}),
    "attn_local": ("recurrentgemma-2b", dict(local_attn_window=5)),
    "moe": ("granite-moe-1b-a400m", {}),
    "encdec": ("whisper-medium", {}),
    "cross": ("llama-3.2-vision-11b", {}),
    "rwkv": ("rwkv6-1.6b", {}),
    "rglru": ("recurrentgemma-2b", {}),
}


# The cross and recurrent kinds in the other serving forms: (architecture,
# policy, LM.init's form arguments).  The sparse forms prune 32 x 32 tiles
# (a smoke weight holds one tile of 128 x 128).
_SPARSE = dict(sparsity=0.5, sparsity_blocks=(32, 32))
WAVE_FORM_CASES = {
    f"{kind}-{form}": (arch, policy, init)
    for kind, arch in (("cross", "llama-3.2-vision-11b"),
                       ("rwkv", "rwkv6-1.6b"),
                       ("rglru", "recurrentgemma-2b"))
    for form, policy, init in (
        ("int8", "int8", {}),
        ("int8-pack", "int8", dict(pack=True)),
        ("pack-int4", "bf16", dict(pack=True, pack_format="int4")),
        ("pack-fp8", "bf16", dict(pack=True, pack_format="fp8")),
        ("sparse", "bf16", _SPARSE),
        ("int8-sparse-nm", "int8", dict(_SPARSE, sparsity_method="nm")))}


def _wave_model(case):
    """A smoke model of the case (``WAVE_GRAPH_CASES``, bf16 and dense, or
    ``WAVE_FORM_CASES``) and its params, the cross gates opened to 0.5
    (drawn 0, a closed gate hides its branch)."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.models.transformer import build_model
    if case in WAVE_FORM_CASES:
        arch, policy, init = WAVE_FORM_CASES[case]
        changes = {}
    else:
        (arch, changes), policy, init = WAVE_GRAPH_CASES[case], "bf16", {}
    model = build_model(dataclasses.replace(cb.get(arch, smoke=True),
                                            **changes), policy=policy,
                        device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        **init)
    half = torch.tensor(0.5, device="cuda")
    params["layers"] = [dict(layer, gate_attn=half, gate_mlp=half)
                        if "gate_attn" in layer else layer
                        for layer in params["layers"]]
    return model, params


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WAVE_GRAPH_CASES)
                         + list(WAVE_FORM_CASES))
def test_replayed_wave_step_equals_the_eager_step(gen, case):
    """A two-row decode step captured after one eager warm-up, replayed at
    a later position and on new tokens from the caches the prefill left
    (copied back before each step: the recurrent states advance): logits
    and caches equal to the eager step's bit for bit, and its launches."""
    from repro_torch.kernels import counters
    from repro_torch.serve.engine import WaveGraph, _cache_tensors
    model, params = _wave_model(case)
    cfg = model.cfg
    toks = torch.randint(2, cfg.vocab, (2, 12), generator=gen,
                         device="cuda", dtype=torch.int32)
    toks[1, :4] = 0
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.randn(
            2, cfg.encoder_seq, cfg.d_model, generator=gen, device="cuda")
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            2, cfg.n_image_tokens, cfg.d_model, generator=gen, device="cuda")
    _, caches = model.prefill(params, batch, max_len=24)
    tensors = _cache_tensors(caches)
    saved = [t.clone() for t in tensors]
    token = torch.randint(2, cfg.vocab, (2, 1), generator=gen, device="cuda")
    pos = torch.tensor(12, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.inference_mode():
        model.decode_step(params, token, caches, pos)
        graph = WaveGraph(model, params, caches, token, pos, stream=stream,
                          pool=torch.cuda.graph_pool_handle())
        token.copy_(torch.randint(2, cfg.vocab, (2, 1), generator=gen,
                                  device="cuda"))
        pos.fill_(17)
        for t, s in zip(tensors, saved):
            t.copy_(s)
        before = counters.launch_counts()
        got = graph.replay().clone()
        replayed = counters.count_delta(counters.launch_counts(), before)
        after_replay = [t.clone() for t in tensors]
        for t, s in zip(tensors, saved):
            t.copy_(s)
        before = counters.launch_counts()
        want, _ = model.decode_step(params, token, caches, pos)
        eager = counters.count_delta(counters.launch_counts(), before)
    torch.cuda.synchronize()
    assert replayed == eager == graph.launches
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(after_replay, tensors))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WAVE_GRAPH_CASES)
                         + list(WAVE_FORM_CASES))
def test_captured_wave_serving_matches_eager(gen, case):
    """Five requests in waves of two (prompt widths 12, 9 and a short last
    wave) served captured (the default) and eagerly: the same tokens and
    launch counts; one graph, every decode step but the first replayed,
    every cache tensor where the engine allocated it."""
    import warnings

    import numpy as np

    from repro_torch.kernels import counters
    from repro_torch.serve.engine import Request, ServeEngine, _cache_tensors
    model, params = _wave_model(case)
    spec = [(7, 6), (12, 4), (5, 6), (9, 3), (4, 5)]
    runs = []
    for graphs in (False, None):
        counters.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = ServeEngine(model, params, batch_size=2, max_len=48,
                              cuda_graphs=graphs)
        ptrs = [t.data_ptr() for t in _cache_tensors(eng.caches)]
        rng = np.random.default_rng(1)
        out = eng.generate([Request(uid=i, prompt=rng.integers(
            2, model.cfg.vocab, (n,)).astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(spec)])
        torch.cuda.synchronize()
        assert ptrs == [t.data_ptr() for t in _cache_tensors(eng.caches)]
        runs.append((out, counters.launch_counts(), eng))
    (want, want_counts, eager), (got, counts, eng) = runs
    decode = sum(s.phase == "decode" for s in eng.step_telemetry)
    assert eager.graphs is None and sorted(eng.graphs) == [1]
    assert 1 + eng.graphs[1].replays == decode > 1
    assert got == want and sorted(got) == [0, 1, 2, 3, 4]
    assert counts == want_counts
    assert eng.graph_pool_bytes() > 0


# The RG-LRU gates' products on the fp32 policy against a packed or sparse
# weight, at recurrentgemma-2b's width (2560 x 2560), a decode step's two
# rows and a 32-row prefill: K2's and K3's f32-A routes (the first
# kernels), with every payload the reference lets reach them -- a bf16
# payload cast to f32 per call, or the scaled int8, int4 and fp8 ones
# (sparse: int8) read against f32 A.
GATE_ROUTES = [("packed", "bfloat16"), ("packed", "int8"),
               ("packed", "int4"), ("packed", "fp8e4m3"),
               ("sparse", "bfloat16"), ("sparse", "int8")]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 32])
@pytest.mark.parametrize("form,payload", GATE_ROUTES)
def test_gate_f32a_routes_match_plain(gen, form, payload, m):
    from repro_torch.kernels import counters
    from repro_torch.kernels.mpgemm import (
        mpgemm_packed, mpgemm_packed_plain, mpgemm_sparse,
        mpgemm_sparse_plain,
    )
    from repro_torch.packing.pack import pack_operand
    from repro_torch.sparse import sparsify_magnitude
    k = n = 2560
    w = torch.randn(k, n, generator=gen, device="cuda") / 50.0
    a = torch.randn(m, k, generator=gen, device="cuda")
    if form == "packed":
        b = pack_operand(w, (128, 128), dtype=payload).astype(torch.float32)
        kern, plain = mpgemm_packed, mpgemm_packed_plain
    else:
        b = sparsify_magnitude(w, (128, 128), density=0.5,
                               dtype=payload).astype(torch.float32)
        kern, plain = mpgemm_sparse, mpgemm_sparse_plain
    before = counters.launch_counts()
    got = kern(a, b, out_dtype=torch.float32)
    ran = counters.count_delta(counters.launch_counts(), before)
    want = plain(a, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    key = "k2" if form == "packed" else "k3"
    assert ran[key] == 1 and ran.get(f"{key}_wgmma", 0) == 0
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL[torch.float32])


# --- the training step captured in a CUDA graph -------------------------------

# Smoke-size models (2-5 layers, 96 or 128 wide): a dense one and the MoE
# one, under bf16 and (the MoE one) fp32 -- K1's fma design and K4's
# tf32x3 design --, and the cross and recurrent kinds under bf16 (the
# recurrences' scans rematerialised a chunk at a time).  Every step
# repeats itself bit for bit: the MoE dispatch gather's and the
# embedding's backward sum in a fixed order.
TRAIN_GRAPH_CASES = {"phi3-bf16": ("phi3-mini-3.8b", "bf16"),
                     "granite-bf16": ("granite-moe-1b-a400m", "bf16"),
                     "granite-fp32": ("granite-moe-1b-a400m", "fp32"),
                     "llama-vision-bf16": ("llama-3.2-vision-11b", "bf16"),
                     "rwkv6-bf16": ("rwkv6-1.6b", "bf16"),
                     "recurrentgemma-bf16": ("recurrentgemma-2b", "bf16")}


@pytest.fixture
def deterministic():
    """Deterministic algorithms for the test (warnings, not errors, where
    an op has none), the setting before restored after it."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _trainer(case, graphs, steps=4, microbatches=1, ckpt=None):
    from repro_torch.configs import base as cb
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    arch, policy = TRAIN_GRAPH_CASES[case]
    model = build_model(cb.get(arch, smoke=True), policy=policy,
                        device="cuda")
    return Trainer(model, ShapeConfig("t", 64, 4, "train"), TrainerConfig(
        steps=steps, microbatches=microbatches, log_every=1000,
        checkpoint_every=1, checkpoint_dir=ckpt,
        opt=AdamWConfig(lr=1e-2)), seed=1, cuda_graphs=graphs)


def _train(case, graphs, **kw):
    """-> (trainer, the step metrics, the final state's leaves: params,
    then the AdamW step, m and v; the step count, the launch counts of
    the run)."""
    from repro_torch.kernels import counters
    from repro_torch.optim.adamw import tree_leaves
    tr = _trainer(case, graphs, **kw)
    counters.reset_launch_counts()
    params, opt = tr.run()
    torch.cuda.synchronize()
    log = [(r["loss"], r["grad_norm"]) for r in tr.metrics_log]
    return (tr, log, tree_leaves(params) + tree_leaves(opt), int(opt.step),
            counters.launch_counts())


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("case", list(TRAIN_GRAPH_CASES))
def test_captured_training_matches_eager(gen, case, microbatches):
    """Four steps captured (the first eager, three replays) against the
    eager loop: the same launch counts, and the same losses, grad norms
    and final parameters, moments and step bit for bit.  Where they
    differ, a second eager run tells a capture that computes something
    else from an eager loop that does not repeat itself: both fail."""
    tr, log, state, step, counts = _train(case, None,
                                          microbatches=microbatches)
    _, want_log, want, _, want_counts = _train(case, False,
                                               microbatches=microbatches)
    assert tr.graph is not None and tr.graph.replays == 3 and step == 4
    assert tr.graph_pool_bytes() > 0
    assert counts == want_counts and counts["k1"] > 0
    if log == want_log and _same(state, want):
        return
    _, again_log, again, _, _ = _train(case, False,
                                       microbatches=microbatches)
    assert again_log == want_log and _same(again, want), \
        "the eager loop does not repeat itself"
    pytest.fail("the captured run differs from the eager loop")


@pytest.mark.cuda
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("case", list(TRAIN_GRAPH_CASES))
def test_captured_training_matches_eager_deterministically(
        gen, deterministic, case, microbatches):
    """Under deterministic algorithms the captured run and the eager loop
    agree bit for bit on every case."""
    tr, log, state, step, counts = _train(case, None,
                                          microbatches=microbatches)
    _, want_log, want, _, want_counts = _train(case, False,
                                               microbatches=microbatches)
    assert tr.graph.replays == 3 and step == 4 and counts == want_counts
    assert log == want_log and _same(state, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TRAIN_GRAPH_CASES))
def test_captured_training_resumed_in_the_middle(gen, deterministic, case,
                                                 tmp_path):
    """A run stopped after its first step with a checkpoint, restored and
    run on (captured: its first step eager, two replays) reaches the
    uninterrupted captured run's metrics and state bit for bit."""
    from repro_torch.optim.adamw import tree_leaves
    _, log, want, _, _ = _train(case, None)
    first = _trainer(case, None, steps=1, ckpt=str(tmp_path))
    first.run()
    assert first.graph is None                   # no step after the first
    tr = _trainer(case, None, ckpt=str(tmp_path))
    params, opt, start = tr.restore(*tr.init_state())
    assert start == 1
    params, opt = tr.run(params, opt, start_step=start)
    torch.cuda.synchronize()
    assert tr.graph.replays == 2 and int(opt.step) == 4
    assert [(r["loss"], r["grad_norm"]) for r in tr.metrics_log] == log[1:]
    assert _same(tree_leaves(params) + tree_leaves(opt), want)


@pytest.mark.cuda
def test_traced_replay_after_another_capture(gen):
    """The traced-replay fault's order at smoke size (``chip_smoke.py``'s
    ``phase_trace_replay`` at full size): granite's step captured, a second
    trainer's step captured, replayed and destroyed, then one replay of
    the first under torch.profiler: it runs, and the trace holds its
    kernels."""
    import gc

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tr, *_ = _train("granite-bf16", None, steps=2)
    other, *_ = _train("granite-bf16", None, steps=2)
    assert tr.graph is not None and other.graph is not None
    del other
    gc.collect()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert any("mpgemm_wgmma_kernel" in n for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TRAIN_GRAPH_CASES))
def test_replays_count_the_eager_steps_launches(gen, case):
    """The capture rolls its counts back and each replay adds the graph's:
    after the eager first step and four replays the counts are five eager
    steps', and the graph's delta is one eager step's."""
    from repro_torch.kernels import counters
    tr, _, _, _, counts = _train(case, None, steps=5)
    per_step = tr.graph.launches
    attention = any(k not in ("rwkv", "rglru") for k in tr.cfg.pattern)
    assert per_step["k1"] > 0 and (per_step.get("k4", 0) > 0) == attention
    assert counters.count_delta(counts, {k: 0 for k in counts}) == {
        k: 5 * n for k, n in per_step.items()}
    _, _, _, _, eager = _train(case, False, steps=1)
    assert counters.count_delta(eager, {k: 0 for k in eager}) == per_step


# --- the backward of the gathers a training step shares -----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dispatch_gather_backward_repeats_itself(gen, dtype):
    """granite's MoE dispatch gather at its training shapes (batch 4 x seq
    128, d 1024, 32 experts, top-8, capacity 1.25): two backward passes on
    the same inputs are bit-equal (autograd through torch.gather's
    scatter_add was not), and equal to the f32 sum of each token's k
    slots in choice order rounded once."""
    from repro_torch.configs import base as cb
    from repro_torch.models import blocks
    from repro_torch.models.transformer import MOE_TRAIN_CAPACITY

    cfg = cb.get("granite-moe-1b-a400m")
    b, s, d, e, k = 4, 128, cfg.d_model, cfg.n_experts, cfg.experts_per_token
    gates = torch.softmax(torch.randn(b, s, e, generator=gen,
                                      device="cuda"), dim=-1)
    _, topi = blocks.moe_topk(gates, k)
    cap = blocks.moe_capacity(MOE_TRAIN_CAPACITY, k, s, e)
    src, dest_tok = blocks.moe_dispatch(topi, e, cap)
    x = torch.randn(b, s, d, generator=gen, device="cuda").to(
        dtype).requires_grad_(True)
    g = torch.randn(b, e * cap, d, generator=gen, device="cuda").to(dtype)

    def grad():
        return torch.autograd.grad(blocks.DispatchGather.apply(
            x, src, dest_tok, k), x, g)[0]

    first, second = grad(), grad()
    assert torch.equal(first, second)
    rows = torch.cat([g, g.new_zeros(b, 1, d)], 1).float()[
        torch.arange(b, device="cuda")[:, None], dest_tok]
    want = rows.reshape(b, s, k, d)[:, :, 0]
    for j in range(1, k):
        want = want + rows.reshape(b, s, k, d)[:, :, j]
    assert torch.equal(first, want.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_embedding_backward_repeats_itself(gen, dtype):
    """granite's embedding gather at its training shapes (batch 4 x seq
    128 into the (49155, 1024) table, ids drawn from few rows so that many
    meet): two backward passes of F.embedding are bit-equal."""
    table = torch.randn(49155, 1024, generator=gen, device="cuda").to(
        dtype).requires_grad_(True)
    tokens = torch.randint(0, 64, (4, 128), generator=gen, device="cuda")
    dy = torch.randn(4, 128, 1024, generator=gen, device="cuda").to(dtype)

    def grad():
        return torch.autograd.grad(torch.nn.functional.embedding(
            tokens, table), table, dy)[0]

    assert torch.equal(grad(), grad())


# --- recurrentgemma's attention and the recurrent kinds' f32 products -------

WIDE_HEAD_CASES = [
    # b, h, hkv, tq, tk, d, causal, window: recurrentgemma-2b's local
    # attention (MQA 10:1, D 256 > K4_MAX_D: the first scalar kernel) at a
    # prefill its window of 2048 cuts, and one query row over a full
    # 2048-slot ring cache.
    (1, 10, 1, 2300, 2300, 256, True, 2048),
    (2, 10, 1, 1, 2048, 256, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal,window", WIDE_HEAD_CASES)
def test_flash_attention_wide_heads_match_plain(gen, b, h, hkv, tq, tk, d,
                                                causal, window):
    """bf16 K4 at D 256 runs the first scalar kernel (``k4_design``:
    "simt"), counted by no Hopper design, within bf16's tolerance of the
    plain version, the same bits from a second launch."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain, k4_design,
    )

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v = rand(b, h, tq, d), rand(b, hkv, tk, d), rand(b, hkv, tk, d)
    assert k4_design(q, k, v) == "simt"
    before = (flash_attention.launches, flash_attention.wgmma_launches,
              flash_attention.split_launches)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.wgmma_launches,
            flash_attention.split_launches) == (before[0] + 1, *before[1:])
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("g,m,n,k", [(5, 2, 2048, 32), (5, 64, 2048, 32),
                                     (1, 2, 2560, 2560),
                                     (1, 64, 2560, 2560)])
def test_k1_fma_design_at_the_recurrent_shapes(gen, g, m, n, k):
    """The fp32 policy's products of the recurrent kinds on K1's fma
    design: rwkv6's LoRA as 5 groups (streams) of K 32 -> 2048 and
    recurrentgemma's RG-LRU gates, 2560 x 2560, at decode and prefill
    rows; bit-equal to the scalar loop and to a second launch, within
    f32's tolerance of the plain version."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped, \
        mpgemm_plain

    lead = (g,) if g > 1 else ()
    a = torch.randn(*lead, m, k, generator=gen, device="cuda")
    b = torch.randn(*lead, k, n, generator=gen, device="cuda") * k ** -0.5
    fn = mpgemm_grouped if lead else mpgemm
    before = fn.fma_launches
    got = fn(a, b, spec=GemmSpec(grouped=bool(lead)), f32_fma=True)
    again = fn(a, b, spec=GemmSpec(grouped=bool(lead)), f32_fma=True)
    scalar = _k1_scalar(a, b)
    torch.cuda.synchronize()
    assert fn.fma_launches == before + 2
    assert torch.equal(got, again) and torch.equal(got, scalar)
    torch.testing.assert_close(got, mpgemm_plain(a, b), **TOL[torch.float32])


# --- the block planner on the card (core/blocking.py, tuning/) --------------

# Each wgmma library with the operand bytes of A and the payloads it builds
# (None: K1's dense B, whose instantiations differ by the transposes).
WGMMA_LIBRARIES = [
    ("mpgemm_wgmma", 2, None), ("mpgemm_wgmma_int8", 1, None),
    ("mpgemm_wgmma_f32", 4, None),
    ("mpgemm_packed_wgmma", 2, "bfloat16"), ("mpgemm_packed_wgmma", 2, "int8"),
    ("mpgemm_packed_wgmma", 2, "int4"), ("mpgemm_packed_wgmma", 2, "fp8e4m3"),
    ("mpgemm_packed_wgmma_int8", 1, "int8"),
    ("mpgemm_packed_wgmma_int8", 1, "int4"),
    ("mpgemm_sparse_wgmma", 2, "bfloat16"), ("mpgemm_sparse_wgmma", 2, "int8"),
    ("mpgemm_sparse_wgmma_int8", 1, "int8"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,a_bytes,payload", WGMMA_LIBRARIES)
def test_wgmma_stages_match_the_compiled_kernel(gen, name, a_bytes, payload):
    """The planner's eq. (1) (``wgmma_stages``, ``vmem_working_set``) is the
    ring each compiled instantiation reports (``Cfg::kStages``,
    ``Cfg::kSmemBytes``), at both tile rows and every transpose pair."""
    from repro_torch.core.blocking import vmem_working_set, wgmma_stages
    from repro_torch.core.codecs import dtype_bytes
    from repro_torch.kernels.mpgemm import compiled_wgmma_stages

    packed = payload is not None
    b_bytes = dtype_bytes(payload) if packed else a_bytes
    pairs = ([(False, False)] if packed else
             [(False, False), (True, False), (False, True), (True, True)])
    for bm in (64, 128):
        for ta, tb in pairs:
            want = (wgmma_stages(bm, a_bytes, b_bytes, trans_a=ta,
                                 trans_b=tb, packed=packed),
                    vmem_working_set(bm, 128, 128, a_bytes, b_bytes, 4,
                                     trans_a=ta, trans_b=tb, packed=packed))
            assert compiled_wgmma_stages(name, bm, trans_a=ta, trans_b=tb,
                                         payload=payload) == want, (bm, ta,
                                                                    tb)
    assert compiled_wgmma_stages(name, 96, payload=payload) == (0, 0)


def _plan_case(gen, case):
    """(launch(plan=None), plain(), the analytic plan, another plan the
    kernel takes, the plan-cache key the launch reads) of one kernel."""
    from repro_torch.core.blocking import (
        grouped_plan_from_2d, plan_gemm, plan_with_blocks,
    )
    from repro_torch.core.constants import device_spec
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels import mpgemm as K
    from repro_torch.packing.pack import pack_operand
    from repro_torch.sparse import sparsify_magnitude
    from repro_torch.tuning.plan_cache import make_key

    hw = device_spec(0)
    bf16, f32 = torch.bfloat16, torch.float32
    g, fma, layout, key_kw = 1, False, "", {}
    if case in ("k1-bf16", "k1-int8", "k1-tf32x3", "k1-fma", "k1g-bf16"):
        m, k, n, dt = {"k1-bf16": (32, 3072, 1024, bf16),
                       "k1-int8": (32, 2048, 512, torch.int8),
                       "k1-tf32x3": (200, 1024, 256, f32),
                       "k1-fma": (40, 512, 96, f32),
                       "k1g-bf16": (16, 1024, 512, bf16)}[case]
        g, fma = (4 if case == "k1g-bf16" else 1), case == "k1-fma"
        lead = (g,) if g > 1 else ()
        if dt == torch.int8:
            a = torch.randint(-127, 127, (*lead, m, k), generator=gen,
                              device="cuda", dtype=dt)
            b = torch.randint(-127, 127, (*lead, k, n), generator=gen,
                              device="cuda", dtype=dt)
        else:
            a = torch.randn(*lead, m, k, generator=gen, device="cuda").to(dt)
            b = (torch.randn(*lead, k, n, generator=gen, device="cuda")
                 * k ** -0.5).to(dt)
        b_dtype, out = dt, (torch.int32 if dt == torch.int8 else dt)
        fn = K.mpgemm_grouped if g > 1 else K.mpgemm
        spec = GemmSpec(grouped=g > 1)
        design = K.k1_design(a, b, fma)
        if fma:
            key_kw["design"] = "fma"

        def plain():
            return K.mpgemm_plain(a, b)
    else:
        m, k, n = 8, 1024, 768
        w = torch.randn(k, n, generator=gen, device="cuda")
        a = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
        if case == "k2-int4":
            b = pack_operand(w, (128, 128), dtype="int4")
            design, layout = K.k2_design(a, b), "packed"
            key_kw["layout"] = b.layout.tag
        else:
            b = sparsify_magnitude(w, (128, 128), density=0.5, dtype=bf16)
            design, layout = K.k3_design(a, b), "sparse"
            key_kw["sparsity"] = b.layout.tag
        b_dtype, out, fn, spec = b.layout.dtype, bf16, K.mpgemm, GemmSpec()

        def plain():
            return (K.mpgemm_packed_plain if layout == "packed"
                    else K.mpgemm_sparse_plain)(a, b)
    assert design == ("fma" if fma else "tf32x3" if case == "k1-tf32x3"
                      else "wgmma")
    max_count = b.layout.max_column_tiles if layout == "sparse" else None
    kw = dict(hw=hw, design=design, layout=layout, max_count=max_count)
    analytic = plan_gemm(m, n, k, a.dtype, b_dtype, out, g=g, **kw)
    if fma:
        other = plan_with_blocks(m, n, k, 32, 32, 16, a.dtype, b_dtype, out,
                                 g=g, **kw)
    else:
        bm = 192 - analytic.bm          # the other of 64 and 128
        splits, per = {"k1-bf16": (4, 12), "k1-int8": (2, 8),
                       "k1-tf32x3": (1, 32), "k1g-bf16": (2, 8),
                       "k2-int4": (2, 4),
                       "k3-bf16": (2, -(-max_count // 2)) if max_count
                       else (1, 1)}[case]
        other = plan_with_blocks(m, n, k, bm, analytic.bn, analytic.bk,
                                 a.dtype, b_dtype, out, g=g, splits=splits,
                                 per=per, **kw)
    other = grouped_plan_from_2d(other, g)
    key = make_key(m, n, k, a.dtype, b_dtype, out, hw=hw, g=g, **key_kw)

    def launch(plan=None):
        return fn(a, b, spec=spec, out_dtype=out, f32_fma=fma, plan=plan)
    return launch, plain, analytic, other, key


PLAN_CASES = ["k1-bf16", "k1-int8", "k1-tf32x3", "k1-fma", "k1g-bf16",
              "k2-int4", "k3-bf16"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PLAN_CASES)
def test_launch_without_a_plan_is_the_analytic_plan(gen, case):
    """``mpgemm`` without ``plan=`` (the empty default cache: the memoised
    analytic plan) gives the bits of the same launch with the analytic
    plan passed in."""
    from repro_torch.tuning import plan_cache as pc
    pc.set_plan_cache(pc.PlanCache(None))
    try:
        launch, _, analytic, _, _ = _plan_case(gen, case)
        got = launch()
        torch.cuda.synchronize()
        assert torch.equal(got, launch(analytic))
    finally:
        pc.reset_plan_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("case", PLAN_CASES)
def test_tuned_plan_launches_and_holds_the_plain_version(gen, case):
    """A plan with the other tile rows or another split (the fma design:
    another tile) launches, given or from the cache (a ``hit_tuned``
    lookup, the same bits), and holds the plain version within the
    gates; the fma design's tiles keep its bits."""
    from repro_torch.tuning import plan_cache as pc
    cache = pc.PlanCache(None)
    pc.set_plan_cache(cache)
    try:
        launch, plain, analytic, other, key = _plan_case(gen, case)
        assert (other.bm, other.bn, other.split) != (
            analytic.bm, analytic.bn, analytic.split)
        given = launch(other)
        cache.put(key, other)
        hits = pc.lookup_counts()["hit_tuned"]
        cached = launch()
        torch.cuda.synchronize()
        assert pc.lookup_counts()["hit_tuned"] == hits + 1
        assert torch.equal(given, cached)
        want = plain()
        if want.dtype == torch.int32 or case == "k1-fma":
            assert torch.equal(given, want if case != "k1-fma"
                               else launch(analytic))
        torch.testing.assert_close(given.float(), want.float(),
                                   **TOL.get(want.dtype, dict(atol=0,
                                                              rtol=0)))
    finally:
        pc.reset_plan_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_outside_the_kernel_limits_raises(gen, case):
    """A plan the kernel does not take -- bm 96, a slice left empty, a
    ring of other stages -- raises at launch, given or cached: nothing
    clamps it or falls back."""
    import dataclasses
    from repro_torch.tuning import plan_cache as pc
    cache = pc.PlanCache(None)
    pc.set_plan_cache(cache)
    try:
        launch, _, analytic, _, key = _plan_case(gen, case)
        total = analytic.splits * analytic.per
        for bad in (dataclasses.replace(analytic, bm=96),
                    dataclasses.replace(analytic, splits=total + 1, per=1),
                    dataclasses.replace(analytic,
                                        stages=analytic.stages + 1)):
            with pytest.raises(ValueError, match="outside the kernel"):
                launch(bad)
            cache.put(key, bad)
            with pytest.raises(ValueError, match="outside the kernel"):
                launch()
    finally:
        pc.reset_plan_cache()


# --- static int8 storage, the long-sequence attention forms, the pack cache

@pytest.mark.cuda
@pytest.mark.parametrize("grouped", [False, True])
def test_static_int8_mp_dot_on_k1_equals_its_dense_twin(gen, grouped):
    """A ``{"q", "scale"}`` weight is dequantized to bf16 and multiplied on
    K1's wgmma design: bit-equal to the same call on the dequantized
    weight, and within bf16's bound of the plain version."""
    from repro_torch.core.gemm import mp_dot, mp_dot_grouped
    from repro_torch.core.quantization import (
        dequantize_tensor, quantize_tensor,
    )
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped

    lead = (4,) if grouped else ()
    x = torch.randn(*lead, 32, 3072, generator=gen, device="cuda").bfloat16()
    w = quantize_tensor(torch.randn(*lead, 3072, 1024, generator=gen,
                                    device="cuda") * 0.02)
    op, kern = ((mp_dot_grouped, mpgemm_grouped) if grouped
                else (mp_dot, mpgemm))
    before = (kern.launches, kern.wgmma_launches)
    got = op(x, w, policy="bf16")
    torch.cuda.synchronize()
    assert (kern.launches, kern.wgmma_launches) == (before[0] + 1,
                                                    before[1] + 1)
    twin = op(x, dequantize_tensor(w, torch.bfloat16), policy="bf16")
    assert torch.equal(got, twin)
    want = op(x.cpu(), {k: v.cpu() for k, v in w.items()}, policy="bf16")
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("window,form", [(None, "chunked"),
                                         (2048, "banded"), (1024, "banded")])
def test_long_backward_forms_match_the_dense_backward(gen, window, form):
    """t = 4096 on one head group (GQA 4:1, D 64, bf16): the gradients of
    the form ``backward_form`` picks within bf16's bound of the dense
    backward's (the largest |grad| as the scale)."""
    from repro_torch.models import attention as A

    t = 4096
    assert A.backward_form(t, t, causal=True, window=window) == form
    q = torch.randn(1, 4, t, 64, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(1, 1, t, 64, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    do = torch.randn(1, 4, t, 64, generator=gen, device="cuda").bfloat16()
    ts = [a.requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad(
        A.attention_core(*ts, causal=True, window=window), ts, do)
    want = torch.autograd.grad(
        A.dense_attention(*ts, causal=True, window=window), ts, do)
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 1.6e-2 * w.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int4", "int8", "bfloat16"])
def test_pack_cache_disk_hit_equals_a_fresh_k6_pack(gen, fmt, tmp_path):
    from repro_torch.packing import pack as P
    from repro_torch.packing.cache import PackedWeightCache

    w = torch.randn(3072, 8192, generator=gen, device="cuda")
    first = PackedWeightCache(tmp_path).get_or_pack("mlp/w_up", w,
                                                    (128, 128), dtype=fmt)
    launches = P.pack_operand.launches
    cache = PackedWeightCache(tmp_path)
    hit = cache.get_or_pack("mlp/w_up", w, (128, 128), dtype=fmt)
    assert (cache.hits, P.pack_operand.launches) == (1, launches)
    fresh = P.pack_operand(w, (128, 128), dtype=fmt)
    for op in (first, hit):
        assert op.payload.device.type == "cuda"
        assert torch.equal(op.payload.view(torch.uint8),
                           fresh.payload.view(torch.uint8))
        assert (op.scales is None and fresh.scales is None) or torch.equal(
            op.scales, fresh.scales)
