"""K1's two designs and the rules around them, on the CPU.

* :func:`k1_design` picks the wgmma kernel (``csrc/mpgemm_wgmma.cuh``,
  built for bf16 and for int8) or the scalar one (``csrc/mpgemm.cu``)
  from the operands alone: both bf16 or both int8, no empty extent, every
  row stride and base pointer a multiple of 16 bytes.
* :func:`k1_split` cuts K for the wgmma kernel when the output has fewer
  tiles than the card has SMs, in K tiles of 128 bytes (64 bf16, 128
  int8).
* The launch counts ``chip_smoke.py`` asserts on the card for the wgmma
  designs (``_want_train_launches``'s ``k1_wgmma`` / ``k1g_wgmma`` and
  K4's ``k4_wgmma`` / ``k4_split``) equal the wrapper calls of one CPU
  training step that the rules send there.
* ``trans_a`` against a packed (K2) or tile-sparse (K3) operand, 2-D and
  grouped, matches the reference (``interpret``, the Pallas bodies).
  Tolerances: f32 outputs atol = rtol = 1e-4 (the two packages sum the K
  products in another order, K <= 200); bf16 outputs atol = rtol =
  1.6e-2, one bf16 ulp at |y| up to 2, since another order can put the
  f32 sum on the other side of a bf16 rounding.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import sparse as js  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.mpgemm import mpgemm_grouped_pallas  # noqa: E402
from repro.packing import pack_operand as jax_pack  # noqa: E402
from repro_torch import sparse as ts  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.core import gemm as gemm_mod  # noqa: E402
from repro_torch.core.gemm_spec import GemmSpec  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, device_batch  # noqa: E402
from repro_torch.kernels import mpgemm as tk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import k4_design  # noqa: E402
from repro_torch.kernels.mpgemm import k1_design, k1_split  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.packing.pack import pack_operand  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=1.6e-2, rtol=1.6e-2)
REPO = os.path.join(os.path.dirname(__file__), "..")
BF = torch.bfloat16


def _aligned(*shape, dtype=BF):
    return torch.zeros(*shape, dtype=dtype)


def _misaligned(*shape):
    """A contiguous bf16 view that starts 2 bytes past an aligned base."""
    base = torch.zeros(int(np.prod(shape)) + 1, dtype=BF)
    assert base.data_ptr() % 16 == 0
    return base[1:].view(*shape)


# --- the design rule ----------------------------------------------------------

@pytest.mark.parametrize("case,a,b,want", [
    ("A (M, K) x B (K, N)", (2, 3072), (3072, 3072), "wgmma"),
    ("trans_b: B (N, K)", (2, 1024), (49280, 1024), "wgmma"),
    ("trans_a: A (K, M)", (512, 1024), (512, 1024), "wgmma"),
    ("trans_a + trans_b", (136, 72), (200, 136), "wgmma"),
    ("grouped", (32, 2, 1024), (32, 1024, 512), "wgmma"),
    ("grouped trans_a", (32, 160, 1024), (32, 160, 512), "wgmma"),
    ("M = 1 rows of K", (1, 64), (64, 8), "wgmma"),
    ("op-API rows of 101", (48, 101), (101, 40), "simt"),
    ("B rows of 77", (5, 200), (200, 77), "simt"),
    ("trans_a rows of M = 2", (1024, 2), (1024, 512), "simt"),
    ("K = 1", (17, 1), (1, 8), "simt"),
    ("empty K", (4, 0), (0, 8), "simt"),
])
def test_k1_design_by_shape(case, a, b, want):
    assert k1_design(_aligned(*a), _aligned(*b)) == want, case


@pytest.mark.parametrize("a_dtype,b_dtype,want", [
    (torch.float32, torch.float32, "simt"), (torch.int8, torch.int8, "wgmma"),
    (BF, torch.float32, "simt"), (torch.float16, torch.float16, "simt"),
    (torch.int8, BF, "simt"), (BF, BF, "wgmma")])
def test_k1_design_takes_bf16_only(a_dtype, b_dtype, want):
    """The operand types the wgmma design takes: bf16 x bf16 and (since
    its int8 instantiation) int8 x int8; f32, fp16 and mixed pairs stay
    scalar."""
    assert k1_design(_aligned(64, 64, dtype=a_dtype),
                     _aligned(64, 64, dtype=b_dtype)) == want


I8 = torch.int8


@pytest.mark.parametrize("case,a,b,want", [
    ("A (M, K) x B (K, N)", (2, 3072), (3072, 3072), "wgmma"),
    ("trans_b: B (N, K)", (2, 1024), (49280, 1024), "wgmma"),
    ("trans_a: A (K, M)", (512, 1024), (512, 1024), "wgmma"),
    ("grouped", (32, 2, 1024), (32, 1024, 512), "wgmma"),
    ("rows of 8 int8 values", (16, 8), (8, 32), "simt"),
    ("B rows of 72", (4, 64), (64, 72), "simt"),
    ("trans_a rows of M = 2", (1024, 2), (1024, 512), "simt"),
    ("trans_a rows of M = 40", (256, 40), (256, 64), "simt"),
    ("empty K", (4, 0), (0, 16), "simt"),
])
def test_k1_design_int8_by_shape(case, a, b, want):
    """int8 rows are 16-byte aligned at multiples of 16 values."""
    got = k1_design(_aligned(*a, dtype=I8), _aligned(*b, dtype=I8))
    assert got == want, case


def test_k1_design_sends_a_misaligned_int8_view_to_simt():
    base = torch.zeros(64 * 64 + 16, dtype=I8)
    a = base[8:-8].view(64, 64)
    assert a.is_contiguous() and a.data_ptr() % 16
    assert k1_design(a, _aligned(64, 64, dtype=I8)) == "simt"
    assert k1_design(base[16:].view(64, 64), _aligned(64, 64, dtype=I8)) \
        == "wgmma"


@pytest.mark.parametrize("which", ["a", "b", "grouped a"])
def test_k1_design_sends_a_misaligned_view_to_simt(which):
    """``a.contiguous()`` of a slice can start off a 16-byte boundary: the
    rule reads the pointer, not only the shape."""
    if which == "grouped a":
        a, b = _misaligned(2, 8, 64), _aligned(2, 64, 128)
    elif which == "a":
        a, b = _misaligned(8, 64), _aligned(64, 128)
    else:
        a, b = _aligned(8, 64), _misaligned(64, 128)
    assert a.is_contiguous() and b.is_contiguous()
    assert k1_design(a, b) == "simt"
    # A row slice of an aligned tensor with 16-byte rows stays aligned.
    assert k1_design(_aligned(9, 64)[1:], _aligned(64, 128)) == "wgmma"


# --- the split rule ---------------------------------------------------------

SPLIT_SHAPES = [  # (m, n, k, g): decode, prefill, granite, Table III
    (2, 3072, 3072, 1), (2, 8192, 3072, 1), (2, 3072, 8192, 1),
    (2, 32128, 3072, 1), (32, 3072, 3072, 1), (2, 1024, 1024, 1),
    (2, 512, 1024, 1), (2, 49280, 1024, 1), (2, 512, 1024, 32),
    (2, 1024, 512, 32), (64, 2112, 7168, 1), (128, 7168, 2048, 1),
    (4096, 256, 4096, 1), (4096, 24576, 1536, 1), (1024, 1024, 512, 1),
    (2, 3072, 64, 1), (2, 3072, 100, 1), (2, 3072, 1, 1), (2, 200, 136, 1),
]


@pytest.mark.parametrize("m,n,k,g", SPLIT_SHAPES)
def test_k1_split(m, n, k, g):
    """Tiles x slices reach the SMs where K allows; every slice at least
    one BK deep (the last may hold K's tail), none empty, together
    covering K once in slice order; the same answer every call."""
    splits, per = k1_split(m, n, k, g)
    assert (splits, per) == k1_split(m, n, k, g)
    k_tiles = -(-k // tk.WGMMA_BK)
    tiles = g * -(-m // tk.k1_wgmma_bm(m)) * -(-n // tk.WGMMA_BN)
    slices = [(s * per, min(k_tiles, (s + 1) * per)) for s in range(splits)]
    assert slices[0][0] == 0 and slices[-1][1] == k_tiles
    assert all(lo < hi for lo, hi in slices)
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    if tiles >= tk.H100_SMS:
        assert splits == 1
    else:
        assert tiles * splits >= tk.H100_SMS or splits == k_tiles
    assert g * splits <= 65535


@pytest.mark.parametrize("m,n,k,g", SPLIT_SHAPES)
def test_k1_split_int8(m, n, k, g):
    """The same rule at int8's K tile of 128 values: slices cover K once,
    none empty, each at least one tile deep."""
    bk = tk.k1_wgmma_bk(torch.int8)
    assert bk == tk.WGMMA_BK_INT8 == 128
    splits, per = k1_split(m, n, k, g, bk=bk)
    k_tiles = -(-k // bk)
    tiles = g * -(-m // tk.k1_wgmma_bm(m)) * -(-n // tk.WGMMA_BN)
    slices = [(s * per, min(k_tiles, (s + 1) * per)) for s in range(splits)]
    assert slices[0][0] == 0 and slices[-1][1] == k_tiles
    assert all(lo < hi for lo, hi in slices)
    if tiles >= tk.H100_SMS:
        assert splits == 1
    else:
        assert tiles * splits >= tk.H100_SMS or splits == k_tiles


def test_k1_split_int8_examples():
    """phi3's int8 decode projections at M = 2: 24 tiles, 24 K tiles of
    128 -> 6 slices of 4; granite's: 8 tiles, 8 K tiles -> 8 slices."""
    assert k1_split(2, 3072, 3072, bk=128) == (6, 4)
    assert k1_split(2, 1024, 1024, bk=128) == (8, 1)
    assert tk.k1_wgmma_bk(BF) == tk.WGMMA_BK == 64


def test_k1_split_examples():
    """phi3's decode projections at M = 2: 24 tiles, 48 K tiles -> 6
    slices of 8; granite's 1024-wide attention: 8 tiles, 16 K tiles -> 16
    slices of one BK; enough tiles -> one slice."""
    assert k1_split(2, 3072, 3072) == (6, 8)
    assert k1_split(2, 1024, 1024) == (16, 1)
    assert k1_split(4096, 24576, 1536) == (1, 24)
    assert k1_split(2, 3072, 640, sms=264) == (10, 1)


# --- the launch counts chip_smoke.py asserts for the wgmma design ------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,policy", [
    ("phi3-mini-3.8b", "bf16"), ("granite-moe-1b-a400m", "bf16"),
    ("phi3-mini-3.8b", "int8"), ("granite-moe-1b-a400m", "int8")])
def test_chip_smoke_wgmma_counts_match_the_rule(arch, policy, monkeypatch):
    """One CPU training step with remat: the K1 wrapper calls that
    :func:`k1_design` sends to wgmma (every bf16 and int8 one of the smoke
    model, whose widths are multiples of 16) and the K4 calls that
    :func:`k4_design` sends to its wgmma and split designs number what
    ``chip_smoke.py`` asserts on the card."""
    counts = {"k1_wgmma": 0, "k1g_wgmma": 0, "k4_wgmma": 0, "k4_split": 0}

    def gemm(name, inner):
        def call(a, b, *, spec, **kw):
            if isinstance(b, torch.Tensor) and k1_design(a, b) == "wgmma":
                counts[name] += 1
            return inner(a, b, spec=spec, **kw)
        return call

    monkeypatch.setattr(gemm_mod, "mpgemm", gemm("k1_wgmma",
                                                 gemm_mod.mpgemm))
    monkeypatch.setattr(gemm_mod, "mpgemm_grouped",
                        gemm("k1g_wgmma", gemm_mod.mpgemm_grouped))
    attention = attn_mod.flash_attention

    def flash(q, k, v, **kw):
        design = k4_design(q, k, v)
        if design != "simt":
            counts[f"k4_{design}"] += 1
        return attention(q, k, v, **kw)

    monkeypatch.setattr(attn_mod, "flash_attention", flash)
    cfg = tcb.get(arch, smoke=True)
    model = build_model(cfg, policy=policy, device="cpu")
    params = model.init_train(torch.Generator().manual_seed(0))
    batch = device_batch(SyntheticLM(model.cfg.vocab, 2, 16).next_batch(),
                         "cpu")
    make_train_step(model, AdamWConfig())(params, adamw_init(params), batch)
    want = _chip_smoke()._want_train_launches(model.cfg, seq=16,
                                              policy=policy)
    assert counts == {k: want[k] for k in counts}
    assert counts["k1_wgmma"] > 0


# --- trans_a against a packed or sparse B ------------------------------------

def _f32(rng, shape, bf16=False):
    a = rng.standard_normal(shape).astype(np.float32)
    if bf16:
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


def _both(a, bf16):
    if bf16:
        return jnp.asarray(a.astype(ml_dtypes.bfloat16)), \
            torch.from_numpy(a).to(BF)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("payload", ["bfloat16", "int8", "int4", "fp8e4m3"])
def test_packed_trans_a_matches_reference(payload, grouped):
    """K2 with A read (K, M), (G, K, M) grouped: bf16 A against a bf16
    payload, f32 A against the codec payloads (tile dequant in the
    reference's order)."""
    rng = np.random.default_rng(21)
    lead = (3,) if grouped else ()
    m, k, n, blocks = 20, 96, 64, (32, 32)
    bf16 = payload == "bfloat16"
    aj, at = _both(_f32(rng, (*lead, k, m), bf16), bf16)
    w = _f32(rng, (*lead, k, n)) * 0.1
    pj = jax_pack(jnp.asarray(w), blocks, dtype=payload)
    pt = pack_operand(torch.from_numpy(w), blocks, dtype=payload)
    if grouped:
        want = mpgemm_grouped_pallas(aj, pj, trans_a=True,
                                     interpret=True)
        got = tk.mpgemm_grouped(at, pt,
                                spec=GemmSpec(grouped=True, trans_a=True))
    else:
        want = jops.mpgemm(aj, pj, trans_a=True, interpret=True)
        got = ops.mpgemm(at, pt, trans_a=True)
    assert got.shape == (*lead, m, n) and got.dtype == (BF if bf16 else
                                                         torch.float32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **(BF16 if bf16 else F32))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("payload", ["bfloat16", "int8"])
def test_sparse_trans_a_matches_reference(payload, grouped):
    """K3 with A read (K, M): bf16 A against bf16 tiles, f32 A against
    int8 tiles (each dequantized by its scale), an empty column
    included."""
    rng = np.random.default_rng(22)
    lead = (3,) if grouped else ()
    m, k, n, blocks = 20, 96, 64, (32, 16)
    bf16 = payload == "bfloat16"
    aj, at = _both(_f32(rng, (*lead, k, m), bf16), bf16)
    w = _f32(rng, (*lead, k, n)) * 0.1
    keep = rng.random((*lead, 3, 4)) < 0.5
    keep[..., 1] = False
    keep[..., 0, 0] = True
    sj = js.sparsify_with_mask(jnp.asarray(w), blocks, keep, dtype=payload)
    st = ts.sparsify_with_mask(torch.from_numpy(w), blocks, keep,
                               dtype=payload)
    if grouped:
        want = mpgemm_grouped_pallas(aj, sj, trans_a=True,
                                     interpret=True)
        got = tk.mpgemm_grouped(at, st,
                                spec=GemmSpec(grouped=True, trans_a=True))
    else:
        want = jops.mpgemm(aj, sj, trans_a=True, interpret=True)
        got = ops.mpgemm(at, st, trans_a=True)
    assert got.shape == (*lead, m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **(BF16 if bf16 else F32))
    assert (got[..., 16:32] == 0).all()          # the empty column tile
