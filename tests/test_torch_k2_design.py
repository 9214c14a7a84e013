"""K2's designs and the rules around them, on the CPU.

* :func:`k2_design` picks the wgmma kernel (``csrc/mpgemm_packed_wgmma.cu``
  for bf16 A, ``_int8.cu`` for int8 A) or the scalar one
  (``csrc/mpgemm_packed.cu``) from the operands alone: the (A dtype,
  payload) pair, 128 x 128 payload tiles, 16-byte rows and bases.
* :func:`k2_split` cuts the payload's K tiles into slices of whole tiles,
  the grid within one wave of the SMs.
* Plain-torch emulations of the wgmma design's arithmetic are held against
  the reference's packed ``mp_dot`` / ``mp_dot_grouped`` under the
  ``interpret`` backend (the Pallas packed-B body): bf16 A takes each
  payload value decoded, times its tile's scale in f32, rounded to bf16,
  a tile's partial summed in f32 over its two 64-row stages and folded
  as ``acc = acc + partial``; int8 A takes one exact int32 partial a
  payload tile folded as ``acc = acc + float(partial) · tile_scale``;
  both in K-tile order, and the slices of the split sum in slice order.  2-D and grouped, int4, int8, fp8 and bf16 payloads.
  Tolerances: bf16 outputs atol = rtol = 1.6e-2 (one bf16 ulp: the f32
  sums run in another order and the output rounding may land on either
  side), f32 outputs atol = rtol = 1e-5 (summation order only).
"""
import importlib.util
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import config as jcfg  # noqa: E402
from repro.core.gemm import mp_dot as jax_mp_dot  # noqa: E402
from repro.core.gemm import mp_dot_grouped as jax_mp_dot_grouped  # noqa: E402
from repro.packing import pack as jpack  # noqa: E402
from repro_torch.core.policy import quantize_per_tensor  # noqa: E402
from repro_torch.kernels.mpgemm import (  # noqa: E402
    H100_SMS, K2_WGMMA_TILE, k1_wgmma_bm, k2_design, k2_split,
)
from repro_torch.packing import pack as tpack  # noqa: E402
from repro_torch.packing.layout import PackedLayout, PackedOperand  # noqa
from repro_torch.packing.params import default_blocks  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
TOL = {torch.bfloat16: dict(atol=1.6e-2, rtol=1.6e-2),
       torch.float32: dict(atol=1e-5, rtol=1e-5)}
DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operand(k, n, payload, g=1, blocks=None):
    """A packed operand of the right shapes over one element (the rule
    reads dtypes, shapes and addresses, never values)."""
    bk, bn = blocks or default_blocks(k, n)
    layout = PackedLayout(k=k, n=n, bk=bk, bn=bn, dtype=payload,
                          orig_dtype="float32", g=g)
    scales = (torch.empty(1).expand(layout.scales_shape)
              if layout.per_tile_scales else None)
    return PackedOperand(torch.empty(1, dtype=layout.storage_dtype).expand(
        layout.payload_shape), scales, layout)


def _a(m, k, dtype, g=1):
    return torch.empty(1, dtype=dtype).expand((g, m, k) if g > 1 else (m, k))


# --- the design rule --------------------------------------------------------

def _chip_smoke_k2_cases():
    cs = _chip_smoke()
    cases = [(name, k, n, combo, 1) for name, k, n, *_ in cs.MAIN_SHAPES
             for combo in cs.K2_COMBOS]
    cases += [(name, k, n, combo, 1)
              for name, k, n, dt, _, _ in cs.GRANITE_2D_SHAPES
              if name in ("wq/wo", "wk/wv")
              for combo in cs.SERVED_K2_COMBOS]
    cases += [(name, k, n, combo, cs.GRANITE_EXPERTS)
              for name, k, n, *_ in cs.GROUPED_SHAPES
              for combo in cs.K2G_COMBOS]
    return cases


@pytest.mark.parametrize("name,k,n,combo,g", _chip_smoke_k2_cases())
@pytest.mark.parametrize("m", [2, 32])
def test_k2_design_of_every_chip_smoke_case(name, k, n, combo, g, m):
    """Every K2 case of chip_smoke.py's phases 5 and 6 -- phi3-mini's
    projections and head, granite's attention and grouped expert stacks,
    decode and a 16-token chunk pair -- takes the wgmma design."""
    policy, payload = combo
    a = _a(m, k, DTYPES[policy], g)
    assert k2_design(a, _operand(k, n, payload, g)) == "wgmma", name


@pytest.mark.parametrize("a_dtype,payload,want", [
    ("bf16", "bfloat16", "wgmma"), ("bf16", "int8", "wgmma"),
    ("bf16", "int4", "wgmma"), ("bf16", "fp8e4m3", "wgmma"),
    ("int8", "int8", "wgmma"), ("int8", "int4", "wgmma"),
    ("int8", "fp8e4m3", "simt"),            # the reference's f32 branch
    ("f32", "float32", "simt"), ("f32", "int8", "simt"),
    ("f32", "int4", "simt"), ("f32", "fp8e4m3", "simt"),
])
def test_k2_design_by_pair(a_dtype, payload, want):
    a = _a(2, 512, DTYPES[a_dtype])
    assert k2_design(a, _operand(512, 384, payload)) == want


@pytest.mark.parametrize("blocks", [(128, 64), (64, 128), (33, 16),
                                    (256, 128), (100, 128)])
def test_k2_design_takes_128_by_128_tiles_only(blocks):
    """Other tiles (the CPU tests' ragged blocks, K or N below 128 under
    default_blocks) stay on the scalar kernel."""
    assert K2_WGMMA_TILE == (128, 128)
    b = _operand(512, 384, "int4", blocks=blocks)
    assert k2_design(_a(2, 512, torch.bfloat16), b) == "simt"
    assert k2_design(_a(2, 100, torch.bfloat16),
                     _operand(100, 384, "int4")) == "simt"   # bk = 100


@pytest.mark.parametrize("a_dtype,k", [("bf16", 300), ("bf16", 1028),
                                       ("int8", 1032), ("int8", 200)])
def test_k2_design_sends_rows_off_16_bytes_to_simt(a_dtype, k):
    """A's rows must be multiples of 16 bytes (TMA's rule): K % 8 for
    bf16, K % 16 for int8."""
    b = _operand(k, 256, "int8")
    assert k2_design(_a(4, k, DTYPES[a_dtype]), b) == "simt"


@pytest.mark.parametrize("which", ["a", "payload"])
def test_k2_design_sends_a_misaligned_view_to_simt(which):
    """A contiguous view whose base is off a 16-byte boundary."""
    k, n = 512, 256
    b = _operand(k, n, "int8")
    a = _a(2, k, torch.bfloat16)
    if which == "a":
        base = torch.empty(2 * k + 1, dtype=torch.bfloat16)
        a = base[1:].view(2, k)
        assert a.is_contiguous() and a.data_ptr() % 16
    else:
        base = torch.empty(2, dtype=torch.int8)
        b = PackedOperand(base[1:].expand(b.payload.shape), b.scales,
                          b.layout)
        assert b.payload.data_ptr() % 16
    assert k2_design(a, b) == "simt"
    assert k2_design(_a(2, k, torch.bfloat16), _operand(k, n, "int8")) == \
        "wgmma"


def test_k2_design_sends_empty_operands_to_simt():
    assert k2_design(_a(0, 512, torch.bfloat16),
                     _operand(512, 256, "int4")) == "simt"


# --- the split over payload tiles -------------------------------------------

@pytest.mark.parametrize("m,n,k,g", [
    (2, 3072, 3072, 1), (2, 8192, 3072, 1), (2, 3072, 8192, 1),
    (32, 32064, 3072, 1), (2, 1024, 1024, 1), (2, 512, 1024, 32),
    (32, 1024, 512, 32), (130, 200, 304, 1), (2, 128, 100000, 1),
])
def test_k2_split_is_whole_payload_tiles_in_one_wave(m, n, k, g):
    """The wrapper's slices: whole 128-deep payload tiles (two 64-deep
    stages a tile for bf16 A), none empty, every stage in one; the grid
    within one wave of the SMs unless the output tiles alone pass it."""
    splits, per = k2_split(m, n, k, g)
    assert (splits, per) == k2_split(m, n, k, g)
    tiles = -(-k // 128)
    assert (splits - 1) * per < tiles <= splits * per
    for stage_k in (64, 128):
        per_stage = per * (128 // stage_k)
        stages = -(-k // stage_k)
        assert (splits - 1) * per_stage < stages <= splits * per_stage
    blocks = g * -(-m // k1_wgmma_bm(m)) * -(-n // 128)
    assert blocks * splits <= H100_SMS or splits == 1


def test_k2_split_examples():
    """phi3's 3072-wide projections at M = 2: 24 output tiles, 24 payload
    tiles -> 5 slices of 5 (120 blocks); its 8192-wide ones (64 tiles): 2
    slices; granite's attention (8 tiles, 8 payload tiles): a slice a
    tile; granite's expert stacks (32 x 4 = 128 tiles): one."""
    assert k2_split(2, 3072, 3072) == (5, 5)
    assert k2_split(2, 8192, 3072) == (2, 12)
    assert k2_split(2, 3072, 8192) == (5, 13)
    assert k2_split(2, 1024, 1024) == (8, 1)
    assert k2_split(2, 512, 1024, 32) == (1, 8)
    assert k2_split(2, 1024, 512, 32) == (1, 4)


# --- the design's arithmetic against the reference --------------------------

def _tiles(b):
    """(g, nkb, nnb, bk, bn) decoded payload values before their scale,
    and (g, nkb, nnb) scales (None for a float payload)."""
    layout = b.layout
    payload = b.payload.reshape(layout.g, layout.nkb, layout.nnb,
                                *layout.payload_tile)
    tiles = tpack.decode_payload_tiles(payload, layout)
    scales = (None if b.scales is None
              else b.scales.reshape(layout.g, layout.nkb, layout.nnb))
    return tiles, scales


def _emulate(a, b, scale, splits):
    """The wgmma design's sum (G, M, N) f32 before the epilogue."""
    layout = b.layout
    g, nkb, nnb, bk, bn = (layout.g, layout.nkb, layout.nnb, layout.bk,
                           layout.bn)
    a3 = (a if a.dim() == 3 else a[None])
    m = a3.shape[1]
    ap = torch.nn.functional.pad(a3, (0, nkb * bk - layout.k))
    tiles, scales = _tiles(b)
    per = -(-nkb // splits)
    out = torch.zeros(g, m, nnb * bn)
    for s in range(splits):                      # slice order
        acc = torch.zeros(g, m, nnb * bn)
        for kt in range(s * per, min(nkb, (s + 1) * per)):
            a_t = ap[:, :, kt * bk:(kt + 1) * bk]
            w_t = tiles[:, kt].permute(0, 2, 1, 3).reshape(g, bk, nnb * bn)
            if a.dtype == torch.int8:
                part = (a_t.double() @ w_t.double()).float()
                ts = scales[:, kt].float().repeat_interleave(bn, dim=-1)
                acc = acc + part * ts[:, None, :]
            else:
                if scales is not None:        # decoded, scaled, rounded
                    w_t = (tiles[:, kt].float()
                           * scales[:, kt].float()[..., None, None]).to(
                               torch.bfloat16)
                    w_t = w_t.permute(0, 2, 1, 3).reshape(g, bk, nnb * bn)
                part = torch.zeros(g, m, nnb * bn)
                for st in range(0, bk, 64):     # two 64-deep stages
                    part = part + a_t[:, :, st:st + 64].float() @ \
                        w_t[:, st:st + 64].float()
                acc = acc + part                # folded a tile at a time
        out = out + acc
    out = out[..., :layout.n]
    if scale is not None:
        out = out * scale
    return out if a.dim() == 3 else out[0]


def _draw(rng, shape, scale=1.0, bf16=True):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32) if bf16 else x


PAIRS = [("bf16", "bfloat16"), ("bf16", "int8"), ("bf16", "int4"),
         ("bf16", "fp8e4m3"), ("int8", "int8"), ("int8", "int4")]


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("policy,payload", PAIRS)
@pytest.mark.parametrize("g,m,k,n", [(1, 5, 304, 200), (3, 2, 384, 136)])
def test_wgmma_arithmetic_matches_reference(g, m, k, n, policy, payload,
                                            splits):
    """K = 304 is three payload tiles with a 48-row tail (zero-padded in
    the payload, zero-filled in A); N = 200 a ragged column tile; the
    grouped case three experts of two rows.  Under the int8 policy A is
    the per-tensor int8 x and ``sx`` the epilogue's scale, as ``mp_dot``
    hands K2."""
    rng = np.random.default_rng(31 * k + splits)
    lead = (g,) if g > 1 else ()
    x = _draw(rng, (*lead, m, k))
    w = _draw(rng, (*lead, k, n), scale=(2.0 / (k + n)) ** 0.5, bf16=False)
    w_j = jpack.pack_operand(jnp.asarray(w), (128, 128), dtype=payload,
                             backend="xla")
    w_t = tpack.pack_operand(torch.from_numpy(w), (128, 128), dtype=payload)
    jfn = jax_mp_dot_grouped if g > 1 else jax_mp_dot
    with jcfg.gemm_backend("interpret"):
        want = np.asarray(jfn(jnp.asarray(x), w_j, policy=policy)).astype(
            np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    a, scale = quantize_per_tensor(xt) if policy == "int8" else (xt, None)
    assert k2_design(a, w_t) == "wgmma"
    got = _emulate(a, w_t, scale, splits).to(torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **TOL[torch.bfloat16])
