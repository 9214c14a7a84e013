"""K3's designs and the rules around them, on the CPU.

* :func:`k3_design` picks the wgmma kernel (``csrc/mpgemm_sparse_wgmma.cu``
  for bf16 A, ``_int8.cu`` for int8 A) or the scalar one
  (``csrc/mpgemm_sparse.cu``) from the operands alone: the (A dtype,
  payload) pair, 128 x 128 tiles, 16-byte rows and bases, no empty
  operand.
* :func:`k3_split` cuts the longest column's stored tiles into slices of
  whole tiles, the grid within one wave of the SMs; shorter columns leave
  later slices empty.
* A plain-torch emulation of the wgmma design's arithmetic is held against
  the reference's tile-sparse ``mp_dot`` / ``mp_dot_grouped`` under the
  ``interpret`` backend (the Pallas ``sparse_kernel`` over its stored-tile
  schedule): each column walks its stored tiles in payload order, in
  slices of whole tiles; a bf16 tile's product is summed in f32 over its
  two 64-row stages and folded as ``acc = acc + partial``, an int8 tile
  against bf16 A is decoded, times its scale in f32, rounded to bf16
  first; an int8 tile against int8 A gives one exact int32 partial folded
  as ``acc = acc + float(partial) · tile_scale``; the slices are summed in
  slice order.  2-D and grouped, an empty column, a K tail (K = 304 over
  128-deep tiles: 48 rows) and an N tail (N = 300: a 44-wide column).
  Tolerances: bf16 outputs atol = rtol = 1.6e-2 (one bf16 ulp: the f32
  sums run in another order, and the output rounding may land on either
  side).
"""
import importlib.util
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import sparse as js  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.core.gemm import mp_dot as jax_mp_dot  # noqa: E402
from repro.core.gemm import mp_dot_grouped as jax_mp_dot_grouped  # noqa: E402
from repro_torch import sparse as ts  # noqa: E402
from repro_torch.core.policy import quantize_per_tensor  # noqa: E402
from repro_torch.kernels.mpgemm import (  # noqa: E402
    H100_SMS, K3_WGMMA_TILE, k1_wgmma_bm, k3_design, k3_split,
)
from repro_torch.sparse.layout import (  # noqa: E402
    TileSparseLayout, TileSparseOperand,
)

REPO = os.path.join(os.path.dirname(__file__), "..")
BF16 = dict(atol=1.6e-2, rtol=1.6e-2)
DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8, "f32": torch.float32}
PAIRS = [("bf16", "bfloat16"), ("bf16", "int8"), ("int8", "int8")]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operand(k, n, payload, g=1, blocks=(128, 128), per_column=1):
    """A tile-sparse operand of the right shapes and a structure of
    ``per_column`` stored tiles a column, over one payload element (the
    rule reads dtypes, shapes and addresses, never values)."""
    bk, bn = blocks
    nkb, nnb = -(-k // bk), -(-n // bn)
    per = min(per_column, nkb)
    cols = g * nnb
    layout = TileSparseLayout(
        k=k, n=n, bk=bk, bn=bn, dtype=payload, orig_dtype="float32",
        indptr=tuple(per * c for c in range(cols + 1)),
        indices=tuple(i for _ in range(cols) for i in range(per)), g=g)
    storage = torch.int8 if payload == "int8" else DTYPES[
        {"bfloat16": "bf16", "float32": "f32"}[payload]]
    scales = (torch.empty(1).expand(layout.scales_shape)
              if layout.per_tile_scales else None)
    return TileSparseOperand(
        torch.empty(1, dtype=storage).expand(layout.payload_shape), scales,
        layout)


def _a(m, k, dtype, g=1):
    return torch.empty(1, dtype=dtype).expand((g, m, k) if g > 1 else (m, k))


# --- the design rule --------------------------------------------------------

def _chip_smoke_k3_cases():
    """(name, k, n, A dtype, payload, g) of every phase_k3 case but the
    edge one (its K is 3000: rows of 3000 values)."""
    cs = _chip_smoke()
    cases = [(name, k, n, policy, dtype, 1) for name, k, n, *_ in
             cs.MAIN_SHAPES
             for policy, dtype in (("bf16", "bfloat16"), ("int8", "int8"))]
    cases += [(name, k, n, "int8", "int8", 1)
              for name, k, n, *_ in cs.GRANITE_2D_SHAPES
              if name in ("wq/wo", "wk/wv")]
    cases += [(name, k, n, "int8", "int8", cs.GRANITE_EXPERTS)
              for name, k, n, *_ in cs.GROUPED_SHAPES]
    return cases


@pytest.mark.parametrize("name,k,n,policy,payload,g", _chip_smoke_k3_cases())
@pytest.mark.parametrize("m", [2, 32])
def test_k3_design_of_every_chip_smoke_case(name, k, n, policy, payload, g,
                                            m):
    """Every K3 case of chip_smoke.py's phase_k3 and of its served sparse
    paths -- phi3-mini's projections and head in bf16 and int8, granite's
    attention and grouped expert stacks under int8 N:M -- takes the wgmma
    design, at decode and at a 32-row chunk."""
    assert tuple(_chip_smoke().SPARSE_BLOCKS) == K3_WGMMA_TILE
    a = _a(m, k, DTYPES[policy], g)
    assert k3_design(a, _operand(k, n, payload, g)) == "wgmma", name


@pytest.mark.parametrize("policy,k,want", [("bf16", 3000, "wgmma"),
                                           ("int8", 3000, "simt")])
def test_k3_design_of_chip_smoke_edge_case(policy, k, want):
    """phase_k3's edge case (K = 3000, a K tail): bf16 rows of 3000 values
    are 6000 bytes, a multiple of 16; int8 rows of 3000 bytes are not, so
    the int8 edge case runs the scalar kernel."""
    payload = "int8" if policy == "int8" else "bfloat16"
    assert k3_design(_a(2, k, DTYPES[policy]),
                     _operand(k, 3072, payload)) == want


@pytest.mark.parametrize("a_dtype,payload,want", [
    ("bf16", "bfloat16", "wgmma"), ("bf16", "int8", "wgmma"),
    ("int8", "int8", "wgmma"),
    ("f32", "float32", "simt"), ("f32", "int8", "simt"),
])
def test_k3_design_by_pair(a_dtype, payload, want):
    a = _a(2, 512, DTYPES[a_dtype])
    assert k3_design(a, _operand(512, 384, payload)) == want


@pytest.mark.parametrize("blocks", [(128, 64), (64, 128), (32, 32),
                                    (256, 128), (100, 128)])
def test_k3_design_takes_128_by_128_tiles_only(blocks):
    """Other tiles (the CPU tests' and the smoke configs' ragged blocks)
    stay on the scalar kernel."""
    assert K3_WGMMA_TILE == (128, 128)
    b = _operand(512, 384, "bfloat16", blocks=blocks)
    assert k3_design(_a(2, 512, torch.bfloat16), b) == "simt"


@pytest.mark.parametrize("a_dtype,k", [("bf16", 300), ("bf16", 1028),
                                       ("int8", 1032), ("int8", 200)])
def test_k3_design_sends_rows_off_16_bytes_to_simt(a_dtype, k):
    """A's rows must be multiples of 16 bytes (TMA's rule): K % 8 for
    bf16, K % 16 for int8."""
    payload = "int8" if a_dtype == "int8" else "bfloat16"
    b = _operand(k, 256, payload)
    assert k3_design(_a(4, k, DTYPES[a_dtype]), b) == "simt"


@pytest.mark.parametrize("which", ["a", "payload"])
def test_k3_design_sends_a_misaligned_view_to_simt(which):
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
        b = TileSparseOperand(base[1:].expand(b.payload.shape), b.scales,
                              b.layout)
        assert b.payload.data_ptr() % 16
    assert k3_design(a, b) == "simt"
    assert k3_design(_a(2, k, torch.bfloat16), _operand(k, n, "int8")) == \
        "wgmma"


def test_k3_design_sends_empty_operands_to_simt():
    assert k3_design(_a(0, 512, torch.bfloat16),
                     _operand(512, 256, "bfloat16")) == "simt"


# --- the split over a column's stored tiles ----------------------------------

@pytest.mark.parametrize("m,n,count,g", [
    (2, 3072, 18, 1), (2, 8192, 18, 1), (2, 3072, 40, 1),
    (32, 32128, 20, 1), (2, 1024, 4, 1), (2, 512, 4, 32),
    (32, 1024, 2, 32), (130, 200, 3, 1), (2, 128, 1000, 1), (2, 3072, 1, 1),
])
def test_k3_split_is_whole_stored_tiles_in_one_wave(m, n, count, g):
    """Slices of whole stored tiles, the last one of the longest column
    not empty, every tile in one slice, no slice with a negative count for
    any column of 0 .. ``count`` tiles; the grid within one wave of the
    SMs unless the output tiles alone pass it."""
    splits, per = k3_split(m, n, count, g)
    assert (splits, per) == k3_split(m, n, count, g)
    assert per >= 1 and splits >= 1
    assert (splits - 1) * per < max(count, 1) <= splits * per
    blocks = g * -(-m // k1_wgmma_bm(m)) * -(-n // 128)
    assert blocks * splits <= H100_SMS or splits == 1
    for col in range(count + 1):            # every column's slices
        sizes = [max(0, min(col, (s + 1) * per) - s * per)
                 for s in range(splits)]
        assert sum(sizes) == col and min(sizes) >= 0


def test_k3_split_examples():
    """phi3's 3072-wide projections at M = 2 (24 output tiles) with a
    longest column of 18 stored tiles: 5 slices of 4 (120 blocks); its
    8192-wide ones (64 tiles): 2 slices; granite's expert stacks (32 x 4 =
    128 tiles): one; an operand with no stored tile: one slice of one."""
    assert k3_split(2, 3072, 18) == (5, 4)
    assert k3_split(2, 8192, 18) == (2, 9)
    assert k3_split(2, 512, 4, 32) == (1, 4)
    assert k3_split(2, 3072, 0) == (1, 1)


def test_max_column_tiles_reads_the_host_structure():
    """``TileSparseLayout.max_column_tiles``: the longest column's stored
    tiles, from the host-side tuple, computed once (cached on the layout,
    which still hashes and compares by its fields)."""
    b = _operand(1024, 512, "int8", g=2, per_column=3)
    layout = b.layout
    assert layout.max_column_tiles == 3
    assert "max_column_tiles" in vars(layout)
    assert hash(layout) == hash(TileSparseLayout(**{
        f: getattr(layout, f) for f in (
            "k", "n", "bk", "bn", "dtype", "orig_dtype", "indptr", "indices",
            "trans_w", "g")}))
    empty = _operand(256, 256, "bfloat16", per_column=0).layout
    assert empty.nnz == 0 and empty.max_column_tiles == 0


# --- the design's arithmetic against the reference ----------------------------

def _emulate(a, b, scale, splits):
    """The wgmma design's sum (G, M, N) f32 before the epilogue: each
    column's stored tiles in payload order, in ``splits`` slices of whole
    tiles (k3_split's cut of the longest column), each tile folded into
    its slice's f32 sum, the slices summed in slice order."""
    layout = b.layout
    g, nkb, nnb, bk, bn = (layout.g, layout.nkb, layout.nnb, layout.bk,
                           layout.bn)
    a3 = a if a.dim() == 3 else a[None]
    m = a3.shape[1]
    ap = torch.nn.functional.pad(a3, (0, nkb * bk - layout.k))
    per = -(-max(layout.max_column_tiles, 1) // splits)
    out = torch.zeros(g, m, nnb * bn)
    for c in range(g * nnb):
        gg, j = divmod(c, nnb)
        lo, hi = layout.indptr[c], layout.indptr[c + 1]
        total = None
        for s in range(splits):                     # slice order
            acc = torch.zeros(m, bn)
            for t in range(lo + s * per, min(hi, lo + (s + 1) * per)):
                kk = layout.indices[t]
                a_t = ap[gg, :, kk * bk:(kk + 1) * bk]
                w_t = b.payload[t]
                if a.dtype == torch.int8:
                    part = (a_t.double() @ w_t.double()).float()
                    acc = acc + part * b.scales[t].float()
                    continue
                if layout.per_tile_scales:       # decoded, scaled, rounded
                    w_t = (w_t.float() * b.scales[t].float()).to(
                        torch.bfloat16)
                part = torch.zeros(m, bn)
                for st in range(0, bk, 64):      # two 64-deep stages
                    part = part + a_t[:, st:st + 64].float() @ \
                        w_t[st:st + 64].float()
                acc = acc + part                 # folded a tile at a time
            total = acc if total is None else total + acc
        out[gg, :, j * bn:(j + 1) * bn] = total
    out = out[..., :layout.n]
    if scale is not None:
        out = out * scale
    return out if a.dim() == 3 else out[0]


def _draw(rng, shape, scale=1.0, bf16=True):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32) if bf16 else x


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("policy,payload", PAIRS)
@pytest.mark.parametrize("g,m,k,n", [(1, 5, 304, 300), (3, 2, 384, 392),
                                     (1, 3, 512, 384)])
def test_wgmma_arithmetic_matches_reference(g, m, k, n, policy, payload,
                                            splits):
    """K = 304 is three 128-deep tiles with a 48-row tail (zero-padded in
    the payload, zero-filled in A); N = 300 ends in a ragged 44-wide
    column tile; column tile 1 holds no stored tile (its outputs: a zero
    sum) and column 0 every one, so the columns are skewed and the later
    slices of the short ones are empty; the grouped case three experts of
    two rows.  Under the int8 policy A is the per-tensor int8 x and
    ``sx`` the epilogue's scale, as ``mp_dot`` hands K3."""
    rng = np.random.default_rng(37 * k + splits)
    lead = (g,) if g > 1 else ()
    x = _draw(rng, (*lead, m, k))
    w = _draw(rng, (*lead, k, n), scale=(2.0 / (k + n)) ** 0.5, bf16=False)
    lattice = (*lead, -(-k // 128), -(-n // 128))
    keep = rng.random(lattice) < 0.5
    keep[..., 0] = True
    keep[..., 1] = False
    keep[..., -1, -1] = True
    w_j = js.sparsify_with_mask(jnp.asarray(w), (128, 128), keep,
                                dtype=payload)
    w_t = ts.sparsify_with_mask(torch.from_numpy(w), (128, 128), keep,
                                dtype=payload)
    jfn = jax_mp_dot_grouped if g > 1 else jax_mp_dot
    with jcfg.gemm_backend("interpret"):
        want = np.asarray(jfn(jnp.asarray(x), w_j, policy=policy)).astype(
            np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    a, scale = quantize_per_tensor(xt) if policy == "int8" else (xt, None)
    assert k3_design(a, w_t) == "wgmma"
    got = _emulate(a, w_t, scale, splits).to(torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)
