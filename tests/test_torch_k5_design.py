"""K5's designs and the rules around them, on the CPU.

* :func:`k5_design` picks the split or wgmma body of
  ``csrc/flash_attention_wgmma.cu`` over the block table, or the scalar
  ``csrc/paged_flash.cu``, from q and the pools alone: bf16, D % 8 == 0,
  D <= 128, 16-byte aligned bases, pages that tile 64 keys; at most 16
  folded rows (G·Tq) a kv head take the split design.
* :func:`k5_split` cuts the keys into slices from the table's width (the
  wrapper never reads ``lengths``).
* A plain-torch emulation of the two designs' arithmetic -- each request's
  live keys min(lengths[b], W·ps) visited in 64-key tiles from a 64-key
  boundary, pages gathered through the table, tiles cut into slices (a
  slice past the length stays empty: m = -1e30, l = 0), scores removed
  by a select, exp2 of scores scaled by scale · log2(e), P rounded to bf16
  and V rows past the length zeroed in the wgmma design (dead keys read as
  zero in the split one), the slices combined in slice order -- is held
  against the reference kernel (``repro.kernels.flash_attention.
  paged_flash_attention(..., interpret=True)``) with GQA, a window, ragged
  lengths, a chunk with dead rows, an idle request and a NaN scratch page
  behind every dead table slot.  Live rows: atol = rtol = 1.6e-2, the
  card's bf16 gate (P rounded to bf16 moves each term of P·V by at most
  2**-9 of itself, and the output is rounded to bf16 in both); idle rows:
  exactly 0.
"""
import importlib.util
import math
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    K4_BKV, K4_SPLIT_ROWS, NEG_INF, k4_split, k4_wgmma_bm, k5_design,
    k5_split,
)

BF = torch.bfloat16
BF16 = dict(atol=1.6e-2, rtol=1.6e-2)
REPO = os.path.join(os.path.dirname(__file__), "..")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pools(b, h, hkv, tq, d, ps, n_pages=3, dtype=BF):
    """q and the pools over one element each (the rule reads dtypes,
    shapes and addresses, never values)."""
    def over(*shape):
        return torch.empty(1, dtype=dtype).expand(*shape)
    return (over(b, h, tq, d), over(n_pages, hkv, ps, d),
            over(n_pages, hkv, ps, d))


# --- the design rule --------------------------------------------------------

@pytest.mark.parametrize("case", [c["name"] for c in _chip_smoke().K5_CASES])
def test_k5_design_of_every_chip_smoke_case(case):
    """chip_smoke.py's K5 cases: bf16 decode (phi3, granite, the GQA
    window, starcoder2's 12, phi3-medium's 4 and mixtral's 6 folded rows)
    and phi3's 16-token chunk (16 folded rows) take the split design,
    granite's chunk (32 rows), the GQA chunk (64) and the newer models'
    chunks (192, 64, 96) the wgmma design, the f32 case the scalar
    kernel."""
    c = {c["name"]: c for c in _chip_smoke().K5_CASES}[case]
    q, kp, vp = _pools(len(c["lengths"]), c["h"], c["hkv"], c["tq"], c["d"],
                       c["ps"], dtype=getattr(torch, c["dtype"]))
    rows = c["h"] // c["hkv"] * c["tq"]
    want = ("simt" if c["dtype"] == "float32" else
            "split" if rows <= K4_SPLIT_ROWS else "wgmma")
    assert k5_design(q, kp, vp) == want
    assert want == {"phi3-decode": "split", "phi3-prefill16": "split",
                    "granite-decode": "split", "granite-prefill16": "wgmma",
                    "gqa-window-decode": "split",
                    "gqa-window-prefill16": "wgmma",
                    "f32-gqa-prefill16": "simt",
                    "starcoder2-decode": "split",
                    "starcoder2-prefill16": "wgmma",
                    "phi3-medium-decode": "split",
                    "phi3-medium-prefill16": "wgmma",
                    "mixtral-decode": "split",
                    "mixtral-prefill16": "wgmma",
                    "mixtral-window-decode": "split",
                    "mixtral-window-prefill16": "wgmma"}[case]


@pytest.mark.parametrize("ps,want", [
    (8, "split"), (16, "split"), (32, "split"), (64, "split"),
    (128, "split"), (256, "split"),
    (4, "simt"), (12, "simt"), (24, "simt"), (96, "simt"), (512, "simt"),
])
def test_k5_design_by_page_size(ps, want):
    """Pages that tile 64 keys: a multiple of 8 that divides 64, or a
    multiple of 64 up to a TMA box's 256 rows."""
    assert k5_design(*_pools(2, 8, 8, 1, 64, ps)) == want
    assert k5_design(*_pools(2, 8, 2, 8, 64, ps)) == (
        "wgmma" if want != "simt" else "simt")


@pytest.mark.parametrize("case,shape,want", [
    ("decode, MHA, D 96", (2, 32, 32, 1, 96), "split"),
    ("decode, GQA 4:1", (4, 32, 8, 1, 120), "split"),
    ("16 folded rows", (2, 32, 32, 16, 96), "split"),
    ("32 folded rows", (2, 16, 8, 16, 64), "wgmma"),
    ("GQA 32:1 decode", (1, 32, 1, 1, 64), "wgmma"),
    ("D 128", (1, 4, 4, 40, 128), "wgmma"),
    ("D 24", (3, 4, 2, 3, 24), "split"),
    ("D 20: rows of 40 bytes", (2, 4, 2, 7, 20), "simt"),
    ("D 136 > 128", (1, 2, 2, 8, 136), "simt"),
    ("D 256", (1, 4, 1, 5, 256), "simt"),
])
def test_k5_design_by_shape(case, shape, want):
    b, h, hkv, tq, d = shape
    assert k5_design(*_pools(b, h, hkv, tq, d, 16)) == want, case


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_k5_design_takes_bf16_only(dtype):
    assert k5_design(*_pools(2, 4, 4, 1, 64, 16, dtype=dtype)) == "simt"
    q, kp, vp = _pools(2, 4, 4, 1, 64, 16)
    assert k5_design(q, kp.to(dtype), vp) == "simt"


@pytest.mark.parametrize("which", ["q", "k_pages", "v_pages"])
def test_k5_design_sends_a_misaligned_view_to_simt(which):
    """A contiguous view off a 16-byte boundary (TMA's rule for the wgmma
    design, 16-byte loads for the split one)."""
    shapes = dict(q=(2, 4, 3, 64), k_pages=(5, 4, 16, 64),
                  v_pages=(5, 4, 16, 64))

    def view(name, shape):
        n = int(np.prod(shape))
        base = torch.zeros(n + 1, dtype=BF)
        return (base[1:] if name == which else base[:n]).view(*shape)

    ops = {n: view(n, s) for n, s in shapes.items()}
    assert ops[which].is_contiguous() and ops[which].data_ptr() % 16
    assert k5_design(ops["q"], ops["k_pages"], ops["v_pages"]) == "simt"
    assert k5_design(*(torch.zeros(s, dtype=BF)
                       for s in shapes.values())) == "split"


# --- the split rule ---------------------------------------------------------

@pytest.mark.parametrize("rows,w,ps,b,hkv", [
    (1, 4, 16, 2, 32), (16, 4, 16, 2, 32), (2, 4, 16, 2, 8),
    (32, 4, 16, 2, 8), (4, 16, 16, 4, 8), (64, 16, 16, 4, 8),
    (1, 128, 16, 1, 1), (2, 64, 64, 1, 4), (40, 3, 128, 3, 2),
])
def test_k5_split_is_k4_split_over_the_table(rows, w, ps, b, hkv):
    splits = k5_split(rows, w, ps, b, hkv)
    assert splits == k4_split(rows, w * ps, b, hkv)
    assert 1 <= splits <= -(-w * ps // K4_BKV)


def test_k5_split_examples():
    """The served tables (4 pages of 16: one 64-key tile) take one slice;
    chip_smoke's GQA window decode (16 pages: 4 tiles, 32 blocks) a slice
    a tile; one request over 128 pages of 16 (32 tiles, 1 block) 32."""
    assert k5_split(1, 4, 16, 2, 32) == 1
    assert k5_split(2, 4, 16, 2, 8) == 1
    assert k5_split(4, 16, 16, 4, 8) == 4
    assert k5_split(1, 128, 16, 1, 1) == 32


# --- the designs' arithmetic against the reference -------------------------

def _emulate(q, kp, vp, bt, q_start, lengths, *, causal, window, splits):
    """The two designs' arithmetic in plain torch: see the module
    docstring."""
    b, h, tq, d = q.shape
    _, hkv, ps, _ = kp.shape
    w = bt.shape[1]
    rows = h // hkv * tq
    wgmma = rows > K4_SPLIT_ROWS
    bm = k4_wgmma_bm(rows) if wgmma else K4_SPLIT_ROWS
    sl = d ** -0.5 * math.log2(math.e)
    qf = q.float().reshape(b, hkv, rows, d)
    kf, vf = kp.float(), vp.float()
    out = torch.empty(b, hkv, rows, d)
    for bi in range(b):
        n_keys = min(int(lengths[bi]), w * ps)
        for m0 in range(0, rows, bm):
            r = torch.arange(m0, min(m0 + bm, rows))
            qi = r % tq + int(q_start[bi])
            j_hi = n_keys - 1
            if causal:
                j_hi = min(j_hi, int(qi.max()))
            j_lo = max(0, int(qi.min()) - window + 1) if window else 0
            j_lo -= j_lo % K4_BKV                    # whole pages a tile
            n_tiles = -(-(j_hi - j_lo + 1) // K4_BKV) if j_hi >= j_lo else 0
            per = -(-n_tiles // splits)
            parts = []
            for s in range(splits):
                t0 = min(n_tiles, s * per)
                m = torch.full((hkv, len(r)), NEG_INF)
                l = torch.zeros(hkv, len(r))
                acc = torch.zeros(hkv, len(r), d)
                for it in range(t0, min(n_tiles, t0 + per)):
                    keys = j_lo + it * K4_BKV + torch.arange(K4_BKV)
                    page = bt[bi, (keys // ps).clamp(max=w - 1)].long()
                    kk = kf[page, :, keys % ps].transpose(0, 1)
                    vv = vf[page, :, keys % ps].transpose(0, 1)
                    if wgmma:       # V rows past the length zeroed
                        vv = torch.where((keys < n_keys)[:, None], vv, 0.0)
                    else:           # dead keys are never loaded
                        kk = torch.where((keys <= j_hi)[:, None], kk, 0.0)
                        vv = torch.where((keys <= j_hi)[:, None], vv, 0.0)
                    seen = (keys <= j_hi)[None, :].expand(len(r), -1)
                    if causal:
                        seen = seen & (keys[None, :] <= qi[:, None])
                    if window:
                        seen = seen & (keys[None, :] > qi[:, None] - window)
                    sc = torch.einsum("hrd,hkd->hrk", qf[bi][:, r], kk) * sl
                    sc = torch.where(seen, sc, NEG_INF)
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(sc - m_new[..., None])
                    l = l * alpha + p.sum(-1)
                    if wgmma:
                        p = p.to(BF).float()
                    acc = acc * alpha[..., None] + p @ vv
                    m = m_new
                parts.append((m, l, acc))
            m_all = torch.stack([p[0] for p in parts]).amax(0)
            l_all = torch.zeros_like(m_all)
            o = torch.zeros(hkv, len(r), d)
            for m, l, acc in parts:                  # slice order
                wt = torch.exp2(m - m_all)
                l_all = l_all + wt * l
                o = o + wt[..., None] * acc
            out[bi, :, r] = o / l_all.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, tq, d).to(q.dtype)


def _setup(seed, *, hkv, g, d, ps, w, tq, lengths):
    """bf16 pools with a NaN scratch page 0 behind every dead slot, ragged
    lengths with an idle request, each request's chunk its last tq
    positions (a short one leaves dead rows past its length)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    n_pages = 1 + b * w
    kp = rng.standard_normal((n_pages, hkv, ps, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, hkv, ps, d)).astype(np.float32)
    kp[0] = vp[0] = np.nan
    perm = rng.permutation(np.arange(1, n_pages)).reshape(b, w)
    bt = np.zeros((b, w), np.int32)
    for i, ln in enumerate(lengths):
        used = -(-ln // ps)
        bt[i, :used] = perm[i, :used]
    lengths = np.asarray(lengths, np.int32)
    q_start = np.maximum(lengths - tq, 0).astype(np.int32)
    q = rng.standard_normal((b, hkv * g, tq, d)).astype(np.float32)
    q, kp, vp = (a.astype(ml_dtypes.bfloat16) for a in (q, kp, vp))
    return q, kp, vp, bt, q_start, lengths


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(BF)
    return torch.from_numpy(a)


@pytest.mark.parametrize("splits", ["rule", 3])
@pytest.mark.parametrize("case,hkv,g,d,ps,w,tq,lengths,window", [
    ("decode, split", 2, 2, 24, 8, 12, 1, [73, 30, 0, 9], None),
    ("decode, window", 2, 2, 24, 8, 12, 1, [73, 30, 0, 9], 12),
    ("8 folded rows, split", 2, 2, 24, 16, 8, 4, [100, 2, 0], None),
    ("40 folded rows, wgmma", 2, 2, 24, 8, 12, 20, [90, 9, 0], None),
    ("wgmma, window", 1, 4, 32, 16, 10, 20, [150, 26, 0], 30),
    ("pages of 64, wgmma", 2, 4, 16, 64, 3, 8, [170, 64, 0], None),
    ("pages of 128, split", 2, 1, 16, 128, 2, 5, [200, 130, 0], 70),
])
def test_new_designs_arithmetic_matches_reference(case, hkv, g, d, ps, w,
                                                  tq, lengths, window,
                                                  splits):
    q, kp, vp, bt, qs, ln = _setup(len(case) + ps, hkv=hkv, g=g, d=d, ps=ps,
                                   w=w, tq=tq, lengths=lengths)
    want = np.asarray(jfa.paged_flash_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, qs, ln)),
        causal=True, window=window, interpret=True)).astype(np.float32)
    tq_, tkp, tvp = _torch(q), _torch(kp), _torch(vp)
    assert k5_design(tq_, tkp, tvp) == ("split" if g * tq <= 16
                                        else "wgmma")
    n = (k5_split(g * tq, w, ps, len(lengths), hkv) if splits == "rule"
         else splits)
    got = _emulate(tq_, tkp, tvp, torch.from_numpy(bt),
                   torch.from_numpy(qs), torch.from_numpy(ln), causal=True,
                   window=window, splits=n).float().numpy()
    live = np.arange(tq)[None, :] + qs[:, None] < ln[:, None]
    sel = np.broadcast_to(live[:, None, :, None], got.shape)
    np.testing.assert_allclose(got[sel], want[sel], **BF16)
    idle = ln == 0
    assert (got[idle] == 0).all() and np.isfinite(want[idle]).all()
