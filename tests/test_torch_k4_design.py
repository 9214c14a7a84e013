"""K4's designs and the rules around them, on the CPU.

* :func:`k4_design` picks the wgmma or split kernel
  (``csrc/flash_attention_wgmma.cu``) or the scalar one
  (``csrc/flash_attention.cu``) from the operands alone: bf16, D % 8 == 0,
  D <= 128, 16-byte aligned bases; at most 16 folded rows (G·Tq) a kv head
  take the split design.
* :func:`k4_split` cuts the keys into slices when the grid has fewer
  blocks than the card has SMs.
* A plain-torch emulation of the new designs' arithmetic -- folded rows in
  blocks, keys in tiles of 64 from the block's first visible key, slices
  of those tiles each with its own (m, l, acc), exp2 of scores scaled by
  scale · log2(e), P rounded to bf16 before P·V in the wgmma design, the
  slices combined in slice order -- is held against the reference kernel
  (``repro.kernels.flash_attention.flash_attention(..., interpret=True)``)
  at small whisper-, phi3- and GQA-window-like shapes.  Tolerance: atol =
  rtol = 1.6e-2, the card's bf16 gate: P rounded to bf16 moves each term
  of P·V by at most 2**-9 of itself, and the output is rounded to bf16
  (2**-8) in both.
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
    K4_BKV, K4_SPLIT_ROWS, NEG_INF, k4_design, k4_split, k4_wgmma_bm,
)
from repro_torch.kernels.mpgemm import H100_SMS  # noqa: E402

BF = torch.bfloat16
BF16 = dict(atol=1.6e-2, rtol=1.6e-2)
REPO = os.path.join(os.path.dirname(__file__), "..")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qkv(b, h, hkv, tq, tk, d, dtype=BF):
    return (torch.zeros(b, h, tq, d, dtype=dtype),
            torch.zeros(b, hkv, tk, d, dtype=dtype),
            torch.zeros(b, hkv, tk, d, dtype=dtype))


def _misaligned(*shape):
    """A contiguous bf16 view that starts 2 bytes past an aligned base."""
    base = torch.zeros(int(np.prod(shape)) + 1, dtype=BF)
    assert base.data_ptr() % 16 == 0
    return base[1:].view(*shape)


# --- the design rule --------------------------------------------------------

@pytest.mark.parametrize("case", [c[0] for c in _chip_smoke().K4_CASES])
def test_k4_design_of_every_chip_smoke_case(case):
    """chip_smoke.py's K4 cases: bf16 ones take the split design at most
    16 folded rows (whisper's decode cross-attention), the wgmma design
    above; the f32 case the scalar kernel."""
    row = {c[0]: c for c in _chip_smoke().K4_CASES}[case]
    _, b, h, hkv, tq, tk, d, _, _, dt = row
    q, k, v = _qkv(b, h, hkv, tq, tk, d, getattr(torch, dt))
    want = ("simt" if dt == "float32" else
            "split" if h // hkv * tq <= K4_SPLIT_ROWS else "wgmma")
    assert k4_design(q, k, v) == want


@pytest.mark.parametrize("case,shape,want", [
    ("decode, MHA", (2, 16, 16, 1, 1500, 64), "split"),
    ("decode, GQA 4:1", (1, 8, 2, 1, 90, 120), "split"),
    ("16 folded rows", (2, 4, 1, 4, 300, 72), "split"),
    ("17 folded rows", (1, 17, 1, 1, 30, 64), "wgmma"),
    ("decode, GQA 32:1", (1, 32, 1, 1, 64, 64), "wgmma"),
    ("prefill D 96", (2, 32, 32, 32, 32, 96), "wgmma"),
    ("D 128", (1, 4, 4, 200, 700, 128), "wgmma"),
    ("D 24", (3, 6, 3, 64, 64, 24), "wgmma"),
    ("D 20: rows of 40 bytes", (2, 4, 2, 7, 45, 20), "simt"),
    ("D 136 > 128", (1, 2, 2, 8, 8, 136), "simt"),
    ("D 256", (1, 4, 1, 5, 9, 256), "simt"),
])
def test_k4_design_by_shape(case, shape, want):
    assert k4_design(*_qkv(*shape)) == want, case


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_k4_design_takes_bf16_only(dtype):
    assert k4_design(*_qkv(2, 4, 4, 1, 64, 64, dtype)) == "simt"
    q, k, v = _qkv(2, 4, 4, 32, 64, 64)
    assert k4_design(q, k.to(dtype), v) == "simt"


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_k4_design_sends_a_misaligned_view_to_simt(which):
    """A contiguous view off a 16-byte boundary (TMA's rule for the wgmma
    design, 16-byte loads for the split one)."""
    shapes = dict(q=(2, 4, 33, 64), k=(2, 4, 70, 64), v=(2, 4, 70, 64))
    ops = {n: (_misaligned(*s) if n == which else torch.zeros(s, dtype=BF))
           for n, s in shapes.items()}
    assert ops[which].is_contiguous() and ops[which].data_ptr() % 16
    assert k4_design(ops["q"], ops["k"], ops["v"]) == "simt"
    assert k4_design(*_qkv(2, 4, 4, 33, 70, 64)) == "wgmma"


# --- the split rule ---------------------------------------------------------

SPLIT_SHAPES = [  # (rows = G * Tq, tk, b, hkv)
    (1, 1500, 2, 16), (32, 1500, 2, 16), (1500, 1500, 2, 16), (32, 32, 2, 32),
    (256, 600, 2, 8), (256, 128, 4, 8), (4, 90, 1, 2), (16, 300, 2, 1),
    (1, 3, 1, 1), (100, 3, 1, 2), (210, 333, 3, 2), (1, 100000, 1, 1),
]


@pytest.mark.parametrize("rows,tk,b,hkv", SPLIT_SHAPES)
def test_k4_split(rows, tk, b, hkv):
    """One slice when the blocks fill the SMs; else enough slices of whole
    key tiles that the grid reaches them, none empty; the same answer
    every call."""
    splits = k4_split(rows, tk, b, hkv)
    assert splits == k4_split(rows, tk, b, hkv) and splits >= 1
    bm = K4_SPLIT_ROWS if rows <= K4_SPLIT_ROWS else k4_wgmma_bm(rows)
    tiles = b * hkv * -(-rows // bm)
    key_tiles = -(-tk // K4_BKV)
    per = -(-key_tiles // splits)
    assert splits <= key_tiles and (splits - 1) * per < key_tiles
    if tiles >= H100_SMS:
        assert splits == 1
    else:
        assert tiles * splits >= H100_SMS or splits == key_tiles


def test_k4_split_examples():
    """whisper-medium's cross-attention at decode and at prefill (32
    blocks over 1500 keys, 24 key tiles): 6 slices of 4 tiles; the
    encoder (384 blocks): one; one block over 1500 keys: a slice a
    tile."""
    assert k4_split(1, 1500, 2, 16) == 6
    assert k4_split(32, 1500, 2, 16) == 6
    assert k4_split(1500, 1500, 2, 16) == 1
    assert k4_split(1, 1500, 1, 1) == 24
    assert k4_split(32, 1500, 2, 16, sms=264) == 12


# --- the designs' arithmetic against the reference -------------------------

def _emulate(q, k, v, *, causal, window, splits):
    """The new designs' arithmetic in plain torch (f32 throughout but P's
    bf16 rounding in the wgmma design): see the module docstring."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    rows = h // hkv * tq
    wgmma = rows > K4_SPLIT_ROWS
    bm = k4_wgmma_bm(rows) if wgmma else K4_SPLIT_ROWS
    sl = d ** -0.5 * math.log2(math.e)
    qf = q.float().reshape(b, hkv, rows, d)
    kf, vf = k.float(), v.float()
    out = torch.empty(b, hkv, rows, d)
    for m0 in range(0, rows, bm):
        r = torch.arange(m0, min(m0 + bm, rows))
        qi = r % tq + tk - tq
        j_hi = min(tk - 1, int(qi.max())) if causal else tk - 1
        j_lo = max(0, int(qi.min()) - window + 1) if window else 0
        n_tiles = -(-(j_hi - j_lo + 1) // K4_BKV) if j_hi >= j_lo else 0
        per = -(-n_tiles // splits)
        parts = []
        for s in range(splits):
            t0 = min(n_tiles, s * per)
            m = torch.full((b, hkv, len(r)), NEG_INF)
            l = torch.zeros(b, hkv, len(r))
            acc = torch.zeros(b, hkv, len(r), d)
            for it in range(t0, min(n_tiles, t0 + per)):
                keys = j_lo + it * K4_BKV + torch.arange(K4_BKV)
                seen = (keys <= j_hi)[None, :].expand(len(r), -1)
                if causal:
                    seen = seen & (keys[None, :] <= qi[:, None])
                if window:
                    seen = seen & (keys[None, :] > qi[:, None] - window)
                inside = keys.clamp(max=tk - 1)
                vk = torch.where((keys < tk)[:, None], vf[:, :, inside], 0.0)
                sc = torch.einsum("bhrd,bhkd->bhrk", qf[:, :, r],
                                  kf[:, :, inside]) * sl
                sc = torch.where(seen, sc, NEG_INF)
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(sc - m_new[..., None])
                l = l * alpha + p.sum(-1)
                if wgmma:
                    p = p.to(BF).float()
                acc = acc * alpha[..., None] + p @ vk
                m = m_new
            parts.append((m, l, acc))
        m_all = torch.stack([p[0] for p in parts]).amax(0)
        l_all = torch.zeros_like(m_all)
        o = torch.zeros(b, hkv, len(r), d)
        for m, l, acc in parts:                      # slice order
            w = torch.exp2(m - m_all)
            l_all = l_all + w * l
            o = o + w[..., None] * acc
        out[:, :, r] = o / l_all.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, tq, d).to(q.dtype)


def _bf16_inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32).astype(
            ml_dtypes.bfloat16)
        out.append((jnp.asarray(a), torch.from_numpy(
            a.view(np.uint16).copy()).view(BF)))
    return out


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("case,b,h,hkv,tq,tk,d,causal,window", [
    ("whisper-like encoder", 1, 2, 2, 150, 150, 64, False, None),
    ("whisper-like cross", 2, 2, 2, 24, 300, 64, False, None),
    ("whisper-like decode", 2, 2, 2, 1, 300, 64, False, None),
    ("phi3-like prefill", 1, 2, 2, 40, 40, 96, True, None),
    ("gqa-window", 1, 8, 2, 20, 150, 120, True, 37),
    ("gqa decode, window", 1, 8, 2, 1, 90, 120, True, 16),
])
def test_new_designs_arithmetic_matches_reference(case, b, h, hkv, tq, tk, d,
                                                  causal, window, splits):
    (jq, tq_), (jk, tk_), (jv, tv_) = _bf16_inputs(
        7, (b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                               interpret=True)
    got = _emulate(tq_, tk_, tv_, causal=causal, window=window,
                   splits=splits)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **BF16)
