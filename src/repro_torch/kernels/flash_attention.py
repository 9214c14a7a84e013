"""K4 and K5 wrappers: flash attention over dense K/V (port of
``repro.kernels.flash_attention.flash_attention``) and over a block-table KV
pool (port of ``paged_flash_attention``).

Each wrapper dispatches by the device of ``q``: a CPU tensor runs the plain
version (:func:`flash_attention_plain`, :func:`paged_flash_attention_plain`),
a CUDA tensor launches the hand-written kernel (``csrc/flash_attention.cu``,
``csrc/flash_attention_wgmma.cu``, ``csrc/paged_flash.cu``) or raises
``NotImplementedError`` for a variant the kernel does not take; nothing
falls back.  Both compute the reference kernels' math: logical positions,
``-1e30`` (finite) masking, f32 scores, softmax and P·V, ``acc / max(l,
1e-30)`` in q's dtype.

K4 has three designs on the card, and :func:`k4_design` picks one by a
rule on the operands (never by trying): bf16 q, k and v with 16-byte
aligned bases, a head width D % 8 == 0 and D <= 128 run
``csrc/flash_attention_wgmma.cu`` -- ``"wgmma"`` (TMA, ``wgmma`` for
Q·Kᵀ and P·V, blocks of 64 or 128 folded query rows) when the G·Tq
folded rows of a kv head number more than 16, ``"split"`` (CUDA cores,
16-byte loads) at most 16 (decode) -- and both cut the keys into
:func:`k4_split` slices when there are fewer blocks than SMs, combined
in slice order by the last block of a tile (one launch, the same bits
every run); everything else (f32, other head widths) runs the scalar
``csrc/flash_attention.cu``.  The wgmma design rounds P to bf16 before
P·V (a relative error of at most 2⁻⁹ an element; the plain version and
the other designs keep P in f32), and the two new designs take ``exp2``
of scores scaled by ``scale · log2(e)``.

K4 (:func:`flash_attention`): the causal mask is right-aligned (query row t
sits at position ``t + tk - tq``), an optional window keeps keys with
``ki > qi - window``, GQA folds ``H / Hkv`` query heads onto each KV head.
The kernel and its plain version agree on every query row that sees at
least one key.  A row that sees none (possible only when ``tq > tk`` under
causal; no caller makes one) is finite in both but not the same: each
averages V rows it visited (the plain version all ``tk``, the kernel those
of its block's key range, or none: 0), as the reference averages the rows
of its TPU blocks, a value that depends on its block size.

K5 (:func:`paged_flash_attention`): V rows at or past ``lengths[b]`` are
zeroed before P·V.  Kernel and plain version agree on every query row whose
position is below ``lengths[b]`` and on idle rows (``lengths[b] == 0``,
output 0).  On a fully masked dead row (possible only past ``lengths[b]``
under a window) each averages the V rows it visited, and the kernel visits
fewer: such rows are padding that no caller reads.

``flash_attention.launches`` and ``paged_flash_attention.launches`` count
kernel launches (never plain-version calls); ``flash_attention.
wgmma_launches`` and ``.split_launches`` those of K4 that ran the
``"wgmma"`` and the ``"split"`` design.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mpgemm import (
    H100_SMS, _cdiv, _current_stream, _ptr, _sm_count, _split_workspace,
)

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 32      # query heads per kv head the kernel folds into a block
_MAX_HEAD_DIM = 256
# csrc/flash_attention_wgmma.cu: head widths up to K4_MAX_D; keys a tile;
# the "split" design's folded rows at most, and its workspace a slice
# (O of 16 x 128, then m and l).
K4_MAX_D, K4_BKV, K4_SPLIT_ROWS = 128, 64, 16
_SPLIT_WS = K4_SPLIT_ROWS * K4_MAX_D + 2 * K4_SPLIT_ROWS


def k4_design(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The K4 kernel that runs q (B, H, Tq, D) over k/v (B, Hkv, Tk, D) on
    the card: ``"wgmma"`` or ``"split"`` (``csrc/flash_attention_wgmma.
    cu``) when all three are bf16 and non-empty, D % 8 == 0, D <=
    :data:`K4_MAX_D`, B and Hkv <= 65535 and every base pointer is a
    multiple of 16 bytes (rows of D bf16 values are then 16-byte aligned,
    as TMA needs) -- ``"split"`` when the G·Tq folded rows of a kv head
    number at most :data:`K4_SPLIT_ROWS`, else ``"wgmma"``; else
    ``"simt"`` (``csrc/flash_attention.cu``).  A rule on what the operands
    are, not a fallback: a failed build or launch raises."""
    b, h, tq, d = q.shape
    hkv = k.shape[1]
    if (any(t.dtype != torch.bfloat16 or t.data_ptr() % 16
            or not t.numel() for t in (q, k, v))
            or d % 8 or d > K4_MAX_D or b > 65535 or hkv > 65535
            or h % hkv):
        return "simt"
    return "split" if h // hkv * tq <= K4_SPLIT_ROWS else "wgmma"


def k4_wgmma_bm(rows: int) -> int:
    """The wgmma design's folded rows a block: one consumer warpgroup (64)
    for at most 64 rows, else two (128)."""
    return 64 if rows <= 64 else 128


def k4_split(rows: int, tk: int, b: int, hkv: int,
             sms: int = H100_SMS) -> int:
    """Slices of the keys for ``rows`` folded rows a kv head (G·Tq) over
    ``tk`` keys: with fewer blocks (q tiles x kv heads x requests) than
    ``sms``, enough slices of whole :data:`K4_BKV`-key tiles that the grid
    reaches ``sms``, none empty; else one.  The kernel combines the slices
    in slice order, so the result is the same bits every run."""
    bm = K4_SPLIT_ROWS if rows <= K4_SPLIT_ROWS else k4_wgmma_bm(rows)
    tiles = b * hkv * _cdiv(rows, bm)
    key_tiles = _cdiv(tk, K4_BKV)
    if tiles >= sms:
        return 1
    per = max(1, key_tiles // min(_cdiv(sms, tiles), key_tiles))
    return _cdiv(key_tiles, per)


# --- K4: dense K/V -----------------------------------------------------------

def _attention_mask(tq, tk, causal, window, device):
    """(tq, tk) bool: the keys each right-aligned query row sees."""
    qi = torch.arange(tq, device=device)[:, None] + (tk - tq)
    ki = torch.arange(tk, device=device)[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool, device=device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None):
    """K4's plain version: f32 scores of the grouped heads, the masks, an
    f32 softmax and an f32 P·V (P is not rounded to V's dtype), then
    ``acc / max(l, 1e-30)`` in q's dtype."""
    b, h, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    g = h // hkv
    scale = scale if scale is not None else 1.0 / d ** 0.5
    qg = q.reshape(b, hkv, g, tq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    s = torch.where(_attention_mask(tq, tk, causal, window, q.device), s,
                    NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / l.clamp_min(1e-30)
    return o.reshape(b, h, tq, d).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None):
    """Flash attention of q (B, H, Tq, D) over k/v (B, Hkv, Tk, D) -> (B, H,
    Tq, D) in q's dtype; the causal mask is right-aligned (``qi = t + tk -
    tq``), ``window`` keeps keys with ``ki > qi - window``, and ``scale``
    defaults to ``D ** -0.5``."""
    b, h, tq, d = q.shape
    bk, hkv, tk, dk = k.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if bk != b or dk != d:
        raise ValueError(f"q {tuple(q.shape)} against k {tuple(k.shape)}")
    if h % hkv:
        raise ValueError(f"GQA requires H % Hkv == 0, got {h} % {hkv}")
    if tk == 0:
        raise ValueError("flash attention needs at least one key")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch_flash(q, k, v, causal, window, scale)


def _launch_flash(q, k, v, causal, window, scale):
    b, h, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash attention kernel takes bf16 or f32 q, k and v of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if h // hkv > _MAX_GROUP:
        raise NotImplementedError(
            f"flash attention kernel folds at most {_MAX_GROUP} query heads "
            f"per kv head, got {h // hkv}")
    if d > _MAX_HEAD_DIM:
        raise NotImplementedError(
            f"flash attention kernel takes head_dim <= {_MAX_HEAD_DIM}, got "
            f"{d}")
    if b > 65535 or hkv > 65535:
        raise NotImplementedError(
            f"flash attention kernel takes at most 65535 requests and kv "
            f"heads, got {b} and {hkv}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash attention: {name} on {t.device}, q on "
                             f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / d ** 0.5
    window = int(window) if window is not None else 0
    stream = _current_stream(q)
    design = k4_design(q, k, v)
    if design == "simt":
        lib = _flash_lib()
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            hkv, tq, tk, d, int(causal), window, float(scale),
            _DTYPE_CODES[q.dtype], stream)
        error = lib.flash_attention_error_string
    else:
        rows = h // hkv * tq
        splits = k4_split(rows, tk, b, hkv, _sm_count(q.get_device()))
        lib = _wgmma_lib()
        ws = counters = None
        if design == "split":
            if splits > 1:
                ws, counters = _split_workspace(
                    q.device, stream, b * hkv * splits * _SPLIT_WS, b * hkv)
            rc = lib.flash_split_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _ptr(ws), _ptr(counters), b, h, hkv, tq, tk, d, int(causal),
                window, float(scale), splits, stream)
        else:
            bm = k4_wgmma_bm(rows)
            dp = 64 if d <= 64 else 128
            tiles = b * hkv * _cdiv(rows, bm)
            if splits > 1:
                ws, counters = _split_workspace(
                    q.device, stream, tiles * splits * (bm * dp + 2 * bm),
                    tiles)
            rc = lib.flash_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _ptr(ws), _ptr(counters), b, h, hkv, tq, tk, d, int(causal),
                window, float(scale), bm, splits, stream)
        error = lib.flash_wgmma_error_string
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel ({design}) launch failed: CUDA error "
            f"{rc} ({error(rc).decode()})")
    flash_attention.launches += 1
    flash_attention.wgmma_launches += int(design == "wgmma")
    flash_attention.split_launches += int(design == "split")
    return out


flash_attention.launches = 0
flash_attention.wgmma_launches = flash_attention.split_launches = 0


@functools.lru_cache(maxsize=None)
def _flash_lib() -> ctypes.CDLL:
    """The built K4 library with its C signatures declared (once)."""
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p] * 4 + [i] * 8 + [
        ctypes.c_float, i, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _wgmma_lib() -> ctypes.CDLL:
    """The built library of K4's "wgmma" and "split" designs, with its C
    signatures declared (once)."""
    lib = _build.load("flash_attention_wgmma")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_wgmma_launch.argtypes = [p] * 6 + [i] * 8 + [f, i, i, p]
    lib.flash_wgmma_launch.restype = i
    lib.flash_split_launch.argtypes = [p] * 6 + [i] * 8 + [f, i, p]
    lib.flash_split_launch.restype = i
    lib.flash_wgmma_error_string.argtypes = [i]
    lib.flash_wgmma_error_string.restype = ctypes.c_char_p
    return lib


# --- K5: paged K/V -----------------------------------------------------------

def paged_flash_attention_plain(q, k_pages, v_pages, block_tables, q_start,
                                lengths, *, causal: bool = True,
                                window: Optional[int] = None,
                                scale: Optional[float] = None):
    """K5's plain version: gather every block-table page into a dense
    (B, Hkv, W*ps, D) stream, then masked f32 softmax attention."""
    b, h, tq, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    w = block_tables.shape[1]
    g = h // hkv
    s_max = w * ps
    scale = scale if scale is not None else 1.0 / d ** 0.5
    bt = block_tables.long()
    k = k_pages[bt].transpose(1, 2).reshape(b, hkv, s_max, d).float()
    v = v_pages[bt].transpose(1, 2).reshape(b, hkv, s_max, d).float()
    ki = torch.arange(s_max, device=q.device)
    length = lengths.long().reshape(b, 1)
    v = torch.where((ki[None, :] < length)[:, None, :, None], v, 0.0)
    qg = q.reshape(b, hkv, g, tq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * scale
    qi = q_start.long().reshape(b, 1) + torch.arange(tq, device=q.device)
    mask = (ki[None, None, :] < length[:, :, None]).expand(b, tq, s_max)
    if causal:
        mask = mask & (ki[None, None, :] <= qi[:, :, None])
    if window is not None:
        mask = mask & (ki[None, None, :] > qi[:, :, None] - window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v) / l.clamp_min(1e-30)
    return o.reshape(b, h, tq, d).to(q.dtype)


def paged_flash_attention(q, k_pages, v_pages, block_tables, q_start,
                          lengths, *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None):
    """Flash attention whose KV rows are gathered through a block table.

    q (B, H, Tq, D) current-chunk queries; k_pages/v_pages (P, Hkv, ps, D)
    pooled pages; block_tables (B, W) int32 physical page ids (0 = scratch);
    q_start (B,) position of q row 0; lengths (B,) valid KV tokens.  Returns
    (B, H, Tq, D) in q's dtype.
    """
    b, h, tq, d = q.shape
    _, hkv, ps, dk = k_pages.shape
    if d != dk:
        raise ValueError(f"head_dim mismatch: q has {d}, pages have {dk}")
    if h % hkv:
        raise ValueError(f"GQA requires H % Hkv == 0, got {h} % {hkv}")
    if k_pages.shape != v_pages.shape:
        raise ValueError("k_pages / v_pages shape mismatch")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        return paged_flash_attention_plain(
            q, k_pages, v_pages, block_tables, q_start, lengths,
            causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention: unsupported device "
                         f"{q.device}")
    return _launch(q, k_pages, v_pages, block_tables, q_start, lengths,
                   causal, window, scale)


def _launch(q, k_pages, v_pages, block_tables, q_start, lengths, causal,
            window, scale):
    b, h, tq, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    w = block_tables.shape[1]
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise NotImplementedError(
            f"paged flash kernel takes bf16 or f32 q and pages of one dtype, "
            f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if h // hkv > _MAX_GROUP:
        raise NotImplementedError(
            f"paged flash kernel folds at most {_MAX_GROUP} query heads per "
            f"kv head, got {h // hkv}")
    if d > _MAX_HEAD_DIM:
        raise NotImplementedError(
            f"paged flash kernel takes head_dim <= {_MAX_HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("q_start", q_start),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged flash: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged flash: {name} must be contiguous")
    for name, t, shape in (("block_tables", block_tables, (b, w)),
                           ("q_start", q_start, (b,)),
                           ("lengths", lengths, (b,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"paged flash: {name} must be int32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / d ** 0.5
    lib = _lib()
    rc = lib.paged_flash_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), out.data_ptr(),
        block_tables.data_ptr(), q_start.data_ptr(), lengths.data_ptr(),
        b, h, hkv, tq, d, ps, w, int(causal),
        int(window) if window is not None else 0, float(scale),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"paged flash kernel launch failed: CUDA error {rc} "
            f"({lib.paged_flash_error_string(rc).decode()})")
    paged_flash_attention.launches += 1
    return out


paged_flash_attention.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("paged_flash")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_flash_launch.argtypes = [p] * 7 + [i] * 9 + [ctypes.c_float,
                                                           i, p]
    lib.paged_flash_launch.restype = i
    lib.paged_flash_error_string.argtypes = [i]
    lib.paged_flash_error_string.restype = ctypes.c_char_p
    return lib
