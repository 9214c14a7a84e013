"""K4 and K5 wrappers: flash attention over dense K/V (port of
``repro.kernels.flash_attention.flash_attention``) and over a block-table KV
pool (port of ``paged_flash_attention``).

Each wrapper dispatches by the device of ``q``: a CPU tensor runs the plain
version (:func:`flash_attention_plain`, :func:`paged_flash_attention_plain`),
a CUDA tensor launches the hand-written kernel (``csrc/flash_attention.cu``,
``csrc/paged_flash.cu``) or raises ``NotImplementedError`` for a variant the
kernel does not take; nothing falls back.  Both compute the reference
kernels' math: logical positions, ``-1e30`` (finite) masking, f32 scores,
softmax and P·V (P is not rounded to the input dtype), ``acc / max(l,
1e-30)`` in q's dtype.

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
kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GROUP = 32      # query heads per kv head the kernel folds into a block
_MAX_HEAD_DIM = 256


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
    lib = _flash_lib()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
        tq, tk, d, int(causal), int(window) if window is not None else 0,
        float(scale), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: CUDA error {rc} "
            f"({lib.flash_attention_error_string(rc).decode()})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


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
