"""K5 wrapper: paged flash attention over a block-table KV pool (port of
``repro.kernels.flash_attention.paged_flash_attention``).

:func:`paged_flash_attention` dispatches by the device of ``q``: a CPU
tensor runs :func:`paged_flash_attention_plain`, a CUDA tensor launches the
hand-written kernel in ``csrc/paged_flash.cu``.  Both compute the reference
kernel's math: logical positions, ``-1e30`` (finite) masking, V rows at or
past ``lengths[b]`` zeroed before P·V, f32 softmax, ``acc / max(l, 1e-30)``.
They agree on every query row whose position is below ``lengths[b]`` and
on idle rows (``lengths[b] == 0``, output 0).  On a fully masked dead row
(possible only past ``lengths[b]`` under a window) each averages the V
rows it visited, and the kernel visits fewer: such rows are padding that
no caller reads.

``paged_flash_attention.launches`` counts kernel launches.
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
