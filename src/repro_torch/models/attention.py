"""Attention cores (port of ``repro.models.attention``): the prefill,
training and cross-attention dispatch :func:`attention_core` (K4 forward,
the gradient of :func:`dense_attention` backward), one-token decode
attention against a ring cache (:func:`decode_attention`, plain torch ops,
as the reference has no kernel there), and paged attention for
continuous-batching serving (K5).

Paged KV lives in a pooled page array (P, Hkv, page_size, D) per layer;
each request's logical KV stream is the concatenation of the pages its
block-table row names.  Positions are LOGICAL (page j, offset o -> j*ps +
o); which physical page backs them is irrelevant to masking.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (
    NEG_INF, flash_attention, paged_flash_attention,
)


def dense_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, scale=None, lengths=None):
    """The reference's dense attention (its XLA path for short sequences,
    and the one its training differentiates): K/V heads repeated for GQA,
    f32 scores, the right-aligned causal mask, an optional window and
    per-row valid ``lengths``, ``-1e30`` masking, an f32 softmax, ``p``
    rounded to V's dtype, f32 P·V, the result in q's dtype."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = h // hkv
    # Each KV head repeated for its g query heads (expand, not
    # repeat_interleave, whose output size would be read on the host).
    k = k[:, :, None].expand(b, hkv, g, tk, d).reshape(b, h, tk, d)
    v = v[:, :, None].expand(b, hkv, g, tk, d).reshape(b, h, tk, d)
    scale = scale if scale is not None else 1.0 / d ** 0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    ki = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    mask = mask[None, None]
    if lengths is not None:
        mask = mask & (ki[None, None] < lengths.reshape(-1, 1, 1, 1))
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


class _Attention(torch.autograd.Function):
    """K4 forward, the gradient of :func:`dense_attention` backward.

    The reference has no attention-backward kernel: its flash kernel (K4)
    has no VJP, so it trains on its XLA backend, where XLA differentiates
    ``dense_attention``.  The port keeps K4 for the forward on the card
    and, on every device, recomputes ``dense_attention`` from the saved
    q, k, v in the backward and differentiates it with autograd -- the
    counterpart of the reference's XLA-computed gradient.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, scale)
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window,
                               scale=scale)

    @staticmethod
    def backward(ctx, do):
        causal, window, scale = ctx.opts
        with torch.enable_grad():
            qkv = tuple(t.detach().requires_grad_(True)
                        for t in ctx.saved_tensors)
            out = dense_attention(*qkv, causal=causal, window=window,
                                  scale=scale)
            grads = torch.autograd.grad(out, qkv, do)
        return (*grads, None, None, None)


def attention_core(q, k, v, *, causal: bool = True,
                   window: Optional[int] = None, scale=None):
    """Prefill / training / cross-attention: q (B, H, Tq, D) over k/v (B,
    Hkv, Tk, D), the causal mask right-aligned.  The forward is the K4
    wrapper, which dispatches by device: its CUDA kernel for CUDA tensors,
    its plain version for CPU tensors (the reference picks its XLA
    algorithms on the CPU; the math is the same).  The backward is the
    gradient of :func:`dense_attention` (:class:`_Attention` says why);
    when autograd records nothing (serving) the K4 wrapper runs alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, window, scale)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, length, *, scale=None):
    """One-token attention against a (possibly ring-buffered) KV cache.

    q: (B, H, 1, D); caches (B, Hkv, S, D); ``length``: the valid slots of
    every row (the wave path's rows share one position), an int or a 0-d
    device tensor (the wave step's, so that no host read waits).  GQA in
    grouped form (q as (B, Hkv, G, D), the cache never repeated); f32
    scores, slots at or past the length masked with -1e30, f32 softmax, and
    P rounded to the cache dtype before P·V, as the reference does.  A ring
    cache that has wrapped holds only the window, so the mask is on slot
    validity, not recency.
    """
    b, h, _, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / d ** 0.5
    qg = q.reshape(b, hkv, g, d)
    logits = torch.einsum("bhgd,bhkd->bhgk", qg.float(),
                          k_cache.float()) * scale
    mask = torch.arange(s_max, device=q.device) < length
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    o = o / l.clamp_min(1e-30)
    return o.reshape(b, h, 1, d).to(q.dtype)


def paged_kv_write(k_pages, v_pages, k_new, v_new, block_tables, q_start,
                   n_valid):
    """Scatter a (B, C) chunk of fresh K/V rows into the page pool IN PLACE.

    The reference returns new pools; the port updates ``k_pages`` and
    ``v_pages`` with ``index_put_`` (a copy of every layer's pool per step
    would cost more than the step at full width) and returns them.

    ``k_new``/``v_new``: (B, Hkv, C, D); token i of request b lands at
    logical position ``q_start[b] + i`` -> physical page
    ``block_tables[b, pos // ps]``, offset ``pos % ps``.  Rows with
    ``i >= n_valid[b]`` are dead: they go to the reserved scratch page 0 at
    offset ``(b*C + i) % ps``.  Those offsets collide, and on CUDA
    ``index_put_`` picks an arbitrary winner among duplicates -- harmless,
    because no live query ever reads the scratch page as valid.
    """
    b, hkv, c, d = k_new.shape
    ps = k_pages.shape[2]
    w = block_tables.shape[1]
    dev = k_pages.device
    col = torch.arange(c, device=dev)
    pos = q_start.long()[:, None] + col[None, :]                  # (B, C)
    page = torch.gather(block_tables.long(), 1,
                        (pos // ps).clamp(0, w - 1))               # (B, C)
    offset = pos % ps
    valid = col[None, :] < n_valid.long()[:, None]
    scratch_off = (col[None, :] + torch.arange(b, device=dev)[:, None] * c) \
        % ps
    page = torch.where(valid, page, 0).reshape(-1, 1)
    offset = torch.where(valid, offset, scratch_off).reshape(-1, 1)
    heads = torch.arange(hkv, device=dev)[None, :]
    k_rows = k_new.transpose(1, 2).reshape(b * c, hkv, d)
    v_rows = v_new.transpose(1, 2).reshape(b * c, hkv, d)
    k_pages.index_put_((page, heads, offset), k_rows.to(k_pages.dtype))
    v_pages.index_put_((page, heads, offset), v_rows.to(v_pages.dtype))
    return k_pages, v_pages


def paged_attention_ref(q, k_pages, v_pages, block_tables, q_start, lengths,
                        *, causal=True, window: Optional[int] = None,
                        scale=None):
    """The reference's gather oracle, as it computes: masked softmax with
    ``p`` cast to V's dtype before P·V and V NOT zeroed past the length
    (so idle rows differ from the kernel, which zeroes V)."""
    b, h, tq, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    w = block_tables.shape[1]
    g = h // hkv
    s_max = w * ps
    scale = scale if scale is not None else 1.0 / d ** 0.5
    bt = block_tables.long()
    k = k_pages[bt].transpose(1, 2).reshape(b, hkv, s_max, d)
    v = v_pages[bt].transpose(1, 2).reshape(b, hkv, s_max, d)
    qg = q.reshape(b, hkv, g, tq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    qi = q_start.long()[:, None] + torch.arange(tq, device=q.device)[None, :]
    ki = torch.arange(s_max, device=q.device)
    mask = (ki[None, None, :] < lengths.long()[:, None, None]).expand(
        b, tq, s_max)
    if causal:
        mask = mask & (ki[None, None, :] <= qi[:, :, None])
    if window is not None:
        mask = mask & (ki[None, None, :] > qi[:, :, None] - window)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    o = o / l.clamp_min(1e-30)
    return o.reshape(b, h, tq, d).to(q.dtype)


def paged_attention(q, k_pages, v_pages, block_tables, q_start, lengths, *,
                    causal=True, window: Optional[int] = None, scale=None):
    """Serving attention over paged KV: the K5 wrapper (CUDA kernel for
    CUDA tensors, its plain version for CPU tensors)."""
    return paged_flash_attention(
        q.contiguous(), k_pages, v_pages, block_tables, q_start, lengths,
        causal=causal, window=window, scale=scale)
