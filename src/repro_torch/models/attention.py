"""Attention cores (port of ``repro.models.attention``): the prefill,
training and cross-attention dispatch :func:`attention_core` (K4 forward;
backward the gradient of the form the reference's XLA dispatch picks,
:func:`backward_form`: :func:`dense_attention`, the memory-bounded
:func:`chunked_attention` or the sliding-window
:func:`banded_window_attention`, all plain torch ops), one-token decode
attention against a ring cache (:func:`decode_attention`, plain torch ops,
as the reference has no kernel there), and paged attention for
continuous-batching serving (K5).

Paged KV lives in a pooled page array (P, Hkv, page_size, D) per layer;
each request's logical KV stream is the concatenation of the pages its
block-table row names.  Positions are LOGICAL (page j, offset o -> j*ps +
o); which physical page backs them is irrelevant to masking.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import (
    NEG_INF, flash_attention, paged_flash_attention,
)

# The reference's XLA dispatch: dense attention up to this many queries.
DENSE_MAX_T = 2048


def _repeat_kv(k, h: int):
    """(B, Hkv, T, D) -> (B, H, T, D), each KV head repeated for its group
    (expand, not repeat_interleave, whose output size would be read on the
    host).  With one query head a KV head it is still a reshape, which
    copies a strided K or V to a contiguous one: the layout the dense form
    has always fed its products, and so their bits."""
    b, hkv, t, d = k.shape
    return k[:, :, None].expand(b, hkv, h // hkv, t, d).reshape(b, h, t, d)


def _remat(fn, *args):
    """``fn(*args)`` evaluated again in the backward (its intermediates not
    kept), as the reference's ``jax.checkpoint`` of a scan body; no RNG
    state, so that a captured training step can replay it."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def dense_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, scale=None, lengths=None):
    """The reference's dense attention (its XLA path for short sequences,
    and the one its training differentiates): K/V heads repeated for GQA,
    f32 scores, the right-aligned causal mask, an optional window and
    per-row valid ``lengths``, ``-1e30`` masking, an f32 softmax, ``p``
    rounded to V's dtype, f32 P·V, the result in q's dtype."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
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


def _online_block(i, j, need_mask, qblk, kblk, vblk, m, l, acc, *, causal,
                  scale, qc, kc, tk, offset):
    """One (q-chunk ``i``, kv-chunk ``j``) online-softmax update of the
    running max ``m``, sum ``l`` and f32 accumulator ``acc``.
    ``need_mask=False`` skips the causal and tail mask (a block strictly
    below the diagonal of equal chunks sees every key)."""
    s = torch.einsum("bhqd,bhkd->bhqk", qblk.float(), kblk.float()) * scale
    if need_mask:
        dev = s.device
        qpos = (i * qc + torch.arange(qc, device=dev)[:, None] + offset)
        kpos = j * kc + torch.arange(kc, device=dev)[None, :]
        mask = kpos < tk
        if causal:
            mask = mask & (kpos <= qpos)
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhqk,bhkd->bhqd", p.to(vblk.dtype).float(), vblk.float())
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, *, causal: bool = True, scale=None,
                      q_chunk: int = 1024, kv_chunk: int = 1024):
    """Online-softmax attention over q-chunks x kv-chunks (the reference's
    XLA path for long sequences): a (q_chunk, kv_chunk) block of scores at
    a time, each block rematerialised in the backward, so the backward
    holds one block's scores, never (Tq, Tk).

    Causal self-attention (``tq == tk``) of more than one q-chunk runs the
    triangular schedule: q-chunk ``i`` visits only the kv chunks its last
    query can see, and with equal chunks those strictly below the diagonal
    skip the mask.  Cross or uneven lengths run the rectangular schedule
    (every kv chunk).  Tails are zero-padded and masked; the causal mask
    is right-aligned (``tk - tq``).  The reference's triangular schedule
    visits ``j <= i``, which misses keys when ``q_chunk > kv_chunk``
    (ROADMAP C); with ``q_chunk <= kv_chunk`` the extra chunks it visits
    are fully masked and change no bit, so the port's equals it there.
    """
    b, h, tq, d = q.shape
    tk = k.shape[2]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    scale = scale if scale is not None else 1.0 / d ** 0.5
    qc, kc = min(q_chunk, tq), min(kv_chunk, tk)
    qp = F.pad(q, (0, 0, 0, (-tq) % qc))
    kp = F.pad(k, (0, 0, 0, (-tk) % kc))
    vp = F.pad(v, (0, 0, 0, (-tk) % kc))
    nq, nk = qp.shape[2] // qc, kp.shape[2] // kc
    block = functools.partial(_online_block, causal=causal, scale=scale,
                              qc=qc, kc=kc, tk=tk, offset=tk - tq)
    triangular = causal and nq > 1 and tq == tk
    outs = []
    for i in range(nq):
        qblk = qp[:, :, i * qc:(i + 1) * qc]
        m = torch.full((b, h, qc), NEG_INF, device=q.device)
        l = torch.zeros((b, h, qc), device=q.device)
        acc = torch.zeros((b, h, qc, d), device=q.device)
        last = min(nk - 1, ((i + 1) * qc - 1) // kc) if triangular else nk - 1
        for j in range(last + 1):
            need_mask = not (triangular and qc == kc and j < i)
            m, l, acc = _remat(
                functools.partial(block, i, j, need_mask), qblk,
                kp[:, :, j * kc:(j + 1) * kc], vp[:, :, j * kc:(j + 1) * kc],
                m, l, acc)
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    return torch.cat(outs, dim=2)[:, :, :tq].to(q.dtype)


def _band_block(n, w, scale, qblk, kprev, kblk, vprev, vblk):
    """Query block ``n`` of ``window`` rows against its predecessor's keys
    and its own under the causal window mask (block 0 has no
    predecessor); f32 scores, softmax, P rounded to V's dtype."""
    k2 = torch.cat([kprev, kblk], dim=2)
    v2 = torch.cat([vprev, vblk], dim=2)
    s = torch.einsum("bhqd,bhkd->bhqk", qblk.float(), k2.float()) * scale
    dev = s.device
    qi = torch.arange(w, device=dev)[:, None] + w
    ki = torch.arange(2 * w, device=dev)[None, :]
    mask = (ki <= qi) & (ki > qi - w)
    if n == 0:
        mask = mask & (ki >= w)
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v2.dtype).float(),
                        v2.float())


def banded_window_attention(q, k, v, *, window: int, scale=None):
    """Causal sliding-window self-attention in O(T · 2·window) (the
    reference's XLA path for windowed attention): queries in blocks of
    ``window``, each against its own block and its predecessor's keys
    (zeros, all masked, before block 0) under the exact causal + window
    mask; the tail zero-padded.  Each block is rematerialised in the
    backward, which holds one block's scores.  Exact at any T."""
    b, h, t, d = q.shape
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    scale = scale if scale is not None else 1.0 / d ** 0.5
    w = window
    pad = (-t) % w
    qp, kp, vp = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
    zeros = torch.zeros_like(kp[:, :, :w])
    outs = []
    for n in range((t + pad) // w):
        rows, prev = slice(n * w, (n + 1) * w), slice((n - 1) * w, n * w)
        outs.append(_remat(
            functools.partial(_band_block, n, w, scale), qp[:, :, rows],
            kp[:, :, prev] if n else zeros, kp[:, :, rows],
            vp[:, :, prev] if n else zeros, vp[:, :, rows]))
    return torch.cat(outs, dim=2)[:, :, :t].to(q.dtype)


def backward_form(tq: int, tk: int, *, causal: bool,
                  window: Optional[int]) -> str:
    """The attention form whose gradient :func:`attention_core` takes: the
    reference's XLA pick (banded when a causal window is shorter than half
    the sequence, dense up to ``DENSE_MAX_T`` queries, chunked beyond),
    except where that pick drops the window.  For a causal window with
    ``DENSE_MAX_T < t <= 2 * window`` the reference runs
    ``chunked_attention``, which takes no window (ROADMAP C); the port runs
    the banded form, exact at any length.  A window without causality (no
    model has one) past ``DENSE_MAX_T`` stays dense, for the same
    reason."""
    banded = window is not None and causal and tq == tk
    if banded and tq > 2 * window:
        return "banded"
    if tq <= DENSE_MAX_T:
        return "dense"
    if banded:
        return "banded"
    return "chunked" if window is None else "dense"


def _recompute(q, k, v, causal, window, scale):
    form = backward_form(q.shape[2], k.shape[2], causal=causal,
                         window=window)
    if form == "banded":
        return banded_window_attention(q, k, v, window=window, scale=scale)
    if form == "chunked":
        return chunked_attention(q, k, v, causal=causal, scale=scale)
    return dense_attention(q, k, v, causal=causal, window=window,
                           scale=scale)


class _Attention(torch.autograd.Function):
    """K4 forward; backward the gradient of the form
    :func:`backward_form` picks.

    The reference has no attention-backward kernel: its flash kernel (K4)
    has no VJP, so it trains on its XLA backend, where XLA differentiates
    the form its ``attention_core`` picks there.  The port keeps K4 for
    the forward on the card and, on every device, recomputes that form
    from the saved q, k, v in the backward and differentiates it with
    autograd -- the counterpart of the reference's XLA-computed gradient
    (with the windowed pick repaired: :func:`backward_form`).
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
            out = _recompute(*qkv, causal, window, scale)
            grads = torch.autograd.grad(out, qkv, do)
        return (*grads, None, None, None)


def attention_core(q, k, v, *, causal: bool = True,
                   window: Optional[int] = None, scale=None):
    """Prefill / training / cross-attention: q (B, H, Tq, D) over k/v (B,
    Hkv, Tk, D), the causal mask right-aligned.  The forward is the K4
    wrapper, which dispatches by device: its CUDA kernel for CUDA tensors,
    its plain version for CPU tensors (the reference picks its XLA
    algorithms on the CPU; the math is the same).  The backward is the
    gradient of the form :func:`backward_form` picks (:class:`_Attention`
    says why); when autograd records nothing (serving) the K4 wrapper runs
    alone."""
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
