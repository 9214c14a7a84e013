"""Per-layer blocks (port of ``repro.models.blocks``): dense, MoE, the
gated cross-attention block of a VLM and the whisper enc-dec decoder
block, each on the wave path (``<kind>_fwd`` over a whole prompt,
``<kind>_decode`` one token against its cache) and, for dense and MoE, on
the paged-KV serving path (``<kind>_paged_step``).  The recurrent kinds
live in ``models/recurrent.py``.

``ctx`` keys: cfg, policy, rope=(cos, sin) | None, positions (B, C),
causal, collect_cache, cache_len, cache_dtype, pos (decode: the wave's
shared position, a 0-d device tensor), cross_states (B, Tsrc, d) for the cross
and enc-dec kinds,
moe_capacity, and paged = {block_tables, q_start, n_valid, lengths} on the
paged path.  Every matmul routes through mp_dot, every expert GEMM through
mp_dot_grouped; every prefill and cross-attention through attention_core
(K4), every paged attention through K5.  The MLPs' gating, bias and
activation and the dense block's residual ride the GEMM epilogues.  Caches
are updated in place (the reference returns new ones).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.gemm import mp_dot, mp_dot_grouped
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_rope, dense_init, gelu_mlp, init_gelu_mlp, init_swiglu, layernorm,
    rmsnorm, swiglu_mlp,
)


def norm(params, x, cfg):
    if cfg.norm == "layer":
        return layernorm(x, params["scale"], params["bias"])
    if cfg.norm == "rms":
        return rmsnorm(x, params["scale"])
    raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")


def init_norm(cfg, *, device):
    d = cfg.d_model
    if cfg.norm == "layer":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    if cfg.norm == "rms":
        return {"scale": torch.zeros(d, device=device)}
    raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")


def _mlp(params, x, ctx, residual=None):
    """The block's MLP with the residual riding the down projection's
    epilogue (on the fused path, ``ctx["fused"]``); callers pass the
    pre-norm stream."""
    cfg, policy, fused = ctx["cfg"], ctx["policy"], ctx["fused"]
    if cfg.mlp == "gelu":
        return gelu_mlp(params, x, policy, residual=residual, fused=fused)
    if cfg.mlp == "swiglu":
        return swiglu_mlp(params, x, policy, residual=residual, fused=fused)
    raise NotImplementedError(f"mlp {cfg.mlp!r} is not ported yet")


def _init_mlp(cfg, *, generator, device):
    kw = dict(generator=generator, device=device)
    if cfg.mlp == "gelu":
        return init_gelu_mlp(cfg.d_model, cfg.d_ff, bias=cfg.mlp_bias, **kw)
    if cfg.mlp == "swiglu":
        return init_swiglu(cfg.d_model, cfg.d_ff, **kw)
    raise NotImplementedError(f"mlp {cfg.mlp!r} is not ported yet")


# --- attention plumbing --------------------------------------------------------

def init_attn(cfg, *, generator, device):
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(generator=generator, device=device)
    return {
        "wq": dense_init(d, cfg.n_heads * hd, **kw),
        "wk": dense_init(d, cfg.n_kv_heads * hd, **kw),
        "wv": dense_init(d, cfg.n_kv_heads * hd, **kw),
        "wo": dense_init(cfg.n_heads * hd, d, **kw),
    }


def _split_heads(x, n_heads, hd):
    b, t, _ = x.shape
    return x.reshape(b, t, n_heads, hd).transpose(1, 2)


def _merge_heads(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attn_qkv(params, x, cfg, ctx, kv_source=None):
    """q from ``x``; k and v from ``kv_source`` (cross-attention) or x."""
    policy = ctx["policy"]
    hd = cfg.head_dim
    q = _split_heads(mp_dot(x, params["wq"], policy=policy), cfg.n_heads, hd)
    src = kv_source if kv_source is not None else x
    k = _split_heads(mp_dot(src, params["wk"], policy=policy),
                     cfg.n_kv_heads, hd)
    v = _split_heads(mp_dot(src, params["wv"], policy=policy),
                     cfg.n_kv_heads, hd)
    return q, k, v


def _self_attention(params, h, ctx, window):
    """Normed input -> (attention output, (k, v) when collecting a cache)."""
    cfg = ctx["cfg"]
    q, k, v = attn_qkv(params, h, cfg, ctx)
    if ctx.get("rope") is not None:
        cos, sin = ctx["rope"]
        q = apply_rope(q, cos, sin, ctx["positions"])
        k = apply_rope(k, cos, sin, ctx["positions"])
    o = attn.attention_core(q, k, v, causal=ctx.get("causal", True),
                            window=window)
    out = mp_dot(_merge_heads(o), params["wo"], policy=ctx["policy"])
    return out, ((k, v) if ctx.get("collect_cache") else None)


def _kv_to_ring_cache(kv, cache_len: int, dtype):
    """Prefill K/V (B, Hkv, S, hd) -> a ring cache of ``cache_len`` slots:
    position p lands in slot p % cache_len, as decode writes it."""
    k, v = kv
    b, hkv, s, hd = k.shape
    if s <= cache_len:
        pad = (0, 0, 0, cache_len - s)
        return {"k": torch.nn.functional.pad(k.to(dtype), pad),
                "v": torch.nn.functional.pad(v.to(dtype), pad)}
    slots = (torch.arange(cache_len, device=k.device) + (s - cache_len)) \
        % cache_len
    out = {}
    for name, t in (("k", k), ("v", v)):
        ring = torch.zeros(b, hkv, cache_len, hd, dtype=dtype,
                           device=k.device)
        ring[:, :, slots] = t[:, :, s - cache_len:].to(dtype)
        out[name] = ring
    return out


def attn_init_cache(cfg, batch, max_len, dtype, window=None, *, device):
    """One layer's zeroed ring cache, ``min(window, max_len)`` slots."""
    cache_len = min(window, max_len) if window else max_len
    shape = (batch, cfg.n_kv_heads, cache_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(params, x, cache, ctx):
    """x: (B, 1, d) normed input -> attention output; the new K/V row is
    written into ``cache``'s ring slot ``pos % S`` in place.  ``pos`` is a
    0-d device tensor: the slot and the valid length are device ops."""
    cfg = ctx["cfg"]
    pos = ctx["pos"]
    q, k, v = attn_qkv(params, x, cfg, ctx)
    if ctx.get("rope") is not None:
        cos, sin = ctx["rope"]            # one row each, at ``pos``
        q = apply_rope(q, cos, sin, ctx["positions"])
        k = apply_rope(k, cos, sin, ctx["positions"])
    s_max = cache["k"].shape[2]
    slot = (pos % s_max).reshape(1)
    cache["k"].index_copy_(2, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, slot, v.to(cache["v"].dtype))
    o = attn.decode_attention(q, cache["k"], cache["v"],
                              (pos + 1).clamp(max=s_max))
    return mp_dot(_merge_heads(o), params["wo"], policy=ctx["policy"])


def _ring_cache(kv, ctx, window):
    cache_len = ctx["cache_len"]
    if window is not None:
        cache_len = min(window, cache_len)
    return _kv_to_ring_cache(kv, cache_len, ctx["cache_dtype"])


def attn_paged_init_cache(cfg, num_pages, page_size, dtype, *, device):
    """One layer's pooled KV pages (page 0 is the reserved scratch page)."""
    shape = (num_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


def attn_paged_step(params, x, cache, ctx, window=None):
    """x: (B, C, d) normed chunk -> attention output; ``cache``'s pages are
    updated in place.  One code path serves decode (C == 1) and chunked
    prefill: rows past n_valid[b] are dead padding, routed to the scratch
    page on write and masked out of the softmax."""
    cfg = ctx["cfg"]
    pg = ctx["paged"]
    q, k, v = attn_qkv(params, x, cfg, ctx)
    cos, sin = ctx["rope"]
    q = apply_rope(q, cos, sin, ctx["positions"])
    k = apply_rope(k, cos, sin, ctx["positions"])
    attn.paged_kv_write(cache["k_pages"], cache["v_pages"], k, v,
                        pg["block_tables"], pg["q_start"], pg["n_valid"])
    o = attn.paged_attention(
        q, cache["k_pages"], cache["v_pages"], pg["block_tables"],
        pg["q_start"], pg["lengths"], window=window)
    return mp_dot(_merge_heads(o), params["wo"], policy=ctx["policy"])


# =============================== dense =========================================

def init_dense(cfg, *, generator, device):
    return {"ln1": init_norm(cfg, device=device),
            "attn": init_attn(cfg, generator=generator, device=device),
            "ln2": init_norm(cfg, device=device),
            "mlp": _init_mlp(cfg, generator=generator, device=device)}


def dense_fwd(params, x, ctx, *, window=None):
    """-> (x, aux = 0.0, ring cache | None)."""
    cfg = ctx["cfg"]
    o, kv = _self_attention(params["attn"], norm(params["ln1"], x, cfg), ctx,
                            window)
    x = x + o
    x = _mlp(params["mlp"], norm(params["ln2"], x, cfg), ctx,
                residual=x)
    return x, 0.0, (None if kv is None else _ring_cache(kv, ctx, window))


def dense_decode(params, x, cache, ctx):
    cfg = ctx["cfg"]
    o = attn_decode(params["attn"], norm(params["ln1"], x, cfg), cache, ctx)
    x = x + o
    return _mlp(params["mlp"], norm(params["ln2"], x, cfg), ctx,
                residual=x)


def dense_paged_step(params, x, cache, ctx, *, window=None):
    cfg = ctx["cfg"]
    o = attn_paged_step(params["attn"], norm(params["ln1"], x, cfg), cache,
                        ctx, window=window)
    x = x + o        # plain add in the activation dtype, outside the GEMM
    # The block residual rides the down projection's epilogue.
    return _mlp(params["mlp"], norm(params["ln2"], x, cfg), ctx,
                residual=x)


# ================================ MoE ========================================

def init_moe(cfg, *, generator, device):
    """Attention, norms, an f32 (d, E) router and three (E, ., .) f32
    expert stacks, with the reference's distributions."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = dict(generator=generator, device=device)
    scale = (2.0 / (d + f)) ** 0.5
    return {"ln1": init_norm(cfg, device=device),
            "attn": init_attn(cfg, **kw),
            "ln2": init_norm(cfg, device=device),
            "router": dense_init(d, e, **kw),
            "w_gate": torch.randn(e, d, f, **kw) * scale,
            "w_up": torch.randn(e, d, f, **kw) * scale,
            "w_down": torch.randn(e, f, d, **kw) * scale}


def moe_topk(gates: torch.Tensor, k: int):
    """(weights, experts) of the ``k`` largest gates, largest first and, on
    ties, the lower expert index first -- ``jax.lax.top_k``'s order, which
    a stable descending sort gives and ``torch.topk`` does not promise."""
    topw, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    return topw[..., :k], topi[..., :k]


def moe_capacity(capacity_factor: float, k: int, s: int, e: int) -> int:
    """Slots per expert and sequence: ``max(1, round(cf · k · s / e))``
    with Python's round half to even, from shapes only."""
    return max(1, int(round(capacity_factor * k * s / e)))


def moe_dispatch(topi: torch.Tensor, e: int, cap: int):
    """Capacity dispatch of each sequence's (token, choice) pairs.

    topi: (b, s, k) expert ids.  -> (src (b, e·cap): the token each expert
    slot reads, ``s`` for an empty slot; dest (b, s·k): the slot of each
    (token, choice) pair in token order, ``e·cap`` for a dropped one).
    Slots go newest token first (the reference's ``route``): pairs are
    ordered by token from last to first, stably sorted by expert, and
    the first ``cap`` of each expert are kept.
    """
    b, s, k = topi.shape
    dev = topi.device
    rev = torch.arange(s - 1, -1, -1, device=dev)
    slot_e = topi[:, rev].reshape(b, s * k)
    slot_t = rev.repeat_interleave(k)
    order = torch.argsort(slot_e, dim=-1, stable=True)
    se = torch.gather(slot_e, 1, order)
    st = slot_t[order]
    counts = torch.zeros(b, e, dtype=torch.long, device=dev).scatter_add_(
        1, slot_e, torch.ones_like(slot_e))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(s * k, device=dev) - torch.gather(starts, 1, se)
    dest = torch.where(rank < cap, se * cap + rank,
                       torch.full_like(se, e * cap))
    # Dropped pairs all land in the extra slot e·cap, which is cut off: the
    # write order of those duplicates does not matter.
    src = torch.full((b, e * cap + 1), s, dtype=torch.long, device=dev)
    src = src.scatter(1, dest, st)[:, :-1]
    dest_tok = torch.empty_like(dest).scatter_(1, order, dest)
    dest_tok = dest_tok.reshape(b, s, k)[:, rev].reshape(b, s * k)
    return src, dest_tok


class DispatchGather(torch.autograd.Function):
    """``apply(x, src, dest_tok, k)``: the capacity buffer (b, e·cap, d)
    of the tokens ``x`` (b, s, d) padded with one zero row, slot i reading
    token ``src[b, i]`` (``s``: the zero row), as ``torch.gather`` reads
    it.  Its backward scatters nothing: ``dest_tok`` (b, s·k), the inverse
    map of :func:`moe_dispatch`, names the slot of each (token, choice)
    pair (``e·cap`` for a dropped one), so a token's gradient is the
    gradient rows of its k slots, gathered from ``grad`` padded with one
    zero row at ``e·cap``, summed in choice order j = 0..k-1 in f32 and
    rounded once to ``x``'s dtype.  autograd through ``torch.gather``
    would ``scatter_add`` the rows into the tokens, on the card in no
    fixed order, so that a training step would not repeat itself bit for
    bit.  The pad row takes no gradient: it is ``new_zeros``."""

    @staticmethod
    def forward(ctx, x, src, dest_tok, k):
        b, _, d = x.shape
        ctx.save_for_backward(dest_tok)
        ctx.k = k
        tok_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
        return torch.gather(tok_pad, 1,
                            src[..., None].expand(b, src.shape[1], d))

    @staticmethod
    def backward(ctx, grad):
        (dest_tok,) = ctx.saved_tensors
        b, _, d = grad.shape
        k, n = ctx.k, dest_tok.shape[1]
        g_pad = torch.cat([grad, grad.new_zeros(b, 1, d)], dim=1)
        rows = torch.gather(g_pad, 1, dest_tok[..., None].expand(b, n, d))
        rows = rows.float().reshape(b, n // k, k, d)
        acc = rows[:, :, 0]
        for j in range(1, k):
            acc = acc + rows[:, :, j]
        return acc.to(grad.dtype), None, None, None


def moe_mlp(params, x, cfg, policy, capacity_factor: float = 1.25,
            return_aux: bool = False, fused: bool = True):
    """Top-k MoE with per-sequence capacity dispatch (the reference's
    ``moe_mlp`` forward).  ``return_aux`` also returns its auxiliary loss,
    ``0.01 · load balance + 0.001 · router z-loss`` (an f32 0-d tensor),
    which serves training; the serve path drops it.

    The router runs in f32 (K1).  Each expert's capacity slots are
    gathered into one (E, b·cap, d) buffer (:class:`DispatchGather`, whose
    backward sums in a fixed order), and the SwiGLU experts run as
    three grouped GEMMs with f32 outputs (group = expert): up, then gate
    with ``silu(·) · up`` fused into its store (unless ``fused`` is off:
    then a plain gate GEMM and the f32 product), then down.  The combine
    sums each token's kept choices in f32, weighted by the renormalised
    top-k gates, and casts to ``x``'s dtype.  No step here waits on the
    host: the capacity comes from shapes.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    logits = mp_dot(x, params["router"], policy="fp32").float()
    gates = torch.softmax(logits, dim=-1)                     # (b, s, e)
    topw, topi = moe_topk(gates, k)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = moe_capacity(capacity_factor, k, s, e)
    src, dest_tok = moe_dispatch(topi, e, cap)

    buf = DispatchGather.apply(x, src, dest_tok, k)           # (b, e·cap, d)
    ebuf = buf.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    f32 = torch.float32
    h_up = mp_dot_grouped(ebuf, params["w_up"], policy=policy, out_dtype=f32)
    if fused:
        h = mp_dot_grouped(ebuf, params["w_gate"], policy=policy,
                           out_dtype=f32, activation="silu", gate=h_up)
    else:
        h_gate = mp_dot_grouped(ebuf, params["w_gate"], policy=policy,
                                out_dtype=f32)
        h = F.silu(h_gate) * h_up
    y = mp_dot_grouped(h, params["w_down"], policy=policy, out_dtype=f32)
    y = y.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)

    # The combine gather's backward scatters too, but its only repeated
    # index is the dropped pairs' slot e·cap, whose gradient the pad row
    # cuts off: every slot it keeps takes one row, in any order.
    y_pad = torch.cat([y, y.new_zeros(b, 1, d)], dim=1)
    contrib = torch.gather(y_pad, 1, dest_tok[..., None].expand(b, s * k, d))
    kept = (dest_tok < e * cap).reshape(b, s, k)
    w = topw.float() * kept
    out = torch.einsum("bskd,bsk->bsd", contrib.reshape(b, s, k, d), w)
    if not return_aux:
        return out.to(x.dtype)
    me = gates.mean(dim=(0, 1))
    counts = torch.zeros(e, device=x.device).scatter_add_(
        0, topi.reshape(-1), torch.ones(topi.numel(), device=x.device))
    ce = counts / (b * s * k)
    zloss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return out.to(x.dtype), 0.01 * (e * (me * ce).sum()) + 0.001 * zloss


def moe_fwd(params, x, ctx, *, window=None):
    """-> (x, aux, ring cache | None); the capacity is ``ctx
    ["moe_capacity"]`` (1.25 unless set)."""
    cfg = ctx["cfg"]
    o, kv = _self_attention(params["attn"], norm(params["ln1"], x, cfg), ctx,
                            window)
    x = x + o
    y, aux = moe_mlp(params, norm(params["ln2"], x, cfg), cfg, ctx["policy"],
                     capacity_factor=ctx.get("moe_capacity", 1.25),
                     return_aux=True, fused=ctx["fused"])
    return x + y, aux, (None if kv is None else _ring_cache(kv, ctx, window))


def moe_decode(params, x, cache, ctx):
    cfg = ctx["cfg"]
    o = attn_decode(params["attn"], norm(params["ln1"], x, cfg), cache, ctx)
    x = x + o
    y = moe_mlp(params, norm(params["ln2"], x, cfg), cfg, ctx["policy"],
                capacity_factor=ctx.get("moe_capacity", 1.25),
                fused=ctx["fused"])
    return x + y


def moe_paged_step(params, x, cache, ctx, *, window=None,
                   capacity_factor: float):
    """The MoE block on the paged serving path: paged attention, then
    :func:`moe_mlp`; both residual adds are plain adds in the activation
    dtype.  Dead padding rows take part in the routing, as in the
    reference."""
    cfg = ctx["cfg"]
    o = attn_paged_step(params["attn"], norm(params["ln1"], x, cfg), cache,
                        ctx, window=window)
    x = x + o
    y = moe_mlp(params, norm(params["ln2"], x, cfg), cfg, ctx["policy"],
                capacity_factor=capacity_factor, fused=ctx["fused"])
    return x + y


# ============================== enc-dec (whisper) ============================

def init_encdec(cfg, *, generator, device):
    kw = dict(generator=generator, device=device)
    return {"ln1": init_norm(cfg, device=device), "attn": init_attn(cfg, **kw),
            "lnx": init_norm(cfg, device=device),
            "xattn": init_attn(cfg, **kw),
            "ln2": init_norm(cfg, device=device),
            "mlp": _init_mlp(cfg, **kw)}


def _cross_attention(params, h, ctx, kv=None):
    """Non-causal attention of ``h``'s queries over the encoder or image
    states (``ctx["cross_states"]``, projected here) or over cached ``kv``.
    -> (output, (k, v))."""
    cfg = ctx["cfg"]
    if kv is None:
        q, k, v = attn_qkv(params, h, cfg, ctx,
                           kv_source=ctx["cross_states"])
    else:
        q = _split_heads(mp_dot(h, params["wq"], policy=ctx["policy"]),
                         cfg.n_heads, cfg.head_dim)
        k, v = kv
    o = attn.attention_core(q, k.to(q.dtype), v.to(q.dtype), causal=False)
    return mp_dot(_merge_heads(o), params["wo"], policy=ctx["policy"]), (k, v)


def encdec_fwd(params, x, ctx):
    """Decoder block: causal self-attention, cross-attention to the encoder
    states, GELU MLP.  -> (x, aux = 0.0, {"self": ring, "cross": {k, v}} |
    None); the cross K/V are computed here once and cached for decode."""
    cfg = ctx["cfg"]
    o, kv = _self_attention(params["attn"], norm(params["ln1"], x, cfg), ctx,
                            None)
    x = x + o
    o, xkv = _cross_attention(params["xattn"], norm(params["lnx"], x, cfg),
                              ctx)
    x = x + o
    x = _mlp(params["mlp"], norm(params["ln2"], x, cfg), ctx,
                residual=x)
    cache = None
    if kv is not None:
        dt = ctx["cache_dtype"]
        cache = {"self": _ring_cache(kv, ctx, None),
                 "cross": {"k": xkv[0].to(dt), "v": xkv[1].to(dt)}}
    return x, 0.0, cache


def encdec_decode(params, x, cache, ctx):
    """One decoder token: the self-attention ring cache grows in place; the
    cross K/V are read back from the cache, never recomputed."""
    cfg = ctx["cfg"]
    o = attn_decode(params["attn"], norm(params["ln1"], x, cfg),
                    cache["self"], ctx)
    x = x + o
    o, _ = _cross_attention(params["xattn"], norm(params["lnx"], x, cfg), ctx,
                            kv=(cache["cross"]["k"], cache["cross"]["v"]))
    x = x + o
    return _mlp(params["mlp"], norm(params["ln2"], x, cfg), ctx,
                residual=x)


def encdec_init_cache(cfg, batch, max_len, dtype, *, device):
    shape = (batch, cfg.n_kv_heads, cfg.encoder_seq, cfg.head_dim)
    return {"self": attn_init_cache(cfg, batch, max_len, dtype,
                                    device=device),
            "cross": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}}


# ============================== cross (VLM) ==================================

def init_cross(cfg, *, generator, device):
    """A gated cross-attention block: norms, the attention over the image
    states, the MLP, and two f32 scalar gates drawn as 0 (the block starts
    as the identity)."""
    kw = dict(generator=generator, device=device)
    return {"ln1": init_norm(cfg, device=device),
            "xattn": init_attn(cfg, **kw),
            "ln2": init_norm(cfg, device=device),
            "mlp": _init_mlp(cfg, **kw),
            "gate_attn": torch.zeros((), device=device),
            "gate_mlp": torch.zeros((), device=device)}


def _gated(x, gate, y):
    """``x + tanh(gate) · y``, the gate's tanh cast to y's dtype first."""
    return x + torch.tanh(gate).to(y.dtype) * y


def cross_fwd(params, x, ctx):
    """-> (x, aux = 0.0, {"k", "v"} of the image states | None): the
    cross-attention's K/V are computed here once and cached for decode.
    Neither residual rides an epilogue: each is gated."""
    cfg = ctx["cfg"]
    o, kv = _cross_attention(params["xattn"], norm(params["ln1"], x, cfg),
                             ctx)
    x = _gated(x, params["gate_attn"], o)
    x = _gated(x, params["gate_mlp"],
               _mlp(params["mlp"], norm(params["ln2"], x, cfg), ctx))
    cache = None
    if ctx.get("collect_cache"):
        dt = ctx["cache_dtype"]
        cache = {"k": kv[0].to(dt), "v": kv[1].to(dt)}
    return x, 0.0, cache


def cross_decode(params, x, cache, ctx):
    """One token against the cached image K/V (never recomputed)."""
    cfg = ctx["cfg"]
    o, _ = _cross_attention(params["xattn"], norm(params["ln1"], x, cfg),
                            ctx, kv=(cache["k"], cache["v"]))
    x = _gated(x, params["gate_attn"], o)
    return _gated(x, params["gate_mlp"],
                  _mlp(params["mlp"], norm(params["ln2"], x, cfg), ctx))


def cross_init_cache(cfg, batch, max_len, dtype, *, device):
    shape = (batch, cfg.n_kv_heads, cfg.n_image_tokens, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
