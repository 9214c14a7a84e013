"""The dense decoder block on the paged-KV serving path (port of the dense
part of ``repro.models.blocks``).

``ctx`` keys: cfg, policy, rope=(cos, sin), positions (B, C), paged =
{block_tables, q_start, n_valid, lengths}.  Every matmul routes through
mp_dot; the MLP's gating and residual ride its GEMM epilogues.
"""
from __future__ import annotations

import torch

from repro_torch.core.gemm import mp_dot
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_rope, dense_init, init_swiglu, rmsnorm, swiglu_mlp,
)


def norm(params, x, cfg):
    if cfg.norm != "rms":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return rmsnorm(x, params["scale"])


def init_norm(cfg, *, device):
    if cfg.norm != "rms":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    return {"scale": torch.zeros(cfg.d_model, device=device)}


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


def attn_qkv(params, x, cfg, ctx):
    policy = ctx["policy"]
    hd = cfg.head_dim
    q = _split_heads(mp_dot(x, params["wq"], policy=policy), cfg.n_heads, hd)
    k = _split_heads(mp_dot(x, params["wk"], policy=policy), cfg.n_kv_heads,
                     hd)
    v = _split_heads(mp_dot(x, params["wv"], policy=policy), cfg.n_kv_heads,
                     hd)
    return q, k, v


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
            "mlp": init_swiglu(cfg.d_model, cfg.d_ff, generator=generator,
                               device=device)}


def dense_paged_step(params, x, cache, ctx, *, window=None):
    cfg = ctx["cfg"]
    if cfg.mlp != "swiglu":
        raise NotImplementedError(f"mlp {cfg.mlp!r} is not ported yet")
    o = attn_paged_step(params["attn"], norm(params["ln1"], x, cfg), cache,
                        ctx, window=window)
    x = x + o        # plain add in the activation dtype, outside the GEMM
    # The block residual rides the down projection's epilogue.
    return swiglu_mlp(params["mlp"], norm(params["ln2"], x, cfg),
                      ctx["policy"], residual=x)
