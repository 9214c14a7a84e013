"""Recurrent blocks (port of ``repro.models.recurrent``): RWKV-6 ("Finch")
time and channel mix, and RecurrentGemma's RG-LRU + causal-conv Griffin
block: ``<kind>_fwd`` over a whole prompt or training sequence from a
fresh state (differentiable: the chunked scan rematerialises each chunk
in the backward), ``<kind>_decode`` one token against the carried state.

The reference runs both recurrences with ``lax.scan`` and no Pallas
kernel, so the port runs them as plain torch ops on the tensors' device,
one step a token.  Every projection still goes through ``mp_dot`` or
``mp_dot_grouped`` (K1; K2 or K3 for a packed or tile-sparse weight,
under every policy); the RWKV decay's low-rank f32 product (``w_lora_b``)
is a plain ``@``, as in the reference.  Decode updates the
cache's tensors in place (the reference returns new ones).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.gemm import mp_dot, mp_dot_grouped
from repro_torch.core.gemm_spec import ACTIVATIONS
from repro_torch.models.layers import dense_init, rmsnorm, swiglu_mlp

CHUNK = 128


def _steps(step_fn, state, xs):
    """``step_fn`` over every step of the chunk ``xs`` -> (final state, the
    outputs stacked on a leading time axis)."""
    ys = []
    for i in range(xs[0].shape[0]):
        state, y = step_fn(state, tuple(a[i] for a in xs))
        ys.append(y)
    return state, torch.stack(ys)


def _chunk_scan(step_fn, state, xs, chunk: int):
    """``step_fn`` over the leading time axis of the tensors ``xs``, chunk
    by chunk: -> (final state, the steps' outputs stacked on a leading
    time axis).  The ``T % chunk`` tail runs as a shorter, unpadded chunk:
    a zero-padded tail would run extra recurrence steps and corrupt the
    carried state.

    When autograd records the call, each full chunk is rematerialised in
    the backward (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint`` of its chunk body): the forward keeps only the
    chunk's inputs -- the state at its boundary and its slice of ``xs``
    --, so a layer's backward holds O(T / chunk) states instead of every
    step's.  The tail runs unchecked, as in the reference.  No RNG state
    is kept (``preserve_rng_state=False``): a step draws no random
    numbers.  With grad off (serving) every chunk runs as it is."""
    t = xs[0].shape[0]
    chunk = min(chunk, t)
    remat = torch.is_grad_enabled() and any(
        a.requires_grad for a in (state, *xs))
    parts = []
    for start in range(0, t, chunk):
        part = tuple(a[start:start + chunk] for a in xs)
        if remat and part[0].shape[0] == chunk:
            state, ys = checkpoint(_steps, step_fn, state, part,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            state, ys = _steps(step_fn, state, part)
        parts.append(ys)
    return state, torch.cat(parts) if len(parts) > 1 else parts[0]


# =========================== RWKV-6 (Finch) ===================================

def init_rwkv(cfg, *, generator, device):
    """The reference's leaves and distributions: constant lerp bases
    (0.5), decay base (-6), group-norm scale (1) and norm scales (0)."""
    d = cfg.d_model
    h = d // cfg.rwkv_head_dim
    dh = cfg.rwkv_head_dim
    r = 32  # low rank of the data-dependent lerp / decay
    kw = dict(generator=generator, device=device)
    return {
        "ln1": {"scale": torch.zeros(d, device=device)},
        "ln2": {"scale": torch.zeros(d, device=device)},
        # time mix
        "mu": torch.full((5, d), 0.5, device=device),   # r, k, v, w, g
        "lora_a": dense_init(d, r * 5, **kw),
        "lora_b": torch.randn(5, r, d, **kw) * 0.01,
        "wr": dense_init(d, d, **kw),
        "wk": dense_init(d, d, **kw),
        "wv": dense_init(d, d, **kw),
        "wg": dense_init(d, d, **kw),
        "wo": dense_init(d, d, **kw),
        "w_base": torch.full((d,), -6.0, device=device),
        "w_lora_a": dense_init(d, 64, **kw),
        "w_lora_b": torch.randn(64, d, **kw) * 0.01,
        "u": torch.randn(h, dh, **kw) * 0.1,
        "gn_scale": torch.ones(d, device=device),
        # channel mix
        "mu_c": torch.full((2, d), 0.5, device=device),
        "ck": dense_init(d, cfg.d_ff, **kw),
        "cv": dense_init(cfg.d_ff, d, **kw),
        "cr": dense_init(d, d, **kw),
    }


def _token_shift(x, prev):
    """prev: (B, d), the last token of the previous segment -> x shifted
    one token later along time, ``prev`` first."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _wkv_step(state, inp):
    """state: (B, H, dk, dv); r, k, v, w: (B, H, dh); u: (H, dh)."""
    r, k, v, w, u = inp
    kv = k[..., :, None] * v[..., None, :]               # (B, H, dk, dv)
    out = torch.einsum("bhk,bhkv->bhv", r, state + u[..., :, None] * kv)
    return w[..., :, None] * state + kv, out


def rwkv_time_mix(params, x, prev_shift, state, cfg, policy):
    """x: (B, T, d) -> (out, new shift (B, d), new state (B, H, dh, dh))."""
    b, t, d = x.shape
    h = d // cfg.rwkv_head_dim
    dh = cfg.rwkv_head_dim
    f32 = torch.float32
    xs = _token_shift(x, prev_shift)
    # Data-dependent lerp, mix_i = mu_i + tanh(x A) B_i, its five streams
    # (r, k, v, w, g) one grouped f32 GEMM (group = stream), stream-major.
    lora = torch.tanh(mp_dot(x, params["lora_a"], policy=policy))
    lora5 = lora.reshape(b * t, 5, -1).to(f32).transpose(0, 1)
    dd = mp_dot_grouped(lora5, params["lora_b"], policy="fp32",
                        out_dtype=f32)
    dd = dd.transpose(0, 1).reshape(b, t, 5, d)
    mix = torch.clamp(params["mu"][None, None] + dd, 0.0, 1.0)  # (B,T,5,d)
    xi = (x[:, :, None].to(f32) * mix
          + xs[:, :, None].to(f32) * (1 - mix)).to(x.dtype)
    xr, xk, xv, xw, xg = xi.unbind(2)
    r = mp_dot(xr, params["wr"], policy=policy)
    k = mp_dot(xk, params["wk"], policy=policy)
    v = mp_dot(xv, params["wv"], policy=policy)
    g = mp_dot(xg, params["wg"], policy=policy)
    wlog = -torch.exp(
        params["w_base"][None, None]
        + torch.tanh(mp_dot(xw, params["w_lora_a"], policy=policy)).to(f32)
        @ params["w_lora_b"])                                  # (B,T,d) <= 0
    w = torch.exp(wlog)                                        # in (0, 1)

    def heads(a):
        return a.reshape(b, t, h, dh).transpose(0, 1).to(f32)

    u = params["u"]

    def step(s, inp):
        return _wkv_step(s, (*inp, u))

    state, outs = _chunk_scan(step, state,
                              (heads(r), heads(k), heads(v), heads(w)), CHUNK)
    out = outs.transpose(0, 1).reshape(b, t, d)
    out = rmsnorm(out, params["gn_scale"] - 1.0)      # a group-ish norm
    out = out.to(x.dtype) * F.silu(g.to(f32)).to(x.dtype)
    return mp_dot(out, params["wo"], policy=policy), x[:, -1], state


def rwkv_channel_mix(params, x, prev_shift, policy):
    """-> (out, new shift (B, d))."""
    f32 = torch.float32
    xs = _token_shift(x, prev_shift)
    mix = params["mu_c"][None, None]
    x32, xs32 = x.to(f32), xs.to(f32)
    xk = (x32 * mix[:, :, 0] + xs32 * (1 - mix[:, :, 0])).to(x.dtype)
    xr = (x32 * mix[:, :, 1] + xs32 * (1 - mix[:, :, 1])).to(x.dtype)
    k = mp_dot(xk, params["ck"], policy=policy)
    k = torch.square(torch.relu(k.to(f32))).to(x.dtype)
    v = mp_dot(k, params["cv"], policy=policy)
    r = torch.sigmoid(mp_dot(xr, params["cr"], policy=policy).to(f32))
    return r.to(x.dtype) * v, x[:, -1]


def rwkv_fwd(params, x, ctx):
    """A whole RWKV-6 layer from a fresh state -> (x, aux = 0.0, {"state",
    "shift_t", "shift_c"} | None)."""
    cfg, policy = ctx["cfg"], ctx["policy"]
    b, t, d = x.shape
    dh = cfg.rwkv_head_dim
    state0 = torch.zeros(b, d // dh, dh, dh, device=x.device)
    shift0 = torch.zeros(b, d, dtype=x.dtype, device=x.device)
    o, shift_t, state = rwkv_time_mix(
        params, rmsnorm(x, params["ln1"]["scale"]), shift0, state0, cfg,
        policy)
    x = x + o
    o, shift_c = rwkv_channel_mix(
        params, rmsnorm(x, params["ln2"]["scale"]), shift0, policy)
    x = x + o
    cache = None
    if ctx.get("collect_cache"):
        dt = ctx["cache_dtype"]
        cache = {"state": state, "shift_t": shift_t.to(dt),
                 "shift_c": shift_c.to(dt)}
    return x, 0.0, cache


def rwkv_init_cache(cfg, batch, max_len, dtype, *, device):
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    return {"state": torch.zeros(batch, d // dh, dh, dh, device=device),
            "shift_t": torch.zeros(batch, d, dtype=dtype, device=device),
            "shift_c": torch.zeros(batch, d, dtype=dtype, device=device)}


def rwkv_decode(params, x, cache, ctx):
    """x: (B, 1, d), one recurrence step; ``cache`` is updated in place."""
    cfg, policy = ctx["cfg"], ctx["policy"]
    o, shift_t, state = rwkv_time_mix(
        params, rmsnorm(x, params["ln1"]["scale"]), cache["shift_t"],
        cache["state"], cfg, policy)
    x = x + o
    o, shift_c = rwkv_channel_mix(
        params, rmsnorm(x, params["ln2"]["scale"]), cache["shift_c"], policy)
    cache["state"].copy_(state)
    cache["shift_t"].copy_(shift_t)
    cache["shift_c"].copy_(shift_c)
    return x + o


# =========================== RG-LRU (Griffin) =================================

def init_rglru(cfg, *, generator, device):
    """The reference's leaves and distributions: conv bias 0, lambda 2,
    norm scales 0."""
    d = cfg.d_model
    w = cfg.lru_width or d
    kw = dict(generator=generator, device=device)
    return {
        "ln1": {"scale": torch.zeros(d, device=device)},
        "ln2": {"scale": torch.zeros(d, device=device)},
        "w_x": dense_init(d, w, **kw),          # recurrent branch in-proj
        "w_y": dense_init(d, w, **kw),          # gate branch in-proj
        "conv_w": torch.randn(cfg.conv_width, w, **kw) * 0.1,
        "conv_b": torch.zeros(w, device=device),
        "w_gate_r": dense_init(w, w, **kw),     # recurrence gate
        "w_gate_i": dense_init(w, w, **kw),     # input gate
        "lambda_p": torch.full((w,), 2.0, device=device),
        "w_out": dense_init(w, d, **kw),
        "mlp": {"w_gate": dense_init(d, cfg.d_ff, **kw),
                "w_up": dense_init(d, cfg.d_ff, **kw),
                "w_down": dense_init(cfg.d_ff, d, **kw)},
    }


_C_RGLRU = 8.0


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv1d.  x: (B, T, W); w: (K, W); conv_state: (B,
    K - 1, W), the previous segment's last inputs -> (out, new state)."""
    kw = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros(x.shape[0], kw - 1, x.shape[2],
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state, x], dim=1)
    t = x.shape[1]
    out = sum(xp[:, i:i + t] * w[i][None, None].to(x.dtype)
              for i in range(kw))
    new_state = xp[:, -(kw - 1):] if kw > 1 else conv_state
    return out + b.to(x.dtype), new_state


def rglru_scan(params, u, h0):
    """The RG-LRU recurrence.  u: (B, T, W) conv output; h0: (B, W) f32 ->
    (hidden states (B, T, W) in u's dtype, last state f32).  Both gates
    are f32 GEMMs under the fp32 policy whatever the model's: K1's f32 FMA
    on a dense weight; on a packed or tile-sparse one K2's or K3's f32-A
    route, a bf16 payload cast to f32 at each call and a scaled one (int8,
    int4, fp8) read as it is, as in the reference."""
    f32 = torch.float32
    r = torch.sigmoid(mp_dot(u, params["w_gate_r"], policy="fp32"))
    i = torch.sigmoid(mp_dot(u, params["w_gate_i"], policy="fp32"))
    log_a = -_C_RGLRU * F.softplus(params["lambda_p"])[None, None] * r.to(f32)
    a = torch.exp(log_a)
    gated = i.to(f32) * u.to(f32)
    scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))

    def step(h, inp):
        a_t, gx_t = inp
        h = a_t * h + gx_t
        return h, h

    h_last, hs = _chunk_scan(step, h0, (a.transpose(0, 1),
                                        (scale * gated).transpose(0, 1)),
                             CHUNK)
    return hs.transpose(0, 1).to(u.dtype), h_last


def _rglru_block(params, x, ctx, conv_state, h0):
    """The Griffin block on x (B, T, d) from ``conv_state`` (None: zeros)
    and ``h0`` -> (x, conv state, last h).  The gate branch's GELU (tanh,
    as ``jax.nn.gelu``) runs outside any epilogue; neither residual rides
    one."""
    cfg, policy = ctx["cfg"], ctx["policy"]
    f32 = torch.float32
    h = rmsnorm(x, params["ln1"]["scale"])
    y = ACTIVATIONS["gelu"](mp_dot(h, params["w_y"], policy=policy).to(f32))
    u = mp_dot(h, params["w_x"], policy=policy)
    u, conv_state = _causal_conv(
        u, params["conv_w"], params["conv_b"],
        None if conv_state is None else conv_state.to(u.dtype))
    hs, h_last = rglru_scan(params, u, h0)
    x = x + mp_dot(hs * y.to(hs.dtype), params["w_out"], policy=policy)
    x = x + swiglu_mlp(params["mlp"], rmsnorm(x, params["ln2"]["scale"]),
                       policy, fused=ctx["fused"])
    return x, conv_state, h_last


def rglru_fwd(params, x, ctx):
    """-> (x, aux = 0.0, {"h", "conv"} | None) from a fresh state."""
    cfg = ctx["cfg"]
    w = cfg.lru_width or cfg.d_model
    x, conv_state, h_last = _rglru_block(
        params, x, ctx, None,
        torch.zeros(x.shape[0], w, device=x.device))
    cache = None
    if ctx.get("collect_cache"):
        cache = {"h": h_last, "conv": conv_state.to(ctx["cache_dtype"])}
    return x, 0.0, cache


def rglru_init_cache(cfg, batch, max_len, dtype, *, device):
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros(batch, w, device=device),
            "conv": torch.zeros(batch, cfg.conv_width - 1, w, dtype=dtype,
                                device=device)}


def rglru_decode(params, x, cache, ctx):
    """x: (B, 1, d), one step; ``cache`` is updated in place."""
    x, conv, h_last = _rglru_block(params, x, ctx, cache["conv"],
                                   cache["h"])
    cache["h"].copy_(h_last)
    cache["conv"].copy_(conv)
    return x
