"""Common layers (port of ``repro.models.layers``).  Every matmul routes
through ``core.gemm.mp_dot``; on the fused path (the default) the SwiGLU
gating step, the GELU MLP's bias and activation and the block residual
ride the GEMM's epilogue.  ``fused=False`` takes the reference's unfused
path instead -- the same GEMMs, with the activation, the gating product
and the residual add as separate elementwise ops -- for A/B runs (the
reference's ``fused_epilogue(False)``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.gemm import mp_dot
from repro_torch.core.gemm_spec import ACTIVATIONS
from repro_torch.packing.layout import PackedOperand
from repro_torch.sparse.layout import TileSparseOperand


# --- initializers ------------------------------------------------------------

def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               device) -> torch.Tensor:
    """N(0, 2 / (d_in + d_out)) f32 weight, drawn on ``device``."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return torch.randn(d_in, d_out, generator=generator, device=device) * scale


def embed_init(vocab: int, d: int, *, generator: torch.Generator,
               device) -> torch.Tensor:
    return torch.randn(vocab, d, generator=generator, device=device) * 0.02


# --- norms -------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 scaling by ``(1 + weight)`` (weights start at 0)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (biased variance), then ``x * weight + bias``."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dt)


# --- rotary position embeddings ---------------------------------------------

def rope_frequencies(head_dim: int, max_t: int, theta: float = 10000.0,
                     device=None):
    """(cos, sin) tables of shape (max_t, head_dim / 2), f32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_t, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Split-halves RoPE (not interleaved).  x: (B, H, T, hd); positions:
    (B, T) integer rows into the (maxT, hd/2) tables."""
    cos = cos[positions].unsqueeze(1)              # (B, 1, T, hd/2)
    sin = sin[positions].unsqueeze(1)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- MLPs ---------------------------------------------------------------------

def swiglu_mlp(params, x, policy, residual: Optional[torch.Tensor] = None,
               fused: bool = True):
    """silu(x@w_gate) * (x@w_up) @ w_down [+ residual].  Fused: the gate
    GEMM carries silu and the product with the up projection in its
    epilogue, and the down projection carries the residual add."""
    if fused:
        up = mp_dot(x, params["w_up"], policy=policy)
        h = mp_dot(x, params["w_gate"], policy=policy, activation="silu",
                   gate=up)
        return mp_dot(h, params["w_down"], policy=policy, residual=residual)
    gate = mp_dot(x, params["w_gate"], policy=policy)
    up = mp_dot(x, params["w_up"], policy=policy)
    out = mp_dot(ACTIVATIONS["silu"](gate.float()).to(up.dtype) * up,
                 params["w_down"], policy=policy)
    return out if residual is None else residual + out


def gelu_mlp(params, x, policy, residual: Optional[torch.Tensor] = None,
             fused: bool = True):
    """gelu(x@w_up + b_up) @ w_down + b_down [+ residual].  Fused: the up
    projection carries its bias and the tanh GELU in its epilogue, the down
    projection its bias and the residual add."""
    if fused:
        h = mp_dot(x, params["w_up"], params.get("b_up"), policy=policy,
                   activation="gelu")
        return mp_dot(h, params["w_down"], params.get("b_down"),
                      policy=policy, residual=residual)
    h = mp_dot(x, params["w_up"], params.get("b_up"), policy=policy)
    h = ACTIVATIONS["gelu"](h.float()).to(h.dtype)
    out = mp_dot(h, params["w_down"], params.get("b_down"), policy=policy)
    return out if residual is None else residual + out


def init_gelu_mlp(d: int, f: int, *, generator, device, bias: bool = False):
    """Up and down projections; zero f32 biases when ``bias``."""
    p = {"w_up": dense_init(d, f, generator=generator, device=device),
         "w_down": dense_init(f, d, generator=generator, device=device)}
    if bias:
        p["b_up"] = torch.zeros(f, device=device)
        p["b_down"] = torch.zeros(d, device=device)
    return p


def init_swiglu(d: int, f: int, *, generator, device):
    return {
        "w_gate": dense_init(d, f, generator=generator, device=device),
        "w_up": dense_init(d, f, generator=generator, device=device),
        "w_down": dense_init(f, d, generator=generator, device=device),
    }


# --- embedding / logits -------------------------------------------------------

def logits_from_hidden(x, head, *, tied: bool, policy):
    """tied=True: head is the (V, d) embedding table -> on-the-fly
    transpose; otherwise a (d, V) head.  A packed or tile-sparse head
    (only an untied head is ever transformed) carries its orientation in
    its layout (the transpose was resolved at pack / sparsify time), so the
    layout's flag wins over ``tied``."""
    if isinstance(head, (PackedOperand, TileSparseOperand)):
        return mp_dot(x, head, policy=policy, trans_w=head.layout.trans_w)
    return mp_dot(x, head, policy=policy, trans_w=tied)
