"""Plain torch oracles of the op layer (port of ``repro.kernels.ref``):
:func:`mpgemm_ref` for ``kernels/ops.py::mpgemm`` (and, with rank-3
operands, the grouped GEMM) and :func:`flash_attention_ref` for
``ops.flash_attention``.

Both reuse the kernels' plain versions: the GEMM is
``kernels/mpgemm.py::mpgemm_plain`` under a resolved epilogue, and the
attention takes K4's mask (``kernels/flash_attention.py``); only the
reference's score rounding is written out here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.gemm_spec import resolve_epilogue
from repro_torch.kernels.flash_attention import _attention_mask
from repro_torch.kernels.mpgemm import mpgemm_plain


def mpgemm_ref(a, b, c=None, *, trans_a: bool = False, trans_b: bool = False,
               alpha: float = 1.0, beta: float = 0.0, bias=None, scale=None,
               activation: Optional[str] = None, gate=None, residual=None,
               out_dtype=None):
    """``tail(alpha · op(a) @ op(b) · scale + bias) + beta · c`` with the
    reference's dtypes: int operands sum exactly in int32 and default to
    an int32 output, float operands sum in f32 and keep their dtype."""
    ep, extras = resolve_epilogue({"gate": gate, "residual": residual},
                                  activation=activation, alpha=alpha,
                                  beta=beta)
    return mpgemm_plain(a, b, c=c, bias=bias, scale=scale, extras=extras,
                        epilogue=ep, trans_a=trans_a, trans_b=trans_b,
                        out_dtype=out_dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None,
                        scale=None, bias=None):
    """Softmax attention of q (..., Tq, D) over k/v (..., Tk, D) with the
    heads already matched: the scores in the operands' dtype, then f32
    (as ``jnp.einsum`` rounds them; K4's plain version keeps them in f32),
    the right-aligned causal and window masks at -inf, an f32 softmax and
    P·V, the result in q's dtype."""
    sm_scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    score_dtype = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("...qd,...kd->...qk", q.double(), k.double())
    logits = logits.to(score_dtype).float() * sm_scale
    if bias is not None:
        logits = logits + bias
    mask = _attention_mask(q.shape[-2], k.shape[-2], causal, window,
                           q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("...qk,...kd->...qd", probs,
                        v.to(probs.dtype)).to(q.dtype)
