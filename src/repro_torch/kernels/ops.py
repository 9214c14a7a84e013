"""The op-level kernel API (port of ``repro.kernels.ops``): the paper's
stand-alone MPGEMM and flash attention.

:func:`mpgemm` is ``out = act(alpha · op(a) @ op(b) · scale + bias) + beta
· c`` over a dense, packed or tile-sparse ``b`` -- one launch of K1, K2 or
K3 for CUDA tensors, their plain versions for CPU tensors.  int8 operands
sum exactly in int32 and default to an int32 output, with the reference's
integer epilogue (alpha, the bias and beta truncated to int32).
:func:`flash_attention` is K4.  There is no backend choice: the device of
the operands decides, and nothing falls back from the card to a plain
version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.gemm_spec import GemmSpec, resolve_epilogue
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mpgemm as _mpgemm
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.packing.layout import PackedOperand
from repro_torch.sparse.layout import TileSparseOperand


def mpgemm(a: torch.Tensor, b, c: Optional[torch.Tensor] = None, *,
           trans_a: bool = False, trans_b: bool = False, alpha: float = 1.0,
           beta: float = 0.0, bias: Optional[torch.Tensor] = None,
           scale=None, activation: Optional[str] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``out = activation(alpha · op(a) @ op(b) · scale + bias) + beta ·
    c`` for 2-D ``a`` (M, K), or (K, M) under ``trans_a``, and ``b`` (K,
    N), or (N, K) under ``trans_b``, or a :class:`PackedOperand` or
    :class:`TileSparseOperand` (whose transpose was resolved when it was
    made: ``trans_b`` is ignored for them, as in the reference).
    ``scale`` is a number or a one-element tensor; ``c`` has the output's
    shape and is read only when ``beta != 0``."""
    epilogue, _ = resolve_epilogue({}, activation=activation, alpha=alpha,
                                   beta=beta)
    if scale is not None and not isinstance(scale, torch.Tensor):
        scale = torch.tensor(float(scale), dtype=torch.float32,
                             device=a.device)
    laid_out = isinstance(b, (PackedOperand, TileSparseOperand))
    spec = GemmSpec(trans_a=trans_a, trans_b=trans_b and not laid_out)
    return _mpgemm.mpgemm(a, b, c=c, bias=bias, scale=scale, spec=spec,
                          epilogue=epilogue, out_dtype=out_dtype)


def flash_attention_fallback_reason(q_dtype, k_dtype,
                                    v_dtype) -> Optional[str]:
    """Why K4 cannot take these operand dtypes -- None when it can.  The
    reference then quietly traces its XLA formula; the port runs the plain
    formula for CPU tensors only and raises on the card."""
    for name, dt in (("q", q_dtype), ("k", k_dtype), ("v", v_dtype)):
        if not dt.is_floating_point:
            return (f"non-float {name} dtype {dt} (the kernel's online "
                    "softmax needs float operands)")
    return None


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None) -> torch.Tensor:
    """Blocked online-softmax attention of q (B, H, Tq, D) over k/v (B,
    Hkv, Tk, D): K4 for CUDA tensors, its plain version for CPU tensors.
    The kernel chooses its own blocks (the reference's ``block_q`` and
    ``block_k`` are TPU tile sizes).  Non-float operands, which the
    reference sends to its XLA formula, take :func:`flash_attention_ref`
    on the CPU and raise ``NotImplementedError`` on the card, naming
    :func:`flash_attention_fallback_reason`'s reason: the card runs no
    plain version."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"GQA requires H % Hkv == 0, got {q.shape[1]} % {k.shape[1]}")
    reason = flash_attention_fallback_reason(q.dtype, k.dtype, v.dtype)
    if reason is None:
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cpu":
        raise NotImplementedError(f"flash_attention on {q.device}: {reason}")
    rep = q.shape[1] // k.shape[1]
    return flash_attention_ref(q, k.repeat_interleave(rep, dim=1),
                               v.repeat_interleave(rep, dim=1),
                               causal=causal, window=window, scale=scale)
