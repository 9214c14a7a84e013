"""``mp_dot`` — the mixed-precision GEMM op every projection goes through
(port of the forward of ``repro.core.gemm.mp_dot``).

It applies a :class:`PrecisionPolicy` (cast both operands to the compute
dtype, accumulate in f32, run the epilogue in f32, cast to the policy's
output dtype), resolves the fusion epilogue from named operands, and hands
one 2-D GEMM to the K1 wrapper, which runs the CUDA kernel for CUDA tensors
and the plain version for CPU tensors.

Serving needs no backward pass, so this is a plain function; the custom
``torch.autograd.Function`` with fused-transpose backward GEMMs comes with
the training slice.  Packed and tile-sparse ``b`` operands and ``quant_in``
raise until their slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec, \
    resolve_epilogue
from repro_torch.core.policy import get_policy
from repro_torch.kernels.mpgemm import mpgemm


def _build_epilogue(epilogue, activation, gate, residual, epilogue_operands):
    """The op-level EpilogueSpec and ordered extras (registry-resolved)."""
    named = {"gate": gate, "residual": residual}
    if epilogue_operands:
        named.update(epilogue_operands)
    epilogue, extras = resolve_epilogue(named, epilogue=epilogue,
                                        activation=activation)
    if epilogue.beta != 0.0:
        raise ValueError(
            "beta·C accumulation is a kernel-level epilogue; mp_dot has no C "
            "operand")
    return epilogue, extras


def mp_dot(
    x: torch.Tensor,
    b: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    policy="bf16",
    trans_w: bool = False,
    out_dtype: Optional[torch.dtype] = None,
    activation: Optional[str] = None,
    gate: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    epilogue: Optional[EpilogueSpec] = None,
    epilogue_operands: Optional[dict] = None,
    quant_in: bool = False,
) -> torch.Tensor:
    """y[..., n] = tail(x[..., k] @ (b[n, k]ᵀ if trans_w else b[k, n]) + bias).

    ``activation`` fuses an activation into the GEMM's store; ``gate``
    fuses ``act(·) · gate`` and ``residual`` fuses ``act(·) + residual``
    (both shaped like the output).  A weight already in the compute dtype
    (cast once at load time) is used as it is.
    """
    if quant_in:
        raise NotImplementedError("quant_in (per-token activation "
                                  "quantization) is not ported yet")
    if not isinstance(b, torch.Tensor):
        raise NotImplementedError(
            f"mp_dot: {type(b).__name__} operands (packed / tile-sparse) are "
            "not ported yet")
    policy = get_policy(policy)
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1]).to(policy.compute).contiguous()
    w = b.to(policy.compute).contiguous()
    if bias is not None:
        bias = bias.reshape(-1)
    epilogue, extras = _build_epilogue(epilogue, activation, gate, residual,
                                       epilogue_operands)
    extras = tuple(e.reshape(-1, e.shape[-1]).contiguous() for e in extras)
    n = w.shape[0] if trans_w else w.shape[-1]
    out_dtype = out_dtype or policy.out
    y2d = mpgemm(x2d, w, bias=bias, extras=extras,
                 spec=GemmSpec(trans_b=trans_w, out_dtype=out_dtype),
                 epilogue=epilogue, out_dtype=out_dtype)
    return y2d.reshape(*lead, n)
