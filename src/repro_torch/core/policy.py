"""Precision policies (own copy of ``repro.core.policy``).

A policy names the dtype GEMM operands are cast to, the accumulator, how
parameters are stored and the activation dtype between layers: fp32, bf16,
bf16_serve and the dynamic int8 policy, whose GEMMs quantize both operands
per tensor (:func:`quantize_per_tensor`) and sum in int32.
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int32": torch.int32,
}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    name: str
    compute_dtype: str   # what GEMM operands are cast to
    acc_dtype: str       # accumulator precision
    param_dtype: str     # how params are stored
    out_dtype: str       # activation dtype flowing between layers
    quantized: bool = False  # dynamic per-tensor int8 quantization

    @property
    def compute(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def out(self) -> torch.dtype:
        return _DTYPES[self.out_dtype]


FP32 = PrecisionPolicy("fp32", "float32", "float32", "float32", "float32")
BF16 = PrecisionPolicy("bf16", "bfloat16", "float32", "float32", "bfloat16")
BF16_SERVE = PrecisionPolicy("bf16_serve", "bfloat16", "float32", "bfloat16",
                             "bfloat16")
INT8 = PrecisionPolicy("int8", "int8", "int32", "bfloat16", "bfloat16",
                       quantized=True)

POLICIES = {p.name: p for p in (FP32, BF16, BF16_SERVE, INT8)}


def get_policy(name_or_policy) -> PrecisionPolicy:
    if isinstance(name_or_policy, PrecisionPolicy):
        return name_or_policy
    return POLICIES[name_or_policy]


def quantize_per_tensor(x: torch.Tensor):
    """Dynamic symmetric per-tensor quantization (the int8 policy):
    ``scale = max(amax, 1e-8) / 127`` and ``q = clip(round(x / scale),
    -127, 127)`` in f32, rounding half to even.  -> (int8 q, 0-d f32 scale
    on x's device).  Both divisions are IEEE divisions by tensors: a
    Python-scalar divisor on a CUDA tensor would make PyTorch multiply by
    its reciprocal, which rounds differently."""
    x32 = x.float()
    amax = x32.abs().amax()
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(x32 / scale).clamp(-127, 127)
    return q.to(torch.int8), scale
