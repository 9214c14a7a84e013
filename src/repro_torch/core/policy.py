"""Precision policies (own copy of ``repro.core.policy``).

A policy names the dtype GEMM operands are cast to, the accumulator, how
parameters are stored and the activation dtype between layers.  The port
takes fp32, bf16 and bf16_serve; the dynamic-int8 policy exists as a name so
that asking for it fails clearly until its kernel variant is ported.
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
    """The named policy; raises ``NotImplementedError`` for int8, whose
    quantized GEMM variant is not ported yet."""
    policy = (name_or_policy if isinstance(name_or_policy, PrecisionPolicy)
              else POLICIES[name_or_policy])
    if policy.quantized:
        raise NotImplementedError(
            f"policy {policy.name!r} needs the int8 GEMM variant, which is "
            "not ported yet; use fp32, bf16 or bf16_serve")
    return policy
