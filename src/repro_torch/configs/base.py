"""Architecture configuration registry (own copy of ``repro.configs.base``).

Each ported architecture gets one file in this package defining ``CONFIG``
(exact published dims) and ``SMOKE`` (reduced same-family config for CPU
tests).  ``get(name)`` resolves either.  Only the architectures whose block
kinds the port can run are registered.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | vlm | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # attention
    window: Optional[int] = None          # sliding-window size (SWA archs)
    rope_theta: float = 10000.0
    pos_embed: str = "rope"               # rope | learned
    causal: bool = True
    # block structure
    mlp: str = "swiglu"                   # swiglu | gelu
    mlp_bias: bool = False
    norm: str = "rms"                     # rms | layer
    tie_embeddings: bool = False
    block_pattern: Tuple[str, ...] = ()   # per-layer kinds; () -> uniform
    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    # vlm
    cross_attn_every: int = 0
    n_image_tokens: int = 0
    # enc-dec (audio)
    encoder_layers: int = 0
    encoder_seq: int = 0
    # recurrent
    rwkv_head_dim: int = 64
    conv_width: int = 4
    lru_width: Optional[int] = None
    local_attn_window: int = 2048
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.block_pattern:
            return self.block_pattern
        if self.family == "moe":
            return ("moe",) * self.n_layers
        if self.family == "ssm":
            return ("rwkv",) * self.n_layers
        return ("dense",) * self.n_layers


ARCH_IDS = [
    "granite-moe-1b-a400m",
    "h2o-danube3-4b",
    "phi3-mini-3.8b",
    "whisper-medium",
]

_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "h2o-danube3-4b": "h2o_danube3_4b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "whisper-medium": "whisper_medium",
}


def get(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet; ported: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


def segment_pattern(pattern):
    """-> (unit, n_units, remainder): smallest unit P<=8 such that the
    pattern is unit-periodic with a unit-prefix remainder (the reference's
    layer stacking: it unstacks the reference's parameters, and its stacks
    are the groups of layers that share one sparsity pattern)."""
    L = len(pattern)
    for p in range(1, min(8, L) + 1):
        n_units = L // p
        if n_units == 0:
            continue
        if all(pattern[i] == pattern[i % p] for i in range(n_units * p)):
            rem = pattern[n_units * p:]
            if all(rem[i] == pattern[i] for i in range(len(rem))):
                return pattern[:p], n_units, rem
    return pattern, 1, ()


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """A run's shape: sequence length and global batch (the reference's
    ``ShapeConfig``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str   # train | prefill | decode
