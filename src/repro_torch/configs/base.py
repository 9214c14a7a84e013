"""Architecture configuration registry (own copy of ``repro.configs.base``).

Each ported architecture gets one file in this package defining ``CONFIG``
(exact published dims) and ``SMOKE`` (reduced same-family config for CPU
tests).  ``get(name)`` resolves either; every architecture of the
reference's ``ARCH_IDS`` is registered.
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
    pos_embed: str = "rope"               # rope | learned | none
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
    cross_attn_every: int = 0             # insert 1 cross block every N layers
    n_image_tokens: int = 0
    # enc-dec (audio)
    encoder_layers: int = 0
    encoder_seq: int = 0                  # stub frontend output length
    # recurrent
    rwkv_head_dim: int = 64
    conv_width: int = 4
    lru_width: Optional[int] = None
    local_attn_window: int = 2048         # hybrid local-attention window
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
        if self.family == "vlm" and self.cross_attn_every:
            unit = ("dense",) * (self.cross_attn_every - 1) + ("cross",)
            reps = self.n_layers // self.cross_attn_every
            rem = self.n_layers - reps * self.cross_attn_every
            return unit * reps + ("dense",) * rem
        if self.family == "ssm":
            return ("rwkv",) * self.n_layers
        return ("dense",) * self.n_layers

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SWA / recurrent / hybrid-local)."""
        if self.window is not None:
            return True
        return all(k in ("rwkv", "rglru", "attn_local")
                   for k in self.pattern) or \
            any(k in ("rwkv", "rglru") for k in self.pattern)

    def active_params(self, seq_len: int = 0) -> int:
        """Approximate active parameter count (per-token for MoE)."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
            self.n_heads * hd * d
        mlp_mats = 2 if self.mlp == "gelu" else 3
        per = {}
        per["dense"] = attn + mlp_mats * d * f
        per["attn_local"] = per["dense"]
        per["cross"] = per["dense"]
        per["moe"] = attn + mlp_mats * d * f * max(
            1, self.experts_per_token) + d * self.n_experts
        per["rwkv"] = 6 * d * d + 2 * d * f + d * d
        w = self.lru_width or d
        per["rglru"] = 2 * d * w + 2 * w * w + w * d + 3 * d * f
        total = sum(per[k] for k in self.pattern)
        total += self.encoder_layers * per.get("dense", 0)
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return total

    def total_params(self) -> int:
        d, f = self.d_model, self.d_ff
        extra = 0
        if self.family == "moe":
            mlp_mats = 2 if self.mlp == "gelu" else 3
            per_layer_experts = mlp_mats * d * f * self.n_experts
            per_layer_active = mlp_mats * d * f * max(
                1, self.experts_per_token)
            extra = len(self.pattern) * (per_layer_experts - per_layer_active)
        return self.active_params() + extra


ARCH_IDS = [
    "h2o-danube3-4b",
    "starcoder2-3b",
    "phi3-mini-3.8b",
    "phi3-medium-14b",
    "mixtral-8x22b",
    "granite-moe-1b-a400m",
    "llama-3.2-vision-11b",
    "rwkv6-1.6b",
    "whisper-medium",
    "recurrentgemma-2b",
]

_MODULES = {
    "h2o-danube3-4b": "h2o_danube3_4b",
    "starcoder2-3b": "starcoder2_3b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "mixtral-8x22b": "mixtral_8x22b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "whisper-medium": "whisper_medium",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def get(name: str, smoke: bool = False) -> ArchConfig:
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


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_shape(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-not) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: O(L^2) at 512k (DESIGN.md §4)"
    return True, ""
