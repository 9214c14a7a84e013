"""mixtral-8x22b — 8-expert top-2 MoE with SWA. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768,
    n_experts=8, experts_per_token=2,
    window=4096,                 # per assignment: SWA
    rope_theta=1000000.0, mlp="swiglu", norm="rms",
    source="arXiv:2401.04088",
)

SMOKE = ArchConfig(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512,
    n_experts=4, experts_per_token=2, window=64,
    mlp="swiglu", norm="rms",
)
