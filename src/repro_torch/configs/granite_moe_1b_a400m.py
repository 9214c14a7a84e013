"""granite-moe-1b-a400m — 32-expert top-8 MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155,
    n_experts=32, experts_per_token=8,
    rope_theta=10000.0, mlp="swiglu", norm="rms",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

SMOKE = ArchConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=512,
    n_experts=8, experts_per_token=4,
    mlp="swiglu", norm="rms", tie_embeddings=True,
)
