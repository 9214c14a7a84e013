"""rwkv6-1.6b ("Finch") — attention-free, data-dependent decay linear
recurrence. [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,  # heads = d/rwkv_head_dim
    d_ff=7168, vocab=65536,
    rwkv_head_dim=64, pos_embed="none",
    mlp="swiglu", norm="rms",
    source="arXiv:2404.05892",
)

SMOKE = ArchConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
    d_ff=256, vocab=512, rwkv_head_dim=64, pos_embed="none",
    mlp="swiglu", norm="rms",
)
