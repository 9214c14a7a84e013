"""starcoder2-3b — GQA (kv=2), RoPE, LayerNorm + GeLU MLP w/ bias.
[arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152,
    rope_theta=100000.0, mlp="gelu", mlp_bias=True, norm="layer",
    source="arXiv:2402.19173",
)

SMOKE = ArchConfig(
    name="starcoder2-3b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
    d_ff=256, vocab=512, mlp="gelu", mlp_bias=True, norm="layer",
)
