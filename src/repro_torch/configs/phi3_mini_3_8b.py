"""phi3-mini-3.8b — RoPE, SwiGLU, GQA kv=32 (== MHA). [arXiv:2404.14219]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
    rope_theta=10000.0, mlp="swiglu", norm="rms",
    source="arXiv:2404.14219",
)

SMOKE = ArchConfig(
    name="phi3-mini-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=192, vocab=512, mlp="swiglu", norm="rms",
)
