"""phi3-medium-14b — RoPE, SwiGLU, GQA kv=10. [arXiv:2404.14219]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab=100352,
    rope_theta=10000.0, mlp="swiglu", norm="rms",
    source="arXiv:2404.14219",
)

SMOKE = ArchConfig(
    name="phi3-medium-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=768, mlp="swiglu", norm="rms",
)
