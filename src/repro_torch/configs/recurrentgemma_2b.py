"""recurrentgemma-2b — Griffin: RG-LRU recurrent blocks + local attention,
pattern (recurrent, recurrent, local-attn).  MQA kv=1, head_dim 256.
[arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ArchConfig

_PATTERN = tuple(
    ["rglru", "rglru", "attn_local"] * 8 + ["rglru", "rglru"]
)  # 26 layers

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000,
    head_dim=256, block_pattern=_PATTERN,
    local_attn_window=2048, lru_width=2560, conv_width=4,
    rope_theta=10000.0, mlp="swiglu", norm="rms",
    tie_embeddings=True,
    source="arXiv:2402.19427",
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=5, d_model=128, n_heads=2, n_kv_heads=1,
    d_ff=256, vocab=512,
    head_dim=64, block_pattern=("rglru", "rglru", "attn_local", "rglru", "rglru"),
    local_attn_window=64, lru_width=128, conv_width=4,
    mlp="swiglu", norm="rms", tie_embeddings=True,
)
