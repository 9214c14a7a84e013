"""llama-3.2-vision-11b — text backbone with gated cross-attention layers
every 5th layer; vision frontend STUBBED (input_specs provides precomputed
patch embeddings, per the assignment).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    cross_attn_every=5, n_image_tokens=1600,
    rope_theta=500000.0, mlp="swiglu", norm="rms",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)

SMOKE = ArchConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=5, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512,
    cross_attn_every=5, n_image_tokens=32,
    mlp="swiglu", norm="rms",
)
