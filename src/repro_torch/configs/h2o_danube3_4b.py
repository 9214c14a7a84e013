"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000,
    window=4096,                 # mistral-style SWA
    rope_theta=10000.0, mlp="swiglu", norm="rms",
    source="arXiv:2401.16818",
)

SMOKE = ArchConfig(
    name="h2o-danube3-4b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, window=64,
    mlp="swiglu", norm="rms",
)
