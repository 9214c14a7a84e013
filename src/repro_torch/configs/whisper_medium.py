"""whisper-medium — encoder-decoder; conv frontend STUBBED (the serving
path feeds zero frame embeddings). [arXiv:2212.04356; unverified]

24L is interpreted as 24 encoder + 24 decoder blocks (whisper-medium's
published layout); decode exercises the decoder's self-attention ring cache
and the static cross-attention cache."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    encoder_layers=24, encoder_seq=1500,
    pos_embed="learned", causal=True,
    mlp="gelu", mlp_bias=True, norm="layer",
    source="arXiv:2212.04356",
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512,
    encoder_layers=2, encoder_seq=64,
    pos_embed="learned", mlp="gelu", mlp_bias=True, norm="layer",
)
