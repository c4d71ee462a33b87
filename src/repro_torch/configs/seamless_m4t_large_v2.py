"""SeamlessM4T-large-v2 (arXiv:2308.11596; hf) — enc-dec, speech stub."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,              # decoder layers
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    act="geglu",
    frontend="audio_stub",
    n_frontend_tokens=1024,   # precomputed speech frame embeddings (encoder input)
)
