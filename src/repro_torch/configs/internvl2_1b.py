"""InternVL2-1B (arXiv:2404.16821; hf) — Qwen2-0.5B-class LM + ViT stub."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    qkv_bias=True,
    act="swiglu",
    frontend="vit_stub",
    pad_heads_to=16,  # 16-way TP divisibility (zero-padded q heads)
    n_frontend_tokens=256,    # precomputed InternViT patch embeddings
)
