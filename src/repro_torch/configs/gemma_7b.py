"""Gemma-7B (arXiv:2403.08295) — GeGLU, head_dim=256."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256000,
    head_dim=256,
    act="geglu",
)
