"""Qwen3-8B (hf:Qwen/Qwen3-8B) — GQA kv=8, qk_norm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    act="swiglu",
    rope_theta=1000000.0,
)
