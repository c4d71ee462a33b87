"""Qwen3-14B (hf:Qwen/Qwen3-14B family) — GQA kv=8, qk_norm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    act="swiglu",
    rope_theta=1000000.0,
    pad_heads_to=16,  # 16-way TP divisibility (zero-padded q heads)
)
