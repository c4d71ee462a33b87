"""Qwen1.5-0.5B (hf:Qwen/Qwen1.5-0.5B) — QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    act="swiglu",
)
