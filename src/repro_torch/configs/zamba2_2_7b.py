"""Zamba2-2.7B (arXiv:2411.15242; hf) — Mamba2 backbone + shared attn block."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    attn_every=6,             # one shared attention+MLP block every 6 mamba layers
    sliding_window=4096,      # caps shared-attn KV for the 500k-decode cell
)
