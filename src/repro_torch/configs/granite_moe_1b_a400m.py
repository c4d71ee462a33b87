"""IBM Granite 3.0 1B-A400M (hf:ibm-granite/granite-3.0-1b-a400m-base)."""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    act="swiglu",
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512, group_size=256),
)
