"""DeepSeek-V2 236B (arXiv:2405.04434; hf) — MLA + 160-expert MoE top-6."""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA: latent-compressed KV, heads expanded on read
    d_ff=12288,              # the single leading dense layer's FFN width
    vocab=102400,
    head_dim=128,
    act="swiglu",
    rope_theta=10000.0,
    dense_layers=1,
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        d_ff_expert=1536,
        n_shared=2,
        d_ff_shared=1536,
        group_size=512,
    ),
    mla=MLAConfig(kv_lora=512, q_lora=1536, rope_dim=64, nope_dim=128, v_dim=128),
)
