"""xLSTM-1.3B (arXiv:2405.04517) — mLSTM backbone with interleaved sLSTM."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                   # xLSTM blocks carry their own up-projection
    vocab=50304,
    ssm=SSMConfig(kind="xlstm", head_dim=512, chunk=256, slstm_every=8),
)
