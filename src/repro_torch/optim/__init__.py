"""Optimizers of the port: AdamW, clipping and schedules; gradient compression."""
from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    linear_warmup_cosine,
)

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_warmup_cosine",
]
