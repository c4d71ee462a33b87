"""Optimizers of the port: AdamW, for the tabular MLP head."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update

__all__ = ["AdamWState", "adamw_init", "adamw_update"]
