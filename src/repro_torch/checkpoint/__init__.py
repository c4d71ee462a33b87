"""Checkpoints in the reference's file layout: atomic, async, with retention."""
from repro_torch.checkpoint.manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "load_pytree", "save_pytree"]
