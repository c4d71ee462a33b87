"""The dense LM substrate: layer primitives and the forward pass."""
from repro_torch.models.lm.model import LM

__all__ = ["LM"]
