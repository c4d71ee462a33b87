"""The LM substrate: layers, MoE, the forward pass and serving (prefill, decode)."""
from repro_torch.models.lm.model import LM

__all__ = ["LM"]
