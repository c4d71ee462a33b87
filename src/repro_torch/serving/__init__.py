"""Serving front end of the port."""
from repro_torch.serving.server import BiathlonServer

__all__ = ["BiathlonServer"]
