"""Serving front end of the port."""
from repro_torch.serving.server import BiathlonServer, ServerStats

__all__ = ["BiathlonServer", "ServerStats"]
