"""Runnable scenarios of the port (``python -m repro_torch.examples.<name>``)."""
