"""Biathlon core stages in PyTorch: QMC, uncertainty, planner, fused executor."""
