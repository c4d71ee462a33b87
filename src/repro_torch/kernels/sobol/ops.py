"""Sobol points routed by device: the kernel on CUDA, the plain version on CPU."""
from __future__ import annotations

import torch

from repro_torch.core.qmc import sobol_uint32
from repro_torch.kernels.sobol.sobol import sobol_points

__all__ = ["points"]


def points(m: int, dim: int, skip: int = 0, *, device, use_kernel: bool = True):
    """(m, dim) int64 Sobol points (uint32 values) on ``device``."""
    device = torch.device(device)
    if use_kernel and device.type == "cuda":
        return sobol_points(m, dim, skip, device=device)
    return sobol_uint32(m, dim, skip, device)
