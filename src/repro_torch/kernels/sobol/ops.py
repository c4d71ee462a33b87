"""Sobol points routed by device: the kernel on CUDA, the plain version on CPU."""
from __future__ import annotations

import torch

from repro_torch.core.qmc import sobol_uint32
from repro_torch.kernels.sobol.sobol import sobol_points

__all__ = ["points", "to_uniforms", "uniforms"]


def to_uniforms(x: torch.Tensor) -> torch.Tensor:
    """Float32 QMC uniforms ``(x + 0.5)·2⁻³²`` of uint32 points, rounded as the
    reference's ``qmc_uniforms`` rounds them (the plain version)."""
    return x.to(torch.float32) * 2.0**-32 + 0.5 * 2.0**-32


def points(m: int, dim: int, skip: int = 0, *, device, use_kernel: bool = True):
    """(m, dim) int64 Sobol points (uint32 values) on ``device``."""
    device = torch.device(device)
    if use_kernel and device.type == "cuda":
        return sobol_points(m, dim, skip, device=device).to(torch.int64) & 0xFFFFFFFF
    return sobol_uint32(m, dim, skip, device)


def uniforms(m: int, dim: int, skip: int = 0, *, device, use_kernel: bool = True):
    """(m, dim) float32 QMC uniforms of the Sobol points on ``device``: on the
    card written by the kernel in the same pass as the points."""
    device = torch.device(device)
    if use_kernel and device.type == "cuda":
        return sobol_points(m, dim, skip, device=device, uniforms=True)
    return to_uniforms(sobol_uint32(m, dim, skip, device))
