"""QMC uniforms for Approximate Model Inference (paper §3.3).

Port of ``repro/core/propagation.py::qmc_uniforms`` (no digital shift: the
fused executor draws from the plain Sobol grid).  On a CUDA device the
points come from the ``sobol_points`` kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sobol.ops import points

__all__ = ["qmc_uniforms"]


def qmc_uniforms(m: int, dim: int, *, device, use_kernel: bool = True) -> torch.Tensor:
    """(m, dim) f32 low-discrepancy uniforms ``(x + 0.5) / 2³²`` on ``device``."""
    x = points(m, dim, 0, device=device, use_kernel=use_kernel)
    return x.to(torch.float32) * 2.0**-32 + 0.5 * 2.0**-32
