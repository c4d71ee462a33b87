"""QMC uniforms for Approximate Model Inference (paper §3.3).

Port of ``repro/core/propagation.py::qmc_uniforms`` (no digital shift: the
fused executor draws from the plain Sobol grid).  On a CUDA device the
uniforms come from the ``sobol_points`` kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sobol.ops import uniforms

__all__ = ["qmc_grid", "qmc_uniforms"]


def qmc_uniforms(m: int, dim: int, *, device, use_kernel: bool = True) -> torch.Tensor:
    """(m, dim) f32 low-discrepancy uniforms ``(x + 0.5) / 2³²`` on ``device``."""
    return uniforms(m, dim, 0, device=device, use_kernel=use_kernel)


def qmc_grid(m: int, m_sobol: int, k: int, *, device,
             use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused executor's two grids, ``(qmc_uniforms(m, k),
    qmc_uniforms(m_sobol, 2k))``, as views of ONE (max(m, m_sobol), 2k) grid.

    A Sobol point's first k coordinates do not depend on the dimension
    count, so the (m, k) grid is the first k columns of the 2k-dimensional
    one; on the card the whole grid is one ``sobol_points`` launch.
    """
    u = qmc_uniforms(max(m, m_sobol), 2 * k, device=device, use_kernel=use_kernel)
    return u[:m, :k], u[:m_sobol]
