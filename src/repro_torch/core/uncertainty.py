"""Feature uncertainty sampling for the fused executor (paper §3.2, ``U_x``).

Port of the parametric part of ``repro/core/uncertainty.py``: each
approximated feature draws ``x̂ + σ·Φ⁻¹(u)`` at its QMC uniform.  Holistic
(bootstrap-replicate) features are a later slice of the port.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import fma

__all__ = ["sample_features_fused"]


def sample_features_fused(
    value: torch.Tensor,     # (k,) point estimates
    sigma: torch.Tensor,     # (k,) Normal error stddevs
    normals: torch.Tensor,   # (m, k) Φ⁻¹(u) of the QMC uniforms
) -> torch.Tensor:
    """(m, k) feature rows ``value + sigma · normals``, rounded once per element.

    The executor transforms its fixed QMC grid to normals once per build;
    the multiply-add rounds once, as the reference's fused program rounds it.
    """
    return fma(sigma[None, :], normals, value[None, :])
