"""Feature uncertainty sampling for the fused executor (paper §3.2, ``U_x``).

Port of ``repro/core/uncertainty.py::sample_features_fused``.  Parametric
features draw ``x̂ + σ·Φ⁻¹(u)`` at their QMC uniform.  Holistic
(MEDIAN/QUANTILE) features draw the empirical inverse CDF of their sorted
bootstrap-replicate row at the same uniform: ``reps[f, clip(int(u·B), 0,
B − 1)]``.  The grid is fixed per executor, so both the normals and the
replicate indices are computed once, at build time.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import fma

__all__ = ["replicate_indices", "sample_features_fused"]


def replicate_indices(u: torch.Tensor, hol_idx: torch.Tensor, n_boot: int) -> torch.Tensor:
    """(m, h) int64 replicate-table columns of the holistic features' uniforms.

    ``int(u·B)`` truncates toward zero, as the reference's ``astype(int32)``.
    """
    idx = (u[:, hol_idx].to(torch.float32) * n_boot).to(torch.int32)
    return torch.clamp(idx, 0, n_boot - 1).to(torch.int64)


def sample_features_fused(
    value: torch.Tensor,     # (k,) point estimates
    sigma: torch.Tensor,     # (k,) Normal error stddevs (0 for holistic)
    normals: torch.Tensor,   # (m, k) Φ⁻¹(u) of the QMC uniforms
    replicates: torch.Tensor | None = None,  # (h, B) sorted replicate table
    rep_idx: torch.Tensor | None = None,     # (m, h) from replicate_indices
    hol_idx: torch.Tensor | None = None,     # (h,) holistic feature indices
) -> torch.Tensor:
    """(m, k) feature rows: ``value + sigma · normals``, holistic columns replaced.

    The multiply-add rounds once, as the reference's fused program rounds
    it.  A holistic column ``j = hol_idx[f]`` takes ``replicates[f,
    rep_idx[:, f]]``.
    """
    rows = fma(sigma[None, :], normals, value[None, :])
    if hol_idx is None or hol_idx.numel() == 0:
        return rows
    h = hol_idx.shape[0]
    emp = replicates[torch.arange(h, device=rows.device)[None, :], rep_idx]   # (m, h)
    return rows.index_copy(1, hol_idx, emp)
