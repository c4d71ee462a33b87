"""Feature uncertainty (paper §3.2, ``U_x``) and sampling from it.

Port of ``repro/core/uncertainty.py``.  :class:`FeatureUncertainty` holds k
features' error distributions in fixed shapes: a Normal σ for parametric
aggregates, a sorted bootstrap-replicate row for holistic ones; the
host-loop executor samples it with :func:`sample_features`.  The fused
executor carries (value, σ) and a compact holistic replicate table
instead (:func:`sample_features_fused`).  Parametric
features draw ``x̂ + σ·Φ⁻¹(u)`` at their QMC uniform.  Holistic
(MEDIAN/QUANTILE) features draw the empirical inverse CDF of their sorted
bootstrap-replicate row at the same uniform: ``reps[f, clip(int(u·B), 0,
B − 1)]``.  The grid is fixed per executor, so both the normals and the
replicate indices are computed once, at build time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.qmc import uniform_to_normal
from repro_torch.numerics import fma

__all__ = [
    "FeatureUncertainty",
    "exact_uncertainty",
    "replicate_indices",
    "sample_features",
    "sample_features_fused",
]


class FeatureUncertainty(NamedTuple):
    """Uncertainty of ``k`` features, fixed shapes (k,) and (k, B).

    value:        point estimate x̂ per feature.
    sigma:        Normal error stddev (0 when exact or empirical).
    replicates:   sorted bootstrap replicates per feature (value-filled when
                  parametric, so gathering from them is always safe).
    is_empirical: which features use the replicate table.
    """

    value: torch.Tensor         # (k,) float32
    sigma: torch.Tensor         # (k,) float32
    replicates: torch.Tensor    # (k, B) float32, sorted along B
    is_empirical: torch.Tensor  # (k,) bool

    @property
    def k(self) -> int:
        return self.value.shape[-1]

    @property
    def n_replicates(self) -> int:
        return self.replicates.shape[-1]

    def effective_std(self) -> torch.Tensor:
        """Stddev of the error distribution regardless of representation
        (population std of the replicates, ddof 0, as ``jnp.std``)."""
        emp_std = torch.std(self.replicates, dim=-1, correction=0)
        return torch.where(self.is_empirical, emp_std, self.sigma)


def exact_uncertainty(values: torch.Tensor, n_replicates: int = 1) -> FeatureUncertainty:
    """Zero-uncertainty wrapper for exactly computed features."""
    values = torch.as_tensor(values, dtype=torch.float32)
    k = values.shape[-1]
    return FeatureUncertainty(
        value=values,
        sigma=torch.zeros((k,), dtype=torch.float32, device=values.device),
        replicates=values[:, None].expand(k, n_replicates).clone(),
        is_empirical=torch.zeros((k,), dtype=torch.bool, device=values.device),
    )


def sample_features(unc: FeatureUncertainty, u: torch.Tensor) -> torch.Tensor:
    """(m, k) feature samples from ``x̂ + U_x`` by inverse CDF of ``u`` (m, k).

    Parametric features draw ``x̂ + σ·Φ⁻¹(u)``, a multiply then an add (the
    reference runs this stage op by op, so nothing is contracted); holistic
    ones the empirical inverse CDF of their sorted replicate row,
    ``reps[j, clip(int(u·B), 0, B − 1)]``.  Exact features (σ = 0,
    parametric) come out constant.
    """
    parametric = unc.value[None, :] + unc.sigma[None, :] * uniform_to_normal(u)
    b = unc.n_replicates
    idx = torch.clamp((u * b).to(torch.int32), 0, b - 1).to(torch.int64)   # (m, k)
    empirical = torch.gather(unc.replicates, 1, idx.T).T                     # (m, k)
    return torch.where(unc.is_empirical[None, :], empirical, parametric)


def replicate_indices(u: torch.Tensor, hol_idx: torch.Tensor, n_boot: int) -> torch.Tensor:
    """(m, h) int64 replicate-table columns of the holistic features' uniforms.

    ``int(u·B)`` truncates toward zero, as the reference's ``astype(int32)``.
    """
    idx = (u[:, hol_idx].to(torch.float32) * n_boot).to(torch.int32)
    return torch.clamp(idx, 0, n_boot - 1).to(torch.int64)


def sample_features_fused(
    value: torch.Tensor,     # (..., k) point estimates
    sigma: torch.Tensor,     # (..., k) Normal error stddevs (0 for holistic)
    normals: torch.Tensor,   # (m, k) Φ⁻¹(u) of the QMC uniforms
    replicates: torch.Tensor | None = None,  # (..., h, B) sorted replicate table
    rep_idx: torch.Tensor | None = None,     # (m, h) from replicate_indices
    hol_idx: torch.Tensor | None = None,     # (h,) holistic feature indices
) -> torch.Tensor:
    """(..., m, k) feature rows: ``value + sigma · normals``, holistic columns replaced.

    The leading dimensions are lanes (one request each) sharing the QMC
    grid.  The multiply-add rounds once, as the reference's fused program
    rounds it.  A holistic column ``j = hol_idx[f]`` takes ``replicates[...,
    f, rep_idx[:, f]]``.
    """
    rows = fma(sigma[..., None, :], normals, value[..., None, :])
    if hol_idx is None or hol_idx.numel() == 0:
        return rows
    h = hol_idx.shape[0]
    emp = replicates[..., torch.arange(h, device=rows.device)[None, :], rep_idx]  # (..., m, h)
    return rows.index_copy(-1, hol_idx, emp)
