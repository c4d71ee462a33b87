"""Online-aggregation estimators with uncertainty (paper §3.2, AFC).

Port of the batched parametric tail of ``repro/data/aggregates.py``: the
power sums ``[count, Σu, Σu², Σu³, Σu⁴]`` of a z-prefix (``u = v − shift``)
become a point estimate and a Normal error σ per feature, with the
finite-population correction for sampling without replacement.  Holistic
operators (MEDIAN/QUANTILE) keep their ids here; their estimates come from
the bootstrap path (``kernels/sampled_agg/ops.py::masked_quantile_estimates``
and the rank index in ``prefix_stats.py``), which overrides their slots.
"""
from __future__ import annotations

import torch

from repro_torch.numerics import fma

__all__ = ["AGG_IDS_FULL", "HOLISTIC_AGGS", "estimates_from_power_sums"]

HOLISTIC_AGGS = ("median", "quantile")
AGG_IDS_FULL = {"avg": 0, "sum": 1, "count": 2, "var": 3, "std": 4, "median": 5, "quantile": 6}


def _select(agg_ids: torch.Tensor, options) -> torch.Tensor:
    """``jnp.select`` over AGG_IDS 0..4; other ids give 0."""
    out = torch.zeros_like(options[0])
    for i in reversed(range(len(options))):
        out = torch.where(agg_ids == i, options[i], out)
    return out


def _select_value_sigma(mean, m2, m4, zf, z, n, agg_ids):
    """Unbiasing, FPC, delta-method σ's and the AGG_IDS select.

    Inputs are per-feature centered moments (biased m2/m4 over zf samples).
    """
    nf = n.to(torch.float32)
    s2 = m2 * zf / torch.clamp(zf - 1.0, min=1.0)
    fpc = torch.sqrt(torch.clamp((nf - zf) / torch.clamp(nf - 1.0, min=1.0), 0.0, 1.0))
    se_mean = torch.sqrt(torch.clamp(s2, min=0.0) / zf) * fpc
    var_s2 = torch.clamp(
        (m4 - m2 * m2 * (zf - 3.0) / torch.clamp(zf - 1.0, min=1.0)) / zf, min=0.0
    )
    sigma_var = torch.sqrt(var_s2) * fpc
    sigma_std = torch.sqrt(var_s2 / torch.clamp(4.0 * s2, min=1e-12)) * fpc
    std = torch.sqrt(torch.clamp(s2, min=0.0))
    value = _select(agg_ids, [mean, nf * mean, nf * mean, s2, std])
    sigma = _select(agg_ids, [se_mean, nf * se_mean, nf * se_mean, sigma_var, sigma_std])
    sigma = torch.where(z >= n, torch.zeros_like(sigma), sigma)
    return value, sigma


def estimates_from_power_sums(moments, z, n, agg_ids, shift=None):
    """(value, sigma) per feature from ``(k, 5)`` power sums.

    Centered moments are recovered about the shifted mean, so accumulating
    about a shift near the data keeps the 4th-moment cancellation at
    O(std⁴).  The multiply-adds round once, as the reference's fused XLA
    program rounds them.  An empty prefix has mean 0 (not the shift), and a
    single sample has zero centered moments exactly.
    """
    zf = torch.clamp(moments[:, 0], min=1.0)
    r1 = moments[:, 1] / zf
    r2 = moments[:, 2] / zf
    r3 = moments[:, 3] / zf
    r4 = moments[:, 4] / zf
    r1sq = r1 * r1
    m2 = torch.clamp(fma(-r1, r1, r2), min=0.0)
    m4 = fma(-(4.0 * r1), r3, r4)
    m4 = fma(6.0 * r1sq, r2, m4)
    m4 = torch.clamp(fma(torch.full_like(r1, -3.0), r1sq * r1sq, m4), min=0.0)
    zero = torch.zeros_like(m2)
    m2 = torch.where(zf <= 1.0, zero, m2)
    m4 = torch.where(zf <= 1.0, zero, m4)
    if shift is None:
        mean = r1
    else:
        mean = torch.where(moments[:, 0] < 1.0, zero, r1 + shift)
    return _select_value_sigma(mean, m2, m4, zf, z, n, agg_ids)
