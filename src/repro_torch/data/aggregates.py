"""Online-aggregation estimators with uncertainty (paper §3.2, AFC).

Port of ``repro/data/aggregates.py``.  Every estimator reads a
fixed-capacity prefix buffer: the first ``z`` entries of ``vals (cap,)`` are
a simple random sample without replacement of a group of ``n`` rows.

* Parametric aggregates (SUM / COUNT / AVG / VAR / STD) get a Normal error σ
  from the CLT with the finite-population correction: :func:`estimate` per
  feature, :func:`masked_estimates_batch` for k features in one pass (the
  host-loop executor's AFC), :func:`estimates_from_power_sums` from the
  ``(k, 5)`` power sums of the fused executor's kernels.
* Holistic aggregates (MEDIAN / QUANTILE) get a sorted bootstrap-replicate
  table (paper appendix D): :func:`estimate` resamples the prefix with
  threefry uniforms (``core/threefry.py``, bit-exact with ``jax.random``)
  and selects each replicate's order statistic through
  ``ops.select_ranks``, the ``masked_select_ranks`` kernel on the card.  In
  the fused executor their slots are overwritten by the bootstrap path of
  ``kernels/sampled_agg/ops.py``.

``z`` and ``n`` of :func:`estimate` are host integers; buffers and results
are tensors on the buffer's device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import threefry
from repro_torch.numerics import fma

__all__ = [
    "AGG_IDS",
    "AGG_IDS_FULL",
    "AggResult",
    "HOLISTIC_AGGS",
    "PARAMETRIC_AGGS",
    "estimate",
    "estimates_from_power_sums",
    "exact_value",
    "masked_estimates_batch",
]

f32 = torch.float32

PARAMETRIC_AGGS = ("sum", "count", "avg", "var", "std")
HOLISTIC_AGGS = ("median", "quantile")
AGG_IDS = {"avg": 0, "sum": 1, "count": 2, "var": 3, "std": 4}
AGG_IDS_FULL = {**AGG_IDS, "median": 5, "quantile": 6}


class AggResult(NamedTuple):
    value: torch.Tensor         # () point estimate
    sigma: torch.Tensor         # () Normal error stddev (0 for holistic or exact)
    replicates: torch.Tensor    # (B,) sorted bootstrap replicates (value-filled if parametric)
    is_empirical: bool


def _quantile_rank(z: torch.Tensor, q: float) -> torch.Tensor:
    """Nearest rank ``floor(q·(z − 1) + 0.5)`` clipped to ``[0, max(z − 1, 0)]``,
    the multiply-add rounded once (the reference's program contracts it)."""
    zf = z.to(f32)
    rank = torch.floor(fma(torch.full_like(zf, q), zf - 1.0, 0.5)).to(torch.int32)
    return torch.minimum(torch.clamp(rank, min=0), torch.clamp(z - 1, min=0))


def _masked_quantile(vals: torch.Tensor, z: torch.Tensor, q: float, *,
                     use_kernel: bool = True) -> torch.Tensor:
    """(R,) nearest-rank q-quantile of the z-prefix of each row of ``vals (R,
    cap)``; ``z`` is a 0-d int tensor.  An empty prefix gives 0.0.

    One ``ops.select_ranks`` call with a single target a row: on the card
    the ``masked_select_ranks`` kernel, elsewhere its plain version (the
    reference's sort with +inf padding and gather).
    """
    from repro_torch.kernels.sampled_agg.ops import select_ranks  # ops imports this module

    r = vals.shape[0]
    z = z.to(torch.int32)
    targets = _quantile_rank(z, q).expand(r, 1)
    sel = select_ranks(vals, z.expand(r), targets, use_kernel=use_kernel)[:, 0]
    return torch.where(z > 0, sel, torch.zeros_like(sel))


def _bootstrap_replicates(vals: torch.Tensor, z: torch.Tensor, q: float, key, n_boot: int,
                          *, use_kernel: bool = True) -> torch.Tensor:
    """(B,) sorted bootstrap replicate quantiles: B resamples with replacement
    of the z-prefix of ``vals (cap,)``, each drawn as ``floor(u·z)`` from
    ``threefry.uniform(key, (B, cap))``.

    No index leaves the buffer: the largest uniform is ``1 − 2⁻²³``, and for
    ``1 ≤ z ≤ cap`` the float32 product ``u·z`` then rounds to at most the
    float below z, so ``floor`` gives at most ``z − 1``; ``z = 0`` gives 0.
    """
    cap = vals.shape[0]
    u = threefry.uniform(key, (n_boot, cap), device=vals.device)
    idx = torch.floor(u * z.to(f32)).to(torch.int64)
    reps = _masked_quantile(vals[idx], z, q, use_kernel=use_kernel)
    return torch.sort(reps).values


def estimate(
    agg: str,
    vals: torch.Tensor,
    z: int,
    n: int,
    key,
    *,
    n_boot: int = 256,
    quantile: float = 0.5,
    use_kernel: bool = True,
) -> AggResult:
    """Estimate aggregate ``agg`` of a group of ``n`` rows from its z-prefix.

    ``vals`` is the ``(cap,)`` float32 buffer on the device, ``z ≤ cap``;
    ``key`` a threefry key (holistic aggregates only).  At ``z ≥ n`` the
    result is exact: σ = 0, replicates all equal to the value.  There the
    reference draws a bootstrap and replaces every replicate with the
    value; the port skips the draw, which gives the same replicates.
    """
    z, n = min(int(z), int(n)), int(n)
    if z > vals.shape[0]:
        raise ValueError(f"z = {z} exceeds the buffer's {vals.shape[0]} values")
    dev = vals.device
    zt = torch.full((), z, dtype=torch.int32, device=dev)
    nt = torch.full((), n, dtype=torch.int32, device=dev)
    if agg in HOLISTIC_AGGS:
        q = 0.5 if agg == "median" else quantile
        value = _masked_quantile(vals[None], zt, q, use_kernel=use_kernel)[0]
        if z >= n:
            reps = value.expand(n_boot)
        else:
            reps = _bootstrap_replicates(vals, zt, q, key, n_boot, use_kernel=use_kernel)
        return AggResult(value=value, sigma=torch.zeros((), dtype=f32, device=dev),
                         replicates=reps, is_empirical=True)
    if agg not in PARAMETRIC_AGGS:
        raise ValueError(f"unsupported aggregate {agg!r}")
    # the reference's per-aggregate formulas are masked_estimates_batch's on one
    # row (its FPC takes max(z, 1) where the reference takes z: at z = 0 the σ
    # it scales is 0 either way)
    value, sigma = masked_estimates_batch(
        vals[None], zt[None], nt[None],
        torch.full((1,), AGG_IDS[agg], dtype=torch.int32, device=dev))
    return AggResult(value=value[0], sigma=sigma[0], replicates=value.expand(n_boot),
                     is_empirical=False)


def exact_value(agg: str, vals: torch.Tensor, n: int, *, quantile: float = 0.5,
                use_kernel: bool = True) -> torch.Tensor:
    """Exact aggregate over the full group (the baseline path)."""
    return estimate(agg, vals, n, n, threefry.PRNGKey(0), n_boot=8, quantile=quantile,
                    use_kernel=use_kernel).value


def masked_estimates_batch(vals, z, n, agg_ids):
    """(value, sigma) of k parametric features from their ``(k, cap)`` buffers;
    ``z``, ``n``, ``agg_ids`` (k,) int tensors (``agg_ids`` per :data:`AGG_IDS`).

    Two passes over each z-prefix: the mean, then the centred powers
    (``d⁴`` as ``(d²)²``, as XLA's ``integer_pow``).
    """
    mask = (torch.arange(vals.shape[-1], device=vals.device) < z[:, None]).to(f32)
    zf = torch.clamp(z.to(f32), min=1.0)
    mean = (vals * mask).sum(-1) / zf
    d = (vals - mean[:, None]) * mask
    d2 = d * d
    return _select_value_sigma(mean, d2.sum(-1) / zf, (d2 * d2).sum(-1) / zf, zf, z, n,
                               agg_ids)


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
