"""AFC entry points, routed by device: the CUDA kernels or their plain versions.

Port of ``repro/kernels/sampled_agg/ops.py``: the parametric power sums
and the holistic (MEDIAN/QUANTILE) bootstrap.  A CUDA tensor goes to the
hand-written kernel, a CPU tensor to the plain PyTorch version.
``use_kernel=False`` runs the plain version on the card too; it exists so
that tests and ``chip_smoke.py`` can compare the two.  Nothing
falls back silently: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.data.aggregates import estimates_from_power_sums
from repro_torch.kernels.sampled_agg import prefix_stats
from repro_torch.kernels.sampled_agg.quantile_select import masked_select_ranks
from repro_torch.kernels.sampled_agg.ref import masked_select_ranks_ref, sampled_moments_ref
from repro_torch.kernels.sampled_agg.sampled_agg import sampled_moments
from repro_torch.numerics import fma, log, sqrt

__all__ = [
    "AFC_BACKENDS",
    "AFC_REF_MAX_CAP",
    "beta_order_stat",
    "bootstrap_rank_targets",
    "finish_quantile_estimates",
    "masked_estimates",
    "masked_quantile_estimates",
    "moments",
    "prefix_power_sums",
    "resolve_afc_plan",
    "select_ranks",
]

f32 = torch.float32

#: Cap bucket at or below which "auto" takes the rescan path.  The
#: reference's threshold, kept for plan parity; it was calibrated on the
#: reference's hardware and has not been re-measured on the H100.
AFC_REF_MAX_CAP = 1024

AFC_BACKENDS = ("auto", "incremental", "ref")


def resolve_afc_plan(afc_backend: str, cap: int | None = None) -> bool:
    """Whether the executor takes the incremental AFC path.

    ``"incremental"``: the once-per-request prefix tables
    (``prefix_power_sums``) and an O(1) gather per evaluation.  ``"ref"``:
    the rescan, one ``sampled_moments`` pass per evaluation, as in the
    reference.  ``"auto"``: rescan for cap buckets at or below
    :data:`AFC_REF_MAX_CAP`, incremental above (``cap=None`` validates the
    string only and answers incremental).  The backend picks the strategy
    only; which implementation runs follows the device.
    """
    if afc_backend not in AFC_BACKENDS:
        raise ValueError(f"unknown afc_backend {afc_backend!r}; choose from {AFC_BACKENDS}")
    if afc_backend == "auto":
        return cap is None or cap > AFC_REF_MAX_CAP
    return afc_backend == "incremental"


def prefix_power_sums(
    vals: torch.Tensor, shift: torch.Tensor | None = None, *, use_kernel: bool = True
) -> torch.Tensor:
    """(k, cap) -> (k, cap, 4) running prefix power sums of ``vals - shift``."""
    if use_kernel and vals.is_cuda:
        return prefix_stats.prefix_power_sums(vals, shift)
    return prefix_stats.prefix_power_sums_ref(vals, shift)


def moments(
    vals: torch.Tensor,
    z: torch.Tensor,
    shift: torch.Tensor | None = None,
    *,
    use_kernel: bool = True,
) -> torch.Tensor:
    """(k, cap), (k,) -> (k, 5) ``[count, s1, s2, s3, s4]`` of ``vals - shift``."""
    if use_kernel and vals.is_cuda:
        return sampled_moments(vals, z, shift)
    return sampled_moments_ref(vals, z, shift)


def masked_estimates(
    vals: torch.Tensor,
    z: torch.Tensor,
    n: torch.Tensor,
    agg_ids: torch.Tensor,
    *,
    use_kernel: bool = True,
):
    """Rescan AFC: one power-sum pass at plan z -> (value, sigma) per feature.

    Sums are taken about each feature's first buffered sample, so the
    4th-moment cancellation stays at O(std⁴) when |mean| >> std.
    """
    shift = vals[:, 0].contiguous()
    return estimates_from_power_sums(
        moments(vals, z, shift, use_kernel=use_kernel), z, n, agg_ids, shift
    )


def select_ranks(
    vals: torch.Tensor, z: torch.Tensor, targets: torch.Tensor, *, use_kernel: bool = True
) -> torch.Tensor:
    """(h, cap), (h,), (h, R) -> (h, R) order statistics of each z-prefix."""
    if use_kernel and vals.is_cuda:
        return masked_select_ranks(vals, z, targets)
    return masked_select_ranks_ref(vals, z, targets)


def _mt_keys(key, rounds: int) -> np.ndarray:
    """(2, rounds, 2): the normal keys, then the uniform keys, of each round.

    Round ``i`` of the reference draws from ``split(split(key, rounds)[i])``.
    """
    return np.stack([threefry.split(kk) for kk in threefry.split(key, rounds)], axis=1)


def _mt_draws(keys: np.ndarray, shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (normals, uniforms) of stacked round keys ``(2, ...)`` in one hash."""
    lead = keys.shape[1:-1]
    bits = threefry.random_bits(keys.reshape(-1, 2), shape, device=device)
    bits = bits.reshape((2,) + lead + tuple(shape))
    return threefry.bits_to_normal(bits[0]), threefry.bits_to_uniform(bits[1], 1e-38)


def _mt_select(d: torch.Tensor, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Marsaglia-Tsang Gamma(d + 1/3) from proposals ``x, u`` of shape (rounds, *d).

    The first accepted round wins; none accepted gives the mean.  All
    rounds are evaluated at once, then the first acceptance is selected,
    which is what the reference's sequential rounds compute.  The
    multiply-adds round once and ``log`` is XLA's own, as in the
    reference's fused program.  ``c = 1/√(9d)`` is correctly rounded; XLA's
    CPU backend takes it from the processor's reciprocal-square-root
    estimate and two Newton steps, which can differ in the last bit, and
    then, rarely, ``d·v`` or an acceptance differs too.
    """
    c = 1.0 / sqrt(9.0 * d)
    b = fma(c, x, 1.0)
    v = b * (b * b)
    pos = v > 0.0
    safe_v = torch.where(pos, v, torch.ones_like(v))
    rhs = fma(-d, safe_v, fma(0.5 * x, x, d))
    rhs = fma(d, log(safe_v), rhs)
    ok = pos & (log(u) < rhs)
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)  # first accepted round
    picked = torch.take_along_dim(d * safe_v, first, dim=0)[0]
    return torch.where(ok.any(dim=0), picked, d + float(np.float32(1.0 / 3.0)))


def _gamma_mt(key, d: torch.Tensor, rounds: int) -> torch.Tensor:
    """Gamma(a ≥ 1), ``d = a − 1/3``, in a fixed number of proposal rounds.

    Port of the reference's ``_gamma_mt``: round ``i`` draws its normal
    and its uniform (``minval=1e-38``) from ``split(split(key, rounds)[i])``.
    """
    x, u = _mt_draws(_mt_keys(key, rounds), d.shape, d.device)
    return _mt_select(d, x, u)


def beta_order_stat(key, a: torch.Tensor, b: torch.Tensor, shape, rounds: int = 4):
    """Beta(a, b) draws for a, b ≥ 1 as ``ga / (ga + gb)`` of two MT gammas.

    Both gammas' proposals come from one batched hash and are accepted in
    one pass; the bits are those of the reference's separate draws.
    """
    shape = tuple(shape)
    third = float(np.float32(1.0 / 3.0))
    d = torch.stack([torch.broadcast_to(a.to(f32), shape),
                     torch.broadcast_to(b.to(f32), shape)]) - third    # (2, *shape)
    ka, kb = threefry.split(key)
    keys = np.stack([_mt_keys(ka, rounds), _mt_keys(kb, rounds)], axis=2)  # (2, rounds, 2, 2)
    x, u = _mt_draws(keys, shape, d.device)                           # (rounds, 2, *shape)
    g = _mt_select(d, x, u)
    return g[0] / (g[0] + g[1])


def bootstrap_rank_targets(z: torch.Tensor, qs: torch.Tensor, key, n_boot: int) -> torch.Tensor:
    """(h, 1 + B) int32 rank targets: [point-estimate rank | bootstrap ranks].

    The point rank is ``floor(q·(z − 1) + 0.5)``; replicate ``b`` is the
    order statistic ``floor(z·V)``, ``V ~ Beta(rank + 1, z − rank)``: the
    (rank+1)-th smallest of z uniform index draws, i.e. the rank-r quantile
    of a size-z resample with replacement (paper appendix D).  Shared by
    the rescan and the incremental path, so both draw the same ranks.
    """
    h = z.shape[0]
    z = z.to(torch.int32)
    zf = z.to(f32)
    zm1 = torch.clamp(z - 1, min=0)
    rank = torch.floor(fma(qs.to(f32), zf - 1.0, 0.5)).to(torch.int32)
    rank = torch.minimum(torch.clamp(rank, min=0), zm1)
    a = (rank + 1).to(f32)
    b = torch.clamp(z - rank, min=1).to(f32)
    v = beta_order_stat(key, a[:, None], b[:, None], (h, n_boot))
    boot = torch.floor(zf[:, None] * v).to(torch.int32)
    boot = torch.minimum(torch.clamp(boot, min=0), zm1[:, None])
    return torch.cat([rank[:, None], boot], dim=1)


def finish_quantile_estimates(sel: torch.Tensor, z: torch.Tensor, n: torch.Tensor):
    """(value (h,), sorted replicates (h, B)) from selected (h, 1 + B) order stats.

    Empty prefix -> (0, zeros); exact (z ≥ n) -> a degenerate replicate
    table at the exact quantile; otherwise the point value and the sorted
    replicates.
    """
    empty = z <= 0
    value = torch.where(empty, torch.zeros_like(sel[:, 0]), sel[:, 0])
    reps = torch.sort(sel[:, 1:], dim=1).values
    reps = torch.where((z >= n)[:, None], value[:, None], reps)
    reps = torch.where(empty[:, None], torch.zeros_like(reps), reps)
    return value, reps


def masked_quantile_estimates(
    vals: torch.Tensor,
    z: torch.Tensor,
    n: torch.Tensor,
    qs: torch.Tensor,
    key,
    n_boot: int,
    *,
    use_kernel: bool = True,
):
    """Holistic rescan AFC: (value (h,), sorted replicates (h, B)) per feature.

    Draws the (h, 1 + B) rank targets and selects them all in one
    ``masked_select_ranks`` pass over the (h, cap) buffers.
    """
    targets = bootstrap_rank_targets(z, qs, key, n_boot)
    return finish_quantile_estimates(
        select_ranks(vals, z, targets, use_kernel=use_kernel), z, n
    )
