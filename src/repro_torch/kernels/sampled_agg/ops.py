"""AFC entry points, routed by device: the CUDA kernels or their plain versions.

Port of ``repro/kernels/sampled_agg/ops.py`` (parametric part).  A CUDA
tensor goes to the hand-written kernel, a CPU tensor to the plain PyTorch
version.  ``use_kernel=False`` runs the plain version on the card too; it
exists so that tests and ``chip_smoke.py`` can compare the two.  Nothing
falls back silently: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.data.aggregates import estimates_from_power_sums
from repro_torch.kernels.sampled_agg import prefix_stats
from repro_torch.kernels.sampled_agg.ref import sampled_moments_ref
from repro_torch.kernels.sampled_agg.sampled_agg import sampled_moments

__all__ = [
    "AFC_BACKENDS",
    "AFC_REF_MAX_CAP",
    "masked_estimates",
    "moments",
    "prefix_power_sums",
    "resolve_afc_plan",
]

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
