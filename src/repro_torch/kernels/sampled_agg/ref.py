"""Plain PyTorch versions of the ``sampled_moments`` and ``masked_select_ranks`` kernels.

Semantics (port of ``repro/kernels/sampled_agg/ref.py``): given k
prefix-masked sample buffers ``(k, cap)`` and live sample sizes ``z (k,)``,
:func:`sampled_moments_ref` takes the raw power sums ``[count, Σu, Σu²,
Σu³, Σu⁴]`` of ``u = v − shift`` over each z-prefix, accumulated with the
compensated pairwise sum; :func:`masked_select_ranks_ref` selects order
statistics of each z-prefix at given ranks.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sampled_agg.compensated import comp_sum

__all__ = ["masked_select_ranks_ref", "sampled_moments_ref"]


def sampled_moments_ref(
    vals: torch.Tensor, z: torch.Tensor, shift: torch.Tensor | None = None
) -> torch.Tensor:
    """vals (k, cap) f32, z (k,) int -> (k, 5) [count, s1, s2, s3, s4]."""
    _, cap = vals.shape
    cols = torch.arange(cap, device=vals.device)
    mask = (cols[None, :] < z[:, None]).to(torch.float32)
    v = vals.to(torch.float32)
    if shift is not None:
        v = v - shift.to(torch.float32)[:, None]
    v = v * mask
    count = mask.sum(dim=1)
    v2 = v * v
    return torch.stack(
        [count, comp_sum(v, 1), comp_sum(v2, 1), comp_sum(v2 * v, 1), comp_sum(v2 * v2, 1)],
        dim=1,
    )


def masked_select_ranks_ref(
    vals: torch.Tensor, z: torch.Tensor, targets: torch.Tensor
) -> torch.Tensor:
    """vals (k, cap) f32, z (k,) int, targets (k, R) int -> (k, R) f32.

    Values past z become +inf; a stable sort, then a gather at targets
    clipped to ``[0, cap − 1]``: a target at or past z selects +inf.
    """
    _, cap = vals.shape
    cols = torch.arange(cap, device=vals.device)
    padded = torch.where(cols[None, :] < z[:, None], vals.to(torch.float32), torch.inf)
    s = torch.sort(padded, dim=1, stable=True).values
    return torch.take_along_dim(s, torch.clamp(targets.to(torch.int64), 0, cap - 1), dim=1)
