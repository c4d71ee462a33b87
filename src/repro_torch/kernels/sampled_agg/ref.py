"""Plain PyTorch version of the ``sampled_moments`` kernel.

Semantics (port of ``repro/kernels/sampled_agg/ref.py``): given k
prefix-masked sample buffers ``(k, cap)`` and live sample sizes ``z (k,)``,
the raw power sums ``[count, Σu, Σu², Σu³, Σu⁴]`` of ``u = v − shift`` over
each z-prefix, accumulated with the compensated pairwise sum.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sampled_agg.compensated import comp_sum

__all__ = ["sampled_moments_ref"]


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
