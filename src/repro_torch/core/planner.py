"""The Biathlon Planner (paper §3.4): approximation plans and step directions.

Port of ``repro/core/planner.py``.  A plan ``z`` is a (k,) int32 vector of
per-feature sample sizes; each iteration moves ``z`` by ``γ`` along the
feature with the largest Sobol main effect per remaining record.  Every
function also takes a batch of lanes, ``(L, k)`` plans with ``(L,)``
steps, each lane planned on its own (the batched fused executor).
"""
from __future__ import annotations

import math

import torch

__all__ = ["direction", "gamma_abs", "initial_plan", "next_plan"]


def gamma_abs(n: torch.Tensor, gamma_frac: float) -> torch.Tensor:
    """Paper default step: γ = gamma_frac · Σ_j N_j (at least 1), int32, one a lane."""
    total = n.sum(-1).to(torch.float32)
    return torch.clamp(torch.ceil(gamma_frac * total).to(torch.int32), min=1)


def initial_plan(n: torch.Tensor, alpha: float, min_samples: int = 2) -> torch.Tensor:
    """z⁰ = ceil(α·N), clipped to [min(min_samples, N), N]."""
    z0 = torch.ceil(alpha * n.to(torch.float32)).to(torch.int32)
    return torch.minimum(torch.maximum(z0, torch.clamp(n, max=min_samples)), n)


def direction(indices: torch.Tensor, z: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """One-hot (..., k) int32 direction: argmax of I_j / (N_j − z_j), first on ties.

    Exhausted features score −inf; a lane whose features are all exhausted
    gets the direction 0 (and only that lane).
    """
    remaining = (n - z).to(torch.float32)
    score = torch.where(
        remaining > 0,
        indices / torch.clamp(remaining, min=1.0),
        torch.full_like(remaining, -math.inf),
    )
    pick = torch.argmax(score, dim=-1, keepdim=True)
    d = (torch.arange(z.shape[-1], device=z.device) == pick).to(z.dtype)
    return torch.where((remaining <= 0).all(-1, keepdim=True), torch.zeros_like(d), d)


def next_plan(z: torch.Tensor, d: torch.Tensor, step: torch.Tensor, n: torch.Tensor):
    """z^{i+1} = min(z + step·d, N); ``step`` is one a lane."""
    return torch.minimum(z + d * step.to(z.dtype)[..., None], n)
