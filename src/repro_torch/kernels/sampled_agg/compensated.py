"""Compensated float32 accumulation for the power-sum AFC paths.

Port of ``repro/kernels/sampled_agg/compensated.py``.  Σv⁴ over a 60k-row
heavy-tailed group loses 3-4 significant digits under a plain float32 sum,
which surfaces as a wrong VAR/STD σ and so a wrong Eq. 1 guarantee.  Every
accumulation here therefore carries an unevaluated (hi, lo) float32 pair
built from error-free transformations (Knuth two-sum), whose sum tracks the
exact result to ~2⁻⁴⁸ relative.  PyTorch runs each operation below as its
own kernel, so nothing reassociates or contracts the named intermediates;
the CUDA kernels pin the same arithmetic with ``__fadd_rn`` / ``__fsub_rn``
(``csrc/compensated.cuh``).

* :func:`comp_cumsum` — inclusive prefix sums by a log-step (Hillis-Steele)
  scan with the two-sum combine: O(log n) depth, error O(ε·log n).
* :func:`comp_sum` — the total, by a pairwise halving fold.
* :func:`two_sum` / :func:`kahan_step` — the primitives.
"""
from __future__ import annotations

import torch

__all__ = ["two_sum", "kahan_step", "comp_cumsum", "comp_sum"]


def two_sum(a: torch.Tensor, b: torch.Tensor):
    """Knuth error-free addition: ``(s, e)`` with s = fl(a+b), s+e = a+b."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def kahan_step(hi: torch.Tensor, lo: torch.Tensor, x: torch.Tensor):
    """One compensated step ``(hi, lo) += x``; the error goes to ``lo``."""
    s, e = two_sum(hi, x)
    return s, lo + e


def _comp_combine(a_hi, a_lo, b_hi, b_lo):
    """Associative combine of (hi, lo) pairs, ``a`` preceding ``b``."""
    s, e = two_sum(a_hi, b_hi)
    return s, (a_lo + b_lo) + e


def comp_cumsum(x: torch.Tensor, dim: int = -1, collapse: bool = True):
    """Compensated inclusive prefix sums of ``x`` along ``dim`` (float32).

    Returns ``hi + lo`` (default) or the raw ``(hi, lo)`` pair.
    """
    x = x.to(torch.float32)
    hi = x.movedim(dim, -1)
    lo = torch.zeros_like(hi)
    n = hi.shape[-1]
    s = 1
    while s < n:
        h, lw = _comp_combine(hi[..., :-s], lo[..., :-s], hi[..., s:], lo[..., s:])
        hi = torch.cat([hi[..., :s], h], dim=-1)
        lo = torch.cat([lo[..., :s], lw], dim=-1)
        s *= 2
    hi, lo = hi.movedim(-1, dim), lo.movedim(-1, dim)
    return hi + lo if collapse else (hi, lo)


def comp_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Compensated total along ``dim``: two-sum pairwise tree, O(ε·log n)."""
    hi = x.to(torch.float32).movedim(dim, -1)
    lo = torch.zeros_like(hi)
    while hi.shape[-1] > 1:
        if hi.shape[-1] % 2:
            hi = torch.nn.functional.pad(hi, (0, 1))
            lo = torch.nn.functional.pad(lo, (0, 1))
        hi, lo = _comp_combine(
            hi[..., 0::2], lo[..., 0::2], hi[..., 1::2], lo[..., 1::2]
        )
    return hi[..., 0] + lo[..., 0]
