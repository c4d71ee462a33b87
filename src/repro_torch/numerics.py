"""Float32 arithmetic helpers shared by the port's plain tensor code."""
from __future__ import annotations

import torch

__all__ = ["fma"]


def fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """Float32 ``a·b + c`` rounded once, as a fused multiply-add rounds.

    The reference's XLA programs contract ``a * b + c`` (and ``c - a * b``)
    into one FMA.  The product of two float32 values is exact in float64,
    so one float64 add and one rounding to float32 give the same result
    (up to a double rounding in ~2⁻²⁹ of cases).  Used where the port must
    round as the reference does for its z-plans to match.
    """
    return (a.to(torch.float64) * b.to(torch.float64) + c).to(torch.float32)
