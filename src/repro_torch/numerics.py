"""Float32 arithmetic helpers shared by the port's plain tensor code.

The reference's random draws and estimators run as XLA programs, and the
port reproduces their float32 roundings where its z-plans depend on them:

* :func:`fma` — XLA contracts ``a·b + c`` into one fused multiply-add;
* :func:`sqrt` — correctly rounded (PyTorch's vectorised CPU float32
  ``sqrt`` is not, on every input);
* :func:`log` / :func:`log1p` — the float32 polynomials XLA's CPU backend
  emits (the Cephes ``logf`` reduction and Cephes' rational ``log1p`` for
  small arguments), with their multiply-adds contracted as its compiler
  contracts them and denormal inputs flushed to zero, so the bootstrap's
  normals and Gamma acceptance tests round as the reference's do.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fma", "log", "log1p", "sqrt"]

f32 = torch.float32


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """Float32 ``a·b + c`` rounded once, as a fused multiply-add rounds.

    The reference's XLA programs contract ``a * b + c`` (and ``c - a * b``)
    into one FMA.  The product of two float32 values is exact in float64,
    so one float64 add and one rounding to float32 give the same result
    (up to a double rounding in ~2⁻²⁹ of cases).  Used where the port must
    round as the reference does for its z-plans to match.
    """
    a = a.to(torch.float64)  # float32 operands promote to float64 inside the ops
    if torch.is_tensor(b) and torch.is_tensor(c):
        return torch.addcmul(c, a, b).to(f32)
    return (a * b + c).to(f32)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (float64 root, one rounding)."""
    return torch.sqrt(x.to(torch.float64)).to(f32)


def _c(x: float) -> float:
    return float(np.float32(x))


# Cephes logf: log(1 + x) ≈ x − x²/2 + x³·P(x) on x ∈ [√½ − 1, √2 − 1)
_LOG_P = [_c(v) for v in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
_LOG_Q1, _LOG_Q2 = _c(-2.12194440e-4), 0.693359375   # ln 2 = Q2 − Q1, split
_SQRT_HALF = _c(0.707106781186547524)
_TINY = float(np.finfo(np.float32).tiny)


def log(x: torch.Tensor) -> torch.Tensor:
    """Float32 natural log as XLA's CPU backend computes it.

    ``x = m·2^e`` with ``m ∈ [√½, √2)``; the polynomial in ``m − 1`` is
    evaluated as three interleaved Horner chains joined in ``x³``, each step
    one FMA.  Denormals count as 0 (−inf), negatives give NaN.
    """
    x = x.to(f32)
    bits = torch.clamp(x, min=_TINY).view(torch.int32)
    e = ((bits >> 23) - 127).to(f32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(f32)          # in [0.5, 1)
    low = m < _SQRT_HALF
    u = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))  # 2m − 1 or m − 1
    e = e - low.to(f32)
    u2 = u * u
    u3 = u2 * u
    p = _LOG_P
    y0 = fma(fma(u, p[0], p[1]), u, p[2])
    y1 = fma(fma(u, p[3], p[4]), u, p[5])
    y2 = fma(fma(u, p[6], p[7]), u, p[8])
    y = fma(u3, fma(u3, fma(u3, y0, y1), y2), e * _LOG_Q1)
    r = fma(e, _LOG_Q2, fma(u2, -0.5, u) + y)
    r = torch.where(x < _TINY, torch.full_like(r, -math.inf), r)
    r = torch.where(x < 0, torch.full_like(r, math.nan), r)
    return torch.where(x == math.inf, x, r)


# Cephes log1p for |x| < √2 − 1: x − x²/2 + x³·N(x)/D(x)
_LOG1P_N = [_c(v) for v in (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                            6.5787325942061044846969e0, 2.9911919328553073277375e1,
                            6.0949667980987787057556e1, 5.7112963590585538103336e1,
                            2.0039553499201281259648e1)]
_LOG1P_D = [_c(v) for v in (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
                            2.2176239823732856465394e2, 3.0909872225312059774938e2,
                            2.1642788614495947685003e2, 6.0118660497603843919306e1)]


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    y = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        y = fma(y, x, c)
    return y


def log1p(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``log(1 + x)`` as XLA's CPU backend computes it.

    :func:`log` of ``1 + x`` where ``|x| ≥ √2 − 1``, Cephes' rational form
    below that.  A denormal ``x`` counts as a zero of its sign.
    """
    x = x.to(f32)
    x = torch.where(x.abs() < _TINY, x * 0.0, x)
    x2 = x * x
    small = x + fma(x2, -0.5, (x * x2) * (_horner(_LOG1P_N, x) / _horner(_LOG1P_D, x)))
    return torch.where(x.abs() < _c(0.41421356237309504880), small, log(x + 1.0))
