"""The plain reference: Biathlon's per-request loop, written out in plain PyTorch.

It imports nothing of the port and takes nothing the port made: it reads
the deployment (``data.py``: rows, sample order, forest, scaler), the
knobs and the paper's section-4 constants, and works out the rest again
(the Sobol grid from ``torch.quasirandom.SobolEngine``, its normal
quantiles, every estimate).  One request is one serving group:

* AFC: each feature's estimate on the first ``z_j`` rows of its group's
  sample order, with the CLT error of the paper's section 3.2 (finite
  population correction; the delta method for VAR and STD); ``σ = 0`` once
  ``z_j = N_j``.
* AMI: the forest on ``value + σ·Φ⁻¹(u)`` at the ``m`` QMC uniforms
  ``(x + 0.5)·2⁻³²`` of the first ``k`` Sobol dimensions (clamped to
  ``[1e-7, 1 − 1e-7]``), and on ``value`` itself for ŷ.  Regression:
  Eq. 1, ``Φ((δ − b)/σ_y) − Φ((−δ − b)/σ_y)`` with ``b = ȳ − ŷ``;
  classification: the share of the rows voting ŷ's class.
* Planner: ``z⁰ = ceil(α·N)`` (at least ``min(2, N)``), a step of
  ``ceil(γ·ΣN)`` rows along the feature with the largest Saltelli main
  effect per remaining row (the ``m_sobol`` A / B rows of Sobol dimensions
  ``k+1..2k``), until the guarantee holds, the groups are exhausted or
  ``max_iters`` steps were taken.

``dtype`` is float64 for the reference and bfloat16 for the control (the
step below the configuration's float32); the integer plan arithmetic is
exact in both, and the last scalar formula of Eq. 1 is taken in float64
from the ``dtype`` moments.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Answer", "Reference"]


class Answer(NamedTuple):
    """One request's result: the estimate, its guarantee, the final plan."""

    y_hat: float
    prob: float
    z: tuple
    iters: int


def _ceil_frac(frac: Fraction, n: int) -> int:
    """``ceil(frac·n)`` in exact arithmetic."""
    return -((-frac.numerator * n) // frac.denominator)


class Reference:
    """The loop for every serving group of a deployment, on ``device``."""

    def __init__(self, dep, *, delta: float, tau: float, dtype=torch.float64, device="cpu"):
        b = dep.config["biathlon"]
        self.dep, self.delta, self.tau, self.dtype = dep, float(delta), float(tau), dtype
        self.device = torch.device(device)
        self.k, self.m, self.m_sobol = dep.k, int(b["m"]), int(b["m_sobol"])
        self.alpha, self.gamma = Fraction(str(b["alpha"])), Fraction(str(b["gamma"]))
        self.max_iters = int(b["max_iters"])
        self.classify = dep.task == "classification"
        k, dev = self.k, self.device
        x = torch.quasirandom.SobolEngine(2 * k, scramble=False).draw(
            max(self.m, self.m_sobol), dtype=torch.float64)
        u = torch.clamp(x + 0.5 * 2.0**-32, 1e-7, 1 - 1e-7)
        g = torch.special.ndtri(u).to(dev)
        self.g_ami = g[: self.m, :k].to(dtype)
        self.g_a = g[: self.m_sobol, :k].to(dtype)
        self.g_b = g[: self.m_sobol, k:].to(dtype)
        f = dep.forest
        self.feature = torch.from_numpy(f["feature"].astype(np.int64)).to(dev)
        self.left = torch.from_numpy(f["left"].astype(np.int64)).to(dev)
        self.right = torch.from_numpy(f["right"].astype(np.int64)).to(dev)
        self.threshold = torch.from_numpy(f["threshold"].astype(np.float64)).to(dev, dtype)
        self.value = torch.from_numpy(f["value"].astype(np.float64)).to(dev, dtype)
        self.base = torch.tensor(dep.base, dtype=torch.float64).to(dev, dtype)
        self.s_mean = torch.from_numpy(dep.scaler_mean.astype(np.float64)).to(dev, dtype)
        self.s_scale = torch.from_numpy(dep.scaler_scale.astype(np.float64)).to(dev, dtype)

    # ------------------------------------------------------------- stages
    def rows_of(self, g: int) -> list[torch.Tensor]:
        """Each feature's rows of group ``g`` in its sample order."""
        return [torch.from_numpy(self.dep.prefix(c, g, int(self.dep.sizes[g])).astype(np.float64))
                .to(self.device, self.dtype) for _op, c in self.dep.aggs]

    def afc(self, rows, z, n) -> tuple[torch.Tensor, torch.Tensor]:
        """(value, σ) of every feature at plan ``z``."""
        vals, sigs = [], []
        for (op, _c), x, zj, nj in zip(self.dep.aggs, rows, z, n):
            v, s = _estimate(op, x[:zj], zj, nj)
            vals.append(v)
            sigs.append(s)
        return torch.stack(vals), torch.stack(sigs)

    def model(self, rows: torch.Tensor) -> torch.Tensor:
        """The forest on ``(r, k)`` rows: values, or class ids 0 / 1."""
        x = (rows - self.s_mean) / self.s_scale
        r = x.shape[0]
        idx = torch.zeros((self.feature.shape[0], r), dtype=torch.int64, device=self.device)
        cols = torch.arange(r, device=self.device)[None, :]
        for _ in range(self.dep.depth):
            f = torch.gather(self.feature, 1, idx)
            go_left = x[cols, f] <= torch.gather(self.threshold, 1, idx)
            idx = torch.where(go_left, torch.gather(self.left, 1, idx),
                              torch.gather(self.right, 1, idx))
        raw = self.base + torch.gather(self.value, 1, idx).sum(0) / self.feature.shape[0]
        return (raw > 0.5).to(self.dtype) if self.classify else raw

    def ami(self, value, sigma) -> tuple[float, float]:
        """(ŷ, the guarantee probability) at one plan's estimates."""
        y = self.model(value[None, :] + sigma[None, :] * self.g_ami)
        y_hat = self.model(value[None, :])[0]
        if self.classify:
            return float(y_hat), float((y == y_hat).to(torch.float64).mean())
        y_bar = y.mean()
        sd = float(torch.sqrt(((y - y_bar) ** 2).mean()))
        yh, bias = float(y_hat), float(y_bar) - float(y_hat)
        if sd <= 1e-12:
            return yh, float(abs(bias) <= self.delta)
        phi = lambda t: 0.5 * math.erfc(-t / math.sqrt(2.0))  # noqa: E731
        return yh, phi((self.delta - bias) / sd) - phi((-self.delta - bias) / sd)

    def indices(self, value, sigma, y_hat: float) -> torch.Tensor:
        """Saltelli main-effect indices ``(k,)`` at one plan's estimates."""
        xa = value[None, :] + sigma[None, :] * self.g_a
        xb = value[None, :] + sigma[None, :] * self.g_b
        eye = torch.eye(self.k, dtype=torch.bool, device=self.device)
        xab = torch.where(eye[:, None, :], xb[None], xa[None]).reshape(-1, self.k)
        f = self.model(torch.cat([xa, xb, xab]))
        if self.classify:
            f = (f == y_hat).to(self.dtype)
        f = f - f.mean()
        ms = self.m_sobol
        fa, fb, fab = f[:ms], f[ms : 2 * ms], f[2 * ms :].reshape(self.k, ms)
        var = (f * f).mean()
        if float(var) <= 1e-12:
            return torch.zeros(self.k, dtype=self.dtype, device=self.device)
        return torch.clamp((fb[None, :] * (fab - fa[None, :])).mean(1) / var, 0.0, 1.0)

    # --------------------------------------------------------------- loop
    def serve(self, g: int) -> Answer:
        """The whole loop for group ``g``."""
        rows = self.rows_of(g)
        n = [int(self.dep.sizes[g])] * self.k
        z = [min(max(_ceil_frac(self.alpha, nj), min(2, nj)), nj) for nj in n]
        step = max(_ceil_frac(self.gamma, sum(n)), 1)
        value, sigma = self.afc(rows, z, n)
        y_hat, prob = self.ami(value, sigma)
        it = 0

        def want() -> bool:
            return prob < self.tau and it < self.max_iters and any(a < b for a, b in zip(z, n))

        if not want():
            return Answer(y_hat, prob, tuple(z), it)
        idx = self.indices(value, sigma, y_hat)
        while True:
            remaining = [b - a for a, b in zip(z, n)]
            score = [float(idx[j]) / max(r, 1) if r > 0 else -math.inf
                     for j, r in enumerate(remaining)]
            j = max(range(self.k), key=lambda i: (score[i], -i))
            z = [min(a + step, b) if i == j else a for i, (a, b) in enumerate(zip(z, n))]
            it += 1
            value, sigma = self.afc(rows, z, n)
            y_hat, prob = self.ami(value, sigma)
            if not want():
                return Answer(y_hat, prob, tuple(z), it)
            idx = self.indices(value, sigma, y_hat)

    def at_plan(self, g: int, z) -> tuple[float, float]:
        """(ŷ, probability) of group ``g`` at a given plan ``z``."""
        rows = self.rows_of(g)
        n = [int(self.dep.sizes[g])] * self.k
        value, sigma = self.afc(rows, [int(a) for a in z], n)
        return self.ami(value, sigma)


def _estimate(op: str, x: torch.Tensor, z: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One parametric aggregate and its error σ from the ``z`` sampled rows
    of a group of ``n`` (central moments in one pass over ``x``)."""
    mean = x.mean()
    d = x - mean
    m2, m4 = (d * d).mean(), (d * d * d * d).mean()
    zf, nf = float(z), float(n)
    s2 = m2 * zf / max(zf - 1.0, 1.0)
    fpc = math.sqrt(min(max((nf - zf) / max(nf - 1.0, 1.0), 0.0), 1.0))
    var_s2 = torch.clamp((m4 - m2 * m2 * (zf - 3.0) / max(zf - 1.0, 1.0)) / zf, min=0.0)
    if op == "avg":
        value, sigma = mean, torch.sqrt(s2 / zf) * fpc
    elif op in ("sum", "count"):
        value, sigma = nf * mean, nf * torch.sqrt(s2 / zf) * fpc
    elif op == "var":
        value, sigma = s2, torch.sqrt(var_s2) * fpc
    elif op == "std":
        value = torch.sqrt(s2)
        sigma = torch.sqrt(var_s2 / torch.clamp(4.0 * s2, min=1e-12)) * fpc
    else:
        raise ValueError(f"no reference for aggregate {op!r}")
    if z >= n:
        sigma = torch.zeros_like(sigma)
    return value, sigma
