"""Approximate Model Inference (AMI): QMC uncertainty propagation (paper §3.3).

Port of ``repro/core/propagation.py``.  Given approximate features with
uncertainty ``U_x``, the distribution of the exact result ``Y`` is
estimated from ``m`` low-discrepancy feature samples run through the model
in one batch (the point estimate rides along as row ``m``): Normal(ȳ, σ_y²)
for regression, Categorical(p) for classification.  The model is a black
box ``(m, k) -> (m,)``.

On a CUDA device the Sobol points come from the ``sobol_points`` kernel.
Without a key (the fused executor) the uniforms are written by the kernel
in the same launch; with a key (the host-loop executor) the kernel's uint32
points are shifted by :func:`~repro_torch.core.qmc.digital_shift`, then
converted as the reference converts them.  The grid is built anew at every
call, one launch each.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.qmc import digital_shift
from repro_torch.core.uncertainty import FeatureUncertainty, sample_features
from repro_torch.kernels.sobol.ops import points, to_uniforms, uniforms

__all__ = [
    "InferenceUncertainty",
    "output_moments",
    "propagate_classification",
    "propagate_regression",
    "qmc_grid",
    "qmc_uniforms",
]

f32 = torch.float32


class InferenceUncertainty(NamedTuple):
    """Distribution of Y and of ``U_y = Y − ŷ`` (paper §3.3 steps 3-4)."""

    y_hat: torch.Tensor    # () M(x̂), the returned approximate result
    mean: torch.Tensor     # () ȳ (regression) or p_ŷ (classification)
    std: torch.Tensor      # () σ_y (regression; 0 for classification)
    probs: torch.Tensor    # (C,) class probabilities (classification; empty for regression)
    samples: torch.Tensor  # (m,) the y^i inference samples


def qmc_uniforms(m: int, dim: int, key=None, *, device,
                 use_kernel: bool = True) -> torch.Tensor:
    """(m, dim) f32 low-discrepancy uniforms ``(x + 0.5) / 2³²`` on ``device``,
    digitally shifted by ``key`` (a threefry key) when one is given."""
    if key is None:
        return uniforms(m, dim, 0, device=device, use_kernel=use_kernel)
    x = points(m, dim, 0, device=device, use_kernel=use_kernel)
    return to_uniforms(digital_shift(key, x))


def qmc_grid(m: int, m_sobol: int, k: int, *, device,
             use_kernel: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused executor's two grids, ``(qmc_uniforms(m, k),
    qmc_uniforms(m_sobol, 2k))``, as views of ONE (max(m, m_sobol), 2k) grid.

    A Sobol point's first k coordinates do not depend on the dimension
    count, so the (m, k) grid is the first k columns of the 2k-dimensional
    one; on the card the whole grid is one ``sobol_points`` launch.
    """
    u = qmc_uniforms(max(m, m_sobol), 2 * k, device=device, use_kernel=use_kernel)
    return u[:m, :k], u[:m_sobol]


def _ami_outputs(model_fn, unc: FeatureUncertainty, m: int, key, use_kernel: bool):
    """Model outputs of the m QMC rows and, as row m, of the point estimate."""
    u = qmc_uniforms(m, unc.k, key, device=unc.value.device, use_kernel=use_kernel)
    x_all = torch.cat([sample_features(unc, u), unc.value[None, :]], dim=0)
    return model_fn(x_all).reshape(m + 1)


def output_moments(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ȳ, σ_y)`` of the regression AMI outputs ``(..., m)``, one a lane: the
    mean and the population std around it; both executors reduce through it."""
    y_bar = y.mean(-1)
    return y_bar, torch.sqrt(((y - y_bar[..., None]) ** 2).mean(-1))


def propagate_regression(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    unc: FeatureUncertainty,
    m: int,
    key=None,
    *,
    use_kernel: bool = True,
) -> InferenceUncertainty:
    """Regression: ``Y ~ N(ȳ, σ_y²)``; σ_y is the population std around ȳ."""
    y_all = _ami_outputs(model_fn, unc, m, key, use_kernel).to(f32)
    y, y_hat = y_all[:m], y_all[m]
    y_bar, sigma = output_moments(y)
    return InferenceUncertainty(y_hat=y_hat, mean=y_bar, std=sigma,
                                probs=y.new_zeros((0,)), samples=y)


def propagate_classification(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    unc: FeatureUncertainty,
    m: int,
    n_classes: int,
    key=None,
    *,
    use_kernel: bool = True,
) -> InferenceUncertainty:
    """Classification: ``Y ~ Categorical(p)``; ``U_y ~ Bernoulli(1 − p_ŷ)``.

    ``model_fn`` returns hard class ids ``0 .. n_classes − 1``.
    """
    y_all = _ami_outputs(model_fn, unc, m, key, use_kernel).to(torch.int64)
    y, y_hat = y_all[:m], y_all[m]
    probs = torch.bincount(y, minlength=n_classes)[:n_classes].to(f32) / m
    return InferenceUncertainty(
        y_hat=y_hat.to(f32), mean=probs[y_hat], std=probs.new_zeros(()),
        probs=probs, samples=y.to(f32),
    )
