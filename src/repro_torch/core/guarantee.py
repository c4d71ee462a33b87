"""The accuracy guarantee check (paper Eq. 1): ``Pr(|Y − ŷ| ≤ δ) ≥ τ``.

Port of ``repro/core/guarantee.py``.  Regression: ``U_y ~ N(ȳ − ŷ, σ_y²)``,
so ``Pr = Φ((δ − (ȳ−ŷ)) / σ_y) − Φ((−δ − (ȳ−ŷ)) / σ_y)``.  Classification
(δ must be 0): ``Pr = p_ŷ``, the AMI rows' share of ŷ's class.

A degenerate ``σ_y ≤ 1e-12`` (all features exact, or the model flat in the
sampled region) means Y is deterministic at ȳ, and the probability is the
indicator ``|ȳ − ŷ| ≤ δ``.  The fused and the host-loop executor both take
the probability from :func:`guarantee_prob`, so there is one degenerate-σ
convention in the port.
"""
from __future__ import annotations

import torch

__all__ = ["classification_prob", "guarantee_prob", "regression_prob", "satisfied"]

f32 = torch.float32


def guarantee_prob(y_hat, mean, sd, delta):
    """Eq. 1 probability ``Pr(|Y − ŷ| ≤ δ)`` for ``Y ~ N(mean, sd²)``.

    Subnormal convention: the degenerate indicator is decided in float64
    from the float32 operands, so it is the answer of exact arithmetic and
    does not depend on whether a float32 path flushes subnormals to zero.
    A bias of ``1e-38`` (a float32 subnormal) is therefore NOT within
    ``δ = 0``: at ``ŷ = 0, mean = 1e-38, sd = 0, δ = 0`` the probability is
    0.  (The reference computes the bias in float32 on XLA, which may flush
    it to zero and answer 1.)
    """
    bias = mean - y_hat
    safe = torch.clamp(sd, min=1e-12)
    prob = torch.special.ndtr((delta - bias) / safe) - torch.special.ndtr(
        (-delta - bias) / safe
    )
    exact_bias = mean.to(torch.float64) - y_hat.to(torch.float64)
    within = (exact_bias.abs() <= delta.to(torch.float64)).to(f32)
    return torch.where(sd <= 1e-12, within, prob)


def regression_prob(u, delta) -> torch.Tensor:
    """``Pr(|Y − ŷ| ≤ δ)`` of an ``InferenceUncertainty`` (Normal model)."""
    delta = torch.as_tensor(delta, dtype=f32, device=u.mean.device)
    return guarantee_prob(u.y_hat, u.mean, u.std, delta)


def classification_prob(u) -> torch.Tensor:
    """``Pr(Y == ŷ) = p_ŷ`` of an ``InferenceUncertainty`` (Categorical model)."""
    return u.mean


def satisfied(u, delta, tau: float, task: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(prob, prob >= tau)`` for Eq. 1; ``task`` is "regression" or
    "classification".  The comparison is float32's, as in the reference."""
    if task == "regression":
        prob = regression_prob(u, delta)
    elif task == "classification":
        prob = classification_prob(u)
    else:
        raise ValueError(f"unknown task {task!r}")
    return prob, prob >= tau
