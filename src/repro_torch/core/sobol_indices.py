"""First-order Sobol' main-effect indices, Saltelli QMC estimator (paper §3.4).

Port of ``repro/core/sobol_indices.py``.  Two (m, k) QMC sample matrices
A and B and the k hybrids AB_j (A with column j from B) go through the model
in ONE call of ``(k + 2)·m`` rows; with ``f`` centred,

    V_j    = 1/m Σ_i f(B)_i · (f(AB_j)_i − f(A)_i)
    Var(Y) = population variance of f over all evaluations,

and ``I_j = clip(V_j / Var(Y), 0, 1)`` (all zeros when Var(Y) ≈ 0).  For
classification ``f`` is the agreement indicator ``1[M(x) == ŷ]``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.propagation import qmc_uniforms
from repro_torch.core.uncertainty import FeatureUncertainty, sample_features

__all__ = ["SobolEstimate", "indices_from_outputs", "main_effect_indices"]

f32 = torch.float32


class SobolEstimate(NamedTuple):
    indices: torch.Tensor  # (k,) first-order main-effect indices in [0, 1]
    var_y: torch.Tensor    # () total variance of f over all evaluations
    n_evals: int           # m·(k + 2)


def _build_eval_matrix(unc: FeatureUncertainty, m: int, key, use_kernel: bool) -> torch.Tensor:
    """``[A; B; AB_1; ...; AB_k]`` feature samples: ((k+2)·m, k)."""
    k = unc.k
    u = qmc_uniforms(m, 2 * k, key, device=unc.value.device, use_kernel=use_kernel)
    xa = sample_features(unc, u[:, :k])
    xb = sample_features(unc, u[:, k:])
    eye = torch.eye(k, dtype=torch.bool, device=xa.device)
    xab = torch.where(eye[:, None, :], xb[None], xa[None])     # (k, m, k)
    return torch.cat([xa, xb, xab.reshape(k * m, k)], dim=0)


def main_effect_indices(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    unc: FeatureUncertainty,
    m: int,
    key=None,
    *,
    task: str = "regression",
    y_hat: torch.Tensor | None = None,
    use_kernel: bool = True,
) -> SobolEstimate:
    """First-order indices from one batched model call of ``(k+2)·m`` rows.

    ``model_fn``: ``(n, k) -> (n,)``, float values for regression, class
    ids for classification (turned into the indicator of ``y_hat``).
    """
    f_all = model_fn(_build_eval_matrix(unc, m, key, use_kernel))
    idx, var_y = indices_from_outputs(f_all, m, unc.k, task=task, y_hat=y_hat)
    return SobolEstimate(indices=idx, var_y=var_y, n_evals=(unc.k + 2) * m)


def indices_from_outputs(
    f_all: torch.Tensor,
    m: int,
    k: int,
    *,
    task: str = "regression",
    y_hat: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(indices (..., k), var_y (...))`` from the model outputs of ``[A; B;
    AB_1; ...; AB_k]`` (``(..., (k+2)·m)`` values, one row a lane, ``y_hat``
    one a lane); both executors reduce through it.

    The two references differ only when ``var_y`` is NaN (the host loop's
    ``where(var_y <= 1e-12, 0, I)`` keeps the NaN, the fused one's
    ``where(var_y > 1e-12, I, 0)`` gives zeros); the port gives zeros.
    """
    if task == "classification":
        if y_hat is None:
            raise ValueError("classification indices need y_hat")
        f_all = f_all.to(torch.int32) == y_hat.to(torch.int32)[..., None]
    if f_all.shape[-1] != (k + 2) * m:
        raise ValueError(f"expected (k+2)·m = {(k + 2) * m} outputs a lane, got {f_all.shape}")
    f_all = f_all.to(f32)
    # centred before the pick-freeze product, as in the reference
    f_all = f_all - f_all.mean(-1, keepdim=True)
    fa, fb = f_all[..., :m], f_all[..., m : 2 * m]
    fab = f_all[..., 2 * m :].reshape(f_all.shape[:-1] + (k, m))
    var_y = f_all.var(-1, correction=0)
    v_j = (fb[..., None, :] * (fab - fa[..., None, :])).mean(dim=-1)
    idx = torch.clamp(v_j / torch.clamp(var_y, min=1e-12)[..., None], 0.0, 1.0)
    return torch.where(var_y[..., None] > 1e-12, idx, torch.zeros_like(idx)), var_y
