"""Linear and logistic models: ``repro/models/tabular/linear.py``.

``LinearRegression`` solves its ridge normal equations in float64 numpy,
as the reference does, so its ``coef`` and ``intercept`` are the
reference's bit for bit.  ``LogisticRegression`` runs the reference's
full-batch gradient descent in float32 with ``torch.autograd``; its
weights agree with the reference's to float32 rounding, not bitwise (the
reductions are ordered differently).  Inference is one matrix-vector
product in PyTorch: the reference leaves it to XLA, outside any kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["LinearRegression", "LogisticRegression"]

f32 = torch.float32


class _Linear:
    """``x @ coef + intercept`` with ``coef`` kept as numpy and as a tensor
    on the model's device (moved by :meth:`to`)."""

    coef: np.ndarray
    intercept: float
    _w: torch.Tensor | None = None

    def to(self, device) -> "_Linear":
        self._w = torch.from_numpy(np.array(self.coef, np.float32)).to(device)
        return self

    def predict_logit(self, x: torch.Tensor) -> torch.Tensor:
        if self._w is None:
            self.to(x.device)
        return x @ self._w + self.intercept


@dataclass
class LinearRegression(_Linear):
    """Ridge-regularized least squares, closed form."""

    l2: float = 1e-6
    task: str = "regression"
    coef: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    intercept: float = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LinearRegression":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        Xa = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        A = Xa.T @ Xa + self.l2 * np.eye(Xa.shape[1])
        b = Xa.T @ y
        w = np.linalg.solve(A, b)
        self.coef = w[:-1].astype(np.float32)
        self.intercept = float(w[-1])
        self._w = None
        return self

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.predict_logit(x)


@dataclass
class LogisticRegression(_Linear):
    """Binary logistic regression by full-batch gradient descent."""

    l2: float = 1e-4
    n_steps: int = 300
    lr: float = 0.5
    task: str = "classification"
    coef: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    intercept: float = 0.0
    device: Any = None  # where the fit runs; None = "cuda" (the port's device policy)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LogisticRegression":
        dev = resolve_device(self.device)
        X = torch.as_tensor(np.asarray(X, np.float32), device=dev)
        y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        Xa = torch.cat([X, torch.ones((X.shape[0], 1), dtype=f32, device=dev)], dim=1)
        w = torch.zeros((X.shape[1] + 1,), dtype=f32, device=dev)
        for _ in range(self.n_steps):
            w = w.detach().requires_grad_(True)
            logits = Xa @ w
            nll = torch.mean(torch.clamp(logits, min=0) - logits * y
                             + torch.log1p(torch.exp(-logits.abs())))
            loss = nll + 0.5 * self.l2 * torch.sum(w[:-1] ** 2)
            (g,) = torch.autograd.grad(loss, w)
            w = w.detach() - self.lr * g
        w = w.cpu().numpy()
        self.coef = w[:-1]
        self.intercept = float(w[-1])
        return self.to(dev)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return (self.predict_logit(x) > 0).to(torch.int32)

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.predict_logit(x))
