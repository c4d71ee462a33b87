"""Small MLP classifier/regressor: ``repro/models/tabular/mlp.py``.

Trained with the port's AdamW by plain autograd (the head has no TPU
kernel).  The initial weights are drawn with the port's threefry
(``core/threefry.py``), bit-exact with ``jax.random``, and the batch order
from ``np.random.default_rng(seed)`` as the reference draws it, so an MLP
fitted here starts from the reference's weights and sees its batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.device import resolve_device
from repro_torch.numerics import sqrt
from repro_torch.optim.adamw import adamw_init, adamw_update, tree_leaves, tree_map

__all__ = ["MLP"]

f32 = torch.float32


def _init_params(key, sizes, device) -> list[dict]:
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        key, sub = threefry.split(key)
        scale = sqrt(torch.tensor(2.0 / fan_in, dtype=f32, device=device))
        w = threefry.normal(sub, (fan_in, fan_out), device=device) * scale
        params.append({"w": w, "b": torch.zeros((fan_out,), dtype=f32, device=device)})
    return params


def _forward(params, x):
    h = x
    for layer in params[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    out = h @ params[-1]["w"] + params[-1]["b"]
    return out[..., 0]


@dataclass
class MLP:
    hidden: tuple[int, ...] = (64, 32)
    task: str = "classification"
    epochs: int = 60
    batch_size: int = 512
    lr: float = 3e-3
    seed: int = 0
    params: Any = None
    device: Any = None  # None = "cuda" (the port's device policy)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "MLP":
        dev = resolve_device(self.device)
        X = torch.as_tensor(np.asarray(X, np.float32), device=dev)
        y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        params = _init_params(threefry.PRNGKey(self.seed), (X.shape[1], *self.hidden, 1), dev)
        opt = adamw_init(params)

        if self.task == "classification":

            def loss_fn(p, xb, yb):
                logits = _forward(p, xb)
                return torch.mean(
                    torch.clamp(logits, min=0) - logits * yb
                    + torch.log1p(torch.exp(-logits.abs()))
                )

        else:

            def loss_fn(p, xb, yb):
                return torch.mean((_forward(p, xb) - yb) ** 2)

        def step(p, o, xb, yb):
            p = tree_map(lambda t: t.detach().requires_grad_(True), p)
            grads = torch.autograd.grad(loss_fn(p, xb, yb), tree_leaves(p))
            it = iter(grads)
            g = tree_map(lambda _: next(it), p)
            return adamw_update(g, o, tree_map(torch.Tensor.detach, p), self.lr,
                                weight_decay=1e-4)

        n = X.shape[0]
        rng = np.random.default_rng(self.seed)
        for _ in range(self.epochs):
            order = rng.permutation(n)
            for s in range(0, n - self.batch_size + 1, self.batch_size):
                idx = torch.as_tensor(order[s : s + self.batch_size], device=dev)
                params, opt = step(params, opt, X[idx], y[idx])
        self.params = params
        return self

    def to(self, device) -> "MLP":
        self.device = torch.device(device)
        self.params = tree_map(lambda t: t.to(self.device), self.params)
        return self

    def predict_logit(self, x: torch.Tensor) -> torch.Tensor:
        return _forward(self.params, x)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        out = self.predict_logit(x)
        if self.task == "classification":
            return (out > 0).to(torch.int32)
        return out

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.predict_logit(x))
