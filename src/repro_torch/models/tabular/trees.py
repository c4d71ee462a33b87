"""Tree-ensemble models (Random Forest + Gradient Boosting).

Port of ``repro/models/tabular/trees.py``.  Training is the reference's
numpy histogram CART, copied so that both packages grow bit-identical tree
arrays from the same data and seed.  Trees are stored tensorized
(Hummingbird-style complete node arrays) as the buffers of a
:class:`TreeEnsemble` module and traversed level-wise with gathers:

    idx ← 0;  repeat depth times:  idx ← (x[feat[idx]] ≤ thr[idx]) ? L[idx] : R[idx]

``predict_raw`` goes through ``kernels/tree_qmc/ops.predict_sum``: the
``ensemble_sum`` CUDA kernel for a CUDA tensor, the plain traversal for a
CPU tensor.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.tree_qmc.ops import predict_sum
from repro_torch.kernels.tree_qmc.ref import ensemble_predict_sum

__all__ = [
    "GradientBoosting",
    "RandomForest",
    "TreeEnsemble",
    "ensemble_predict_sum",
    "fit_tree_arrays",
]


class TreeEnsemble(nn.Module):
    """Padded, stacked decision trees held as buffers.

    feature (T, M) int32 split feature per node (leaves: 0); threshold
    (T, M) f32; left / right (T, M) int32 child ids (leaves: self); value
    (T, M) f32 leaf prediction; ``depth`` the traversal rounds.
    """

    def __init__(self, feature, threshold, left, right, value, depth: int):
        super().__init__()
        for name, arr, dtype in (
            ("feature", feature, np.int32), ("threshold", threshold, np.float32),
            ("left", left, np.int32), ("right", right, np.int32),
            ("value", value, np.float32),
        ):
            self.register_buffer(name, torch.tensor(np.asarray(arr, dtype)))
        self.depth = int(depth)

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]


# --------------------------------------------------------------------------
# Histogram CART training (numpy; second-order gain, XGBoost-style)
# --------------------------------------------------------------------------
def _quantile_bins(X: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature bin edges (F, n_bins-1) from quantiles."""
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.quantile(X, qs, axis=0).T.astype(np.float32)  # (F, n_bins-1)


def _apply_bins(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    out = np.empty(X.shape, np.int32)
    for f in range(X.shape[1]):
        out[:, f] = np.searchsorted(edges[f], X[:, f], side="right")
    return out


def fit_tree_arrays(
    Xb: np.ndarray,          # (n, F) int32 binned features
    edges: np.ndarray,       # (F, n_bins-1) bin edges
    grad: np.ndarray,        # (n,) first-order gradients
    hess: np.ndarray,        # (n,) second-order gradients (1.0 for plain CART)
    max_depth: int,
    min_child_weight: float = 1.0,
    reg_lambda: float = 1.0,
    feature_frac: float = 1.0,
    rng: np.random.Generator | None = None,
) -> dict:
    """Grow one tree greedily (BFS), return complete node arrays.

    Gain = ½ [ G_L²/(H_L+λ) + G_R²/(H_R+λ) − G²/(H+λ) ];
    leaf value = −G/(H+λ).
    """
    n, F = Xb.shape
    n_bins = int(edges.shape[1]) + 1
    rng = rng or np.random.default_rng(0)
    max_nodes = 2 ** (max_depth + 1) - 1
    feature = np.zeros(max_nodes, np.int32)
    threshold = np.zeros(max_nodes, np.float32)
    split_bin = np.zeros(max_nodes, np.int32)     # bin-space threshold (training)
    left = np.arange(max_nodes, dtype=np.int32)   # default: self-loop (leaf)
    right = np.arange(max_nodes, dtype=np.int32)
    value = np.zeros(max_nodes, np.float32)
    next_free = 1

    frontier = [(0, np.arange(n), 0)]  # (node_id, row_idx, depth)
    while frontier:
        node, rows, depth = frontier.pop()
        g, h = grad[rows], hess[rows]
        G, H = g.sum(), h.sum()
        value[node] = -G / (H + reg_lambda)
        if depth >= max_depth or rows.size < 2 or H < 2 * min_child_weight:
            continue
        feats = (
            rng.choice(F, max(1, int(F * feature_frac)), replace=False)
            if feature_frac < 1.0
            else np.arange(F)
        )
        best = (0.0, -1, -1)  # (gain, feature, bin)
        xb = Xb[rows]
        base = 0.5 * G * G / (H + reg_lambda)
        for f in feats:
            hg = np.bincount(xb[:, f], weights=g, minlength=n_bins)
            hh = np.bincount(xb[:, f], weights=h, minlength=n_bins)
            GL = np.cumsum(hg)[:-1]
            HL = np.cumsum(hh)[:-1]
            GR, HR = G - GL, H - HL
            ok = (HL >= min_child_weight) & (HR >= min_child_weight)
            gain = np.where(
                ok,
                0.5 * (GL**2 / (HL + reg_lambda) + GR**2 / (HR + reg_lambda)) - base,
                -np.inf,
            )
            b = int(np.argmax(gain))
            if gain[b] > best[0]:
                best = (float(gain[b]), int(f), b)
        gain, f, b = best
        if f < 0 or gain <= 1e-12 or next_free + 1 >= max_nodes:
            continue
        lo, hi = next_free, next_free + 1
        next_free += 2
        feature[node] = f
        # training went left iff bin <= b iff x < edges[f, b]; nextafter makes
        # the float-space rule ``x <= thr`` match the bin-space rule exactly.
        threshold[node] = np.nextafter(edges[f, b], -np.inf)
        split_bin[node] = b
        left[node], right[node] = lo, hi
        go_left = Xb[rows, f] <= b
        frontier.append((lo, rows[go_left], depth + 1))
        frontier.append((hi, rows[~go_left], depth + 1))

    return dict(
        feature=feature,
        threshold=threshold,
        split_bin=split_bin,
        left=left,
        right=right,
        value=value,
    )


def _stack_trees(trees: list[dict], depth: int) -> TreeEnsemble:
    return TreeEnsemble(
        *(np.stack([t[key] for t in trees])
          for key in ("feature", "threshold", "left", "right", "value")),
        depth=depth,
    )


def _numpy_tree_predict(tree: dict, Xb: np.ndarray, depth: int) -> np.ndarray:
    """Training-time tree application on binned features (numpy, host)."""
    n = Xb.shape[0]
    idx = np.zeros(n, np.int32)
    rows = np.arange(n)
    for _ in range(depth):
        f = tree["feature"][idx]
        go_left = Xb[rows, f] <= tree["split_bin"][idx]
        idx = np.where(go_left, tree["left"][idx], tree["right"][idx]).astype(np.int32)
    return tree["value"][idx].astype(np.float64)


class _TreeModel(nn.Module):
    """Shared inference of the two ensembles: ``base + scale · Σ leaves``."""

    task: str
    ensemble: TreeEnsemble | None
    base: float

    def _raw(self, x: torch.Tensor, use_kernel: bool) -> torch.Tensor:
        return predict_sum(self.ensemble, x, use_kernel=use_kernel)


class RandomForest(_TreeModel):
    """Bagged CART forest; regression or binary classification."""

    def __init__(self, n_trees: int = 50, max_depth: int = 8, n_bins: int = 64,
                 feature_frac: float = 0.7, task: str = "regression", seed: int = 0):
        super().__init__()
        self.n_trees, self.max_depth, self.n_bins = n_trees, max_depth, n_bins
        self.feature_frac, self.task, self.seed = feature_frac, task, seed
        self.ensemble = None
        self.base = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForest":
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        rng = np.random.default_rng(self.seed)
        edges = _quantile_bins(X, self.n_bins)
        Xb = _apply_bins(X, edges)
        self.base = float(y.mean())
        trees = []
        for _ in range(self.n_trees):
            rows = rng.integers(0, len(y), len(y))  # bootstrap
            # CART via the boosting identity: grad = base − y, hess = 1.
            g = (self.base - y[rows]).astype(np.float64)
            h = np.ones_like(g)
            trees.append(
                fit_tree_arrays(
                    Xb[rows], edges, g, h, self.max_depth,
                    feature_frac=self.feature_frac, rng=rng,
                )
            )
        self.ensemble = _stack_trees(trees, self.max_depth)
        return self

    def predict_raw(self, x: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
        return self.base + self._raw(x, use_kernel) / self.ensemble.n_trees

    def predict(self, x: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
        raw = self.predict_raw(x, use_kernel=use_kernel)
        if self.task == "classification":
            return (raw > 0.5).to(torch.int32)
        return raw


class GradientBoosting(_TreeModel):
    """Second-order gradient boosting; squared loss or logistic loss."""

    def __init__(self, n_trees: int = 100, max_depth: int = 6, n_bins: int = 64,
                 learning_rate: float = 0.1, reg_lambda: float = 1.0,
                 task: str = "regression", seed: int = 0):
        super().__init__()
        self.n_trees, self.max_depth, self.n_bins = n_trees, max_depth, n_bins
        self.learning_rate, self.reg_lambda = learning_rate, reg_lambda
        self.task, self.seed = task, seed
        self.ensemble = None
        self.base = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GradientBoosting":
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.seed)
        edges = _quantile_bins(X, self.n_bins)
        Xb = _apply_bins(X, edges)
        if self.task == "classification":
            p = np.clip(y.mean(), 1e-6, 1 - 1e-6)
            self.base = float(np.log(p / (1 - p)))
        else:
            self.base = float(y.mean())
        pred = np.full(len(y), self.base)
        trees = []
        for _ in range(self.n_trees):
            if self.task == "classification":
                p = 1.0 / (1.0 + np.exp(-pred))
                g, h = p - y, np.maximum(p * (1 - p), 1e-6)
            else:
                g, h = pred - y, np.ones_like(y)
            t = fit_tree_arrays(
                Xb, edges, g, h, self.max_depth, reg_lambda=self.reg_lambda, rng=rng
            )
            trees.append(t)
            pred = pred + self.learning_rate * _numpy_tree_predict(t, Xb, self.max_depth)
        for t in trees:  # fold the learning rate into the stored leaf values
            t["value"] = (t["value"] * self.learning_rate).astype(np.float32)
        self.ensemble = _stack_trees(trees, self.max_depth)
        return self

    def predict_raw(self, x: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
        return self.base + self._raw(x, use_kernel)

    def predict(self, x: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
        raw = self.predict_raw(x, use_kernel=use_kernel)
        if self.task == "classification":
            return (raw > 0.0).to(torch.int32)
        return raw
