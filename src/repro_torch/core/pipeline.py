"""Inference-pipeline definition (paper §2): feature prep operators + model.

Port of ``repro/core/pipeline.py``.  Feature layout is ``[agg features...,
exact features...]``; the model closures tile the exact part and vary only
the aggregate part, then apply the pipeline's standard scaling and the
model: :func:`make_model_fn` closes over one request's exact features (the
host-loop executor), :func:`make_fused_model_fn` takes them as data (the
fused executor).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.data.store import ColumnStore
from repro_torch.models.tabular.trees import TreeModel

__all__ = ["AggFeature", "ExactFeature", "Pipeline", "make_fused_model_fn", "make_model_fn"]


@dataclass(frozen=True)
class AggFeature:
    """An expensive aggregation feature over a request-selected row group."""

    name: str
    table: str
    column: str
    agg: str                  # sum | count | avg | var | std | median | quantile
    group_field: str          # request field selecting the group
    quantile: float = 0.5
    approximate: bool = True  # False -> always computed exactly (Fig. 10 knob)


@dataclass(frozen=True)
class ExactFeature:
    """A cheap, exactly-computed feature."""

    name: str
    kind: str                 # "lookup" | "request"
    table: str = ""
    column: str = ""
    group_field: str = ""     # for lookups
    request_field: str = ""   # for request passthroughs
    transform: str = "id"     # id | log1p


@dataclass
class Pipeline:
    """A runnable inference pipeline."""

    name: str
    agg_features: Sequence[AggFeature]
    exact_features: Sequence[ExactFeature]
    model: Any                      # predict(x) -> (n,); trees take use_kernel=
    task: str                       # "regression" | "classification"
    n_classes: int = 0
    scaler_mean: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    scaler_scale: np.ndarray = field(default_factory=lambda: np.ones(0, np.float32))
    delta_default: float = 0.0

    @property
    def k(self) -> int:
        return len(self.agg_features)

    def exact_feature_values(self, store: ColumnStore, request: dict) -> np.ndarray:
        out = np.zeros((len(self.exact_features),), np.float32)
        for i, f in enumerate(self.exact_features):
            if f.kind == "lookup":
                v = store[f.table].lookup(f.column, request[f.group_field])
            elif f.kind == "request":
                v = float(request[f.request_field])
            else:
                raise ValueError(f"unknown exact-feature kind {f.kind!r}")
            if f.transform == "log1p":
                v = float(np.log1p(max(v, 0.0)))
            out[i] = v
        return out

    def agg_specs(self, request: dict) -> list[tuple[str, str, int]]:
        return [
            (f.table, f.column, int(request[f.group_field])) for f in self.agg_features
        ]

    def group_sizes(self, store: ColumnStore, request: dict) -> np.ndarray:
        return np.array(
            [store[f.table].group_size(int(request[f.group_field]))
             for f in self.agg_features],
            np.int64,
        )


def make_model_fn(pipeline: Pipeline, exact_vals: np.ndarray, device, *,
                  use_kernel: bool = True):
    """Close over a request's exact features: ``(m, k) aggs -> (m,) preds``.

    The black box ``M`` that AMI and the Sobol indices batch-evaluate, the
    standard scaling folded in.  The model must already live on ``device``;
    ``use_kernel`` reaches the tree models (``ensemble_sum``).
    """
    fused = make_fused_model_fn(pipeline, device, use_kernel=use_kernel)
    exact = torch.as_tensor(exact_vals, dtype=torch.float32).to(device)
    return lambda agg_x: fused(agg_x, exact)


def make_fused_model_fn(pipeline: Pipeline, device, *, use_kernel: bool = True):
    """Request-agnostic model closure: ``(agg_rows (..., r, k), exact) -> (..., r)``.

    The exact features are data, so one closure serves every request, and
    a batch of requests too: ``exact`` is one request's ``(e,)``, one a lane
    ``(L, e)`` beside rows ``(L, r, k)``, or one a row, of the rows' leading
    shape.  Whatever the lanes, the model runs ONE call on all the rows,
    ``(L·r, k + e)``.  The model must already live on ``device``.
    ``use_kernel`` reaches the tree models, the only ones with a kernel
    (``ensemble_sum``); the linear models and the MLP are plain PyTorch
    products.
    """
    mean = torch.as_tensor(pipeline.scaler_mean, dtype=torch.float32).to(device)
    scale = torch.as_tensor(pipeline.scaler_scale, dtype=torch.float32).to(device)
    model = pipeline.model
    kw = dict(use_kernel=use_kernel) if isinstance(model, TreeModel) else {}

    def model_fn(agg_rows: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
        lead, e = agg_rows.shape[:-1], exact.shape[-1]
        if exact.dim() == agg_rows.dim() - 1:
            exact = exact[..., None, :]          # one a request or lane: every row of it
        full = torch.cat([agg_rows, exact.expand(*lead, e)], dim=-1)
        full = full.reshape(-1, full.shape[-1])
        if mean.shape[0] == full.shape[1]:
            full = (full - mean[None, :]) / scale[None, :]
        return model.predict(full, **kw).reshape(lead)

    return model_fn
