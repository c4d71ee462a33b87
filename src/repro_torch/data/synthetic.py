"""The synthetic ``turbofan`` and ``sensor_health`` workloads, built without JAX.

Port of the parts of ``repro/data/synthetic.py`` that build them:

* ``turbofan``: a 40-tree random-forest regressor over nine parametric
  AVG/STD/SUM aggregates of six sensor channels;
* ``sensor_health``: a 60-tree gradient-boosted regressor over five
  aggregates of a ``telemetry`` table, three of them holistic
  (``median(temp)``, ``quantile(vib, 0.9)``, ``median(vib)``) and two
  parametric (``avg(pressure)``, ``std(temp)``), plus the request field
  ``age``.

The generator draws from numpy in the reference's order and trains the
model with the same numpy CART, so the store and the tree arrays are
bit-identical to the reference's for the same arguments; only
``delta_default`` (the model's held-out MAE, computed by the port's own
inference) may differ in its last bits.  The other pipelines need models
(linear, MLP) that later slices port.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
from typing import Callable

import numpy as np
import torch

from repro_torch.core.pipeline import AggFeature, ExactFeature, Pipeline
from repro_torch.data.store import ColumnStore, build_table
from repro_torch.device import resolve_device
from repro_torch.models.tabular.trees import GradientBoosting, RandomForest

__all__ = ["PIPELINE_NAMES", "PipelineBundle", "make_pipeline"]


@dataclass
class PipelineBundle:
    """Everything needed to serve + evaluate one pipeline."""

    pipeline: Pipeline
    store: ColumnStore
    requests: list[dict]
    labels: np.ndarray          # true held-out label per request
    table_rows: int
    name: str = ""


@dataclass(frozen=True)
class _ColSpec:
    name: str
    kind: str = "normal"      # "normal" | "indicator"
    row_noise: float = 1.0    # stddev of row-level noise around the group mean


@dataclass(frozen=True)
class _PipeSpec:
    name: str
    table: str
    cols: tuple[_ColSpec, ...]
    aggs: tuple[tuple, ...]                  # (op, column) or (op, column, q)
    exact_fields: tuple[str, ...]            # request-provided scalars
    model_kind: str                          # lgbm | xgb | rf | lr | mlp
    task: str                                # regression | classification
    label_fn: Callable = None


def _norm_agg(entry: tuple) -> tuple[str, str, float]:
    """An agg spec entry as (op, column, q); q is 0.5 unless given."""
    if len(entry) == 2:
        return entry[0], entry[1], 0.5
    return entry


def _agg_latent(op, group_mean, group_std, n, row_noise, q=0.5):
    """Population value of an aggregate from the group parameters.

    Rows are drawn as ``mean + noise·std·row_noise``, symmetric about the
    group mean, so a median's latent is the mean and a q-quantile's is the
    Normal quantile.
    """
    if op in ("avg", "median"):
        return group_mean
    if op == "quantile":
        return group_mean + group_std * row_noise * NormalDist().inv_cdf(q)
    if op in ("sum", "count"):
        return group_mean * n
    if op == "std":
        return group_std * row_noise
    if op == "var":
        return (group_std * row_noise) ** 2
    raise ValueError(op)


def _make_model(kind: str, task: str, seed: int):
    if kind in ("lgbm", "xgb"):
        return GradientBoosting(
            n_trees=60, max_depth=5, task=task, seed=seed, learning_rate=0.15
        )
    if kind == "rf":
        return RandomForest(n_trees=40, max_depth=8, task=task, seed=seed)
    raise NotImplementedError(
        f"model kind {kind!r} is not ported yet (linear and MLP models are a "
        "later slice of the PyTorch port)"
    )


def _build_from_spec(spec, seed, rows_per_group, n_train_groups, n_serve_groups,
                     n_requests, device) -> PipelineBundle:
    rng = np.random.default_rng(seed)
    G = n_train_groups + n_serve_groups
    k = len(spec.aggs)
    E = len(spec.exact_fields)
    cols = {c.name: c for c in spec.cols}

    group_mean, group_std = {}, {}
    for c in spec.cols:
        if c.kind == "indicator":
            group_mean[c.name] = rng.uniform(0.05, 0.6, G)
            group_std[c.name] = np.sqrt(group_mean[c.name] * (1 - group_mean[c.name]))
        else:
            group_mean[c.name] = rng.normal(0.0, 2.0, G)
            group_std[c.name] = rng.uniform(0.5, 3.0, G)

    # group sizes vary ±25% around rows_per_group
    sizes = rng.integers(
        max(int(rows_per_group * 0.75), 8), int(rows_per_group * 1.25) + 1, G
    )
    norm_aggs = tuple(_norm_agg(a) for a in spec.aggs)
    agg_pop = np.stack(
        [
            _agg_latent(
                op, group_mean[cname], group_std[cname], sizes,
                1.0 if cols[cname].kind == "indicator" else cols[cname].row_noise, q,
            )
            for (op, cname, q) in norm_aggs
        ],
        axis=1,
    )  # (G, k)
    exact_all = rng.normal(0.0, 1.0, (G, E)) if E else np.zeros((G, 0))
    labels = spec.label_fn(agg_pop, exact_all, rng)  # (G,)

    # rows exist only for serve groups (training uses population aggregates)
    serve_slice = slice(n_train_groups, G)
    serve_sizes = sizes[serve_slice]
    total_rows = int(serve_sizes.sum())
    gid_rows = np.repeat(np.arange(n_serve_groups), serve_sizes)
    data_cols = {}
    for c in spec.cols:
        mu = group_mean[c.name][serve_slice][gid_rows]
        sd = group_std[c.name][serve_slice][gid_rows]
        if c.kind == "indicator":
            data_cols[c.name] = (rng.random(total_rows) < mu).astype(np.float32)
        else:
            data_cols[c.name] = (
                mu + rng.normal(0, 1, total_rows) * sd * c.row_noise
            ).astype(np.float32)
    table = build_table(data_cols, gid_rows, seed=seed + 1)
    store = ColumnStore().add(spec.table, table)

    # exact aggregates of serve groups (the held-out MAE is taken on them)
    serve_exact_aggs = np.zeros((n_serve_groups, k), np.float32)
    for j, (op, cname, q) in enumerate(norm_aggs):
        for g in range(n_serve_groups):
            vals = table.full_values(cname, g)
            if op == "avg":
                serve_exact_aggs[g, j] = vals.mean()
            elif op == "median":
                serve_exact_aggs[g, j] = np.median(vals)
            elif op == "quantile":
                serve_exact_aggs[g, j] = np.quantile(vals, q)
            elif op in ("sum", "count"):
                serve_exact_aggs[g, j] = vals.sum()
            elif op == "std":
                serve_exact_aggs[g, j] = vals.std(ddof=1)
            elif op == "var":
                serve_exact_aggs[g, j] = vals.var(ddof=1)

    X_train = np.concatenate(
        [agg_pop[:n_train_groups], exact_all[:n_train_groups]], axis=1
    ).astype(np.float32)
    y_train = labels[:n_train_groups].astype(np.float32)
    scaler_mean = X_train.mean(0)
    scaler_scale = np.maximum(X_train.std(0), 1e-6)
    model = _make_model(spec.model_kind, spec.task, seed)
    model.fit((X_train - scaler_mean) / scaler_scale, y_train)
    model.to(device)

    # held-out MAE -> the paper-default delta
    X_serve = np.concatenate([serve_exact_aggs, exact_all[serve_slice]], axis=1)
    Xs_serve = ((X_serve - scaler_mean) / scaler_scale).astype(np.float32)
    pred_serve = model.predict(torch.from_numpy(Xs_serve).to(device))
    pred_serve = pred_serve.cpu().numpy().astype(np.float64)
    y_serve = labels[serve_slice]
    delta = float(np.mean(np.abs(pred_serve - y_serve))) if spec.task == "regression" else 0.0

    agg_features = [
        AggFeature(name=f"{op}{int(q * 100) if op == 'quantile' else ''}_{cname}",
                   table=spec.table, column=cname, agg=op, group_field="gid", quantile=q)
        for (op, cname, q) in norm_aggs
    ]
    exact_features = [
        ExactFeature(name=f, kind="request", request_field=f) for f in spec.exact_fields
    ]
    pipeline = Pipeline(
        name=spec.name,
        agg_features=agg_features,
        exact_features=exact_features,
        model=model,
        task=spec.task,
        n_classes=2 if spec.task == "classification" else 0,
        scaler_mean=scaler_mean.astype(np.float32),
        scaler_scale=scaler_scale.astype(np.float32),
        delta_default=delta,
    )

    req_groups = rng.integers(0, n_serve_groups, n_requests)
    requests = []
    for g in req_groups:
        req = {"gid": int(g)}
        for e_idx, fname in enumerate(spec.exact_fields):
            req[fname] = float(exact_all[n_train_groups + g, e_idx])
        requests.append(req)
    return PipelineBundle(
        pipeline=pipeline,
        store=store,
        requests=requests,
        labels=labels[serve_slice][req_groups],
        table_rows=total_rows,
        name=spec.name,
    )


def _spec_turbofan():
    # RF regression; 9 AGG over sensor channels, 0 non-AGG.
    def label(agg, ex, rng):
        a = agg
        rul = (
            120.0
            - 6.0 * a[:, 0]
            - 3.0 * np.tanh(a[:, 1]) * a[:, 2]
            - 2.0 * a[:, 3]
            + 1.0 * a[:, 4]
            - 0.8 * a[:, 5] * 0.2
            - 0.02 * np.abs(a[:, 6])
            + 5e-4 * a[:, 7]   # SUM feature scales with N; keep its share O(1)
            - 0.3 * a[:, 8] * 0.1
        )
        return rul + rng.normal(0, 1.0, len(rul))

    return _PipeSpec(
        name="turbofan",
        table="sensors",
        cols=tuple(_ColSpec(f"s{i}") for i in range(1, 7)),
        aggs=(
            ("avg", "s1"), ("avg", "s2"), ("avg", "s3"), ("avg", "s4"),
            ("std", "s1"), ("std", "s2"), ("std", "s3"),
            ("sum", "s5"), ("avg", "s6"),
        ),
        exact_fields=(),
        model_kind="rf",
        task="regression",
        label_fn=label,
    )


def _spec_sensor_health():
    # Holistic-featured workload (beyond Table 1): MEDIAN + tail QUANTILE
    # next to parametric AVG/STD over noisy sensor channels; LGBM
    # regression; 5 AGG, 1 non-AGG.
    def label(agg, ex, rng):
        med_t, p90_v, avg_p, std_t, med_v = agg.T
        age = ex[:, 0]
        health = (
            50.0
            - 2.2 * med_t
            - 1.4 * p90_v
            + 0.9 * avg_p
            - 1.1 * std_t * np.abs(med_v)
            - 1.5 * np.tanh(age)
        )
        return health + rng.normal(0, 0.4, len(med_t))

    return _PipeSpec(
        name="sensor_health",
        table="telemetry",
        cols=(
            _ColSpec("temp", row_noise=1.4),
            _ColSpec("vib"),
            _ColSpec("pressure", row_noise=0.6),
        ),
        aggs=(
            ("median", "temp"),
            ("quantile", "vib", 0.9),
            ("avg", "pressure"),
            ("std", "temp"),
            ("median", "vib"),
        ),
        exact_fields=("age",),
        model_kind="lgbm",
        task="regression",
        label_fn=label,
    )


_SPECS = {"turbofan": _spec_turbofan, "sensor_health": _spec_sensor_health}
PIPELINE_NAMES = tuple(_SPECS)


def make_pipeline(
    name: str,
    seed: int = 0,
    rows_per_group: int = 20000,
    n_train_groups: int = 400,
    n_serve_groups: int = 24,
    n_requests: int = 64,
    *,
    device=None,
) -> PipelineBundle:
    """Build a pipeline bundle at the requested scale, its model on ``device``."""
    if name not in _SPECS:
        raise KeyError(
            f"pipeline {name!r} is not ported yet; the PyTorch port builds {PIPELINE_NAMES}"
        )
    return _build_from_spec(
        _SPECS[name](),
        seed=seed,
        rows_per_group=rows_per_group,
        n_train_groups=n_train_groups,
        n_serve_groups=n_serve_groups,
        n_requests=n_requests,
        device=resolve_device(device),
    )
