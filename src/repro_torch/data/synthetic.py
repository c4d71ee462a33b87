"""The eight synthetic pipelines of the paper's Table 1 and appendix D, built without JAX.

Port of ``repro/data/synthetic.py``: ``trip_fare`` (gradient boosting,
COUNT + 2 AVG, 5 request fields), ``tick_price`` (linear regression, one
AVG, 6 request fields), ``battery`` (gradient boosting, avg + std of five
channels), ``turbofan`` (random forest, 9 AVG/STD/SUM),
``bearing_imbalance`` (MLP classifier, AVG/STD/VAR of three vibration
channels), ``fraud_detection`` (boosted classifier, three COUNTs, 6 request
fields), ``student_qa`` (random-forest classifier, 21 aggregates) and
``sensor_health`` (gradient boosting over MEDIAN/QUANTILE and parametric
aggregates); :func:`make_pipeline_median` gives a pipeline's appendix-D
variant (AVG→MEDIAN, or COUNT→MEDIAN where it has no AVG), retrained.

The generator draws from numpy in the reference's order and trains the
trees with the same numpy CART and the linear model with the same float64
normal equations, so the store, the tree arrays and the linear
coefficients are bit-identical to the reference's for the same arguments.
The MLP trains with the port's autograd and AdamW from the reference's
initial weights and batch order; its weights agree to float32 rounding,
not bitwise.  ``delta_default`` (the model's held-out MAE, computed by the
port's own inference) may differ from the reference's in its last bits.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from statistics import NormalDist
from typing import Callable

import numpy as np
import torch

from repro_torch.core.pipeline import AggFeature, ExactFeature, Pipeline
from repro_torch.data.store import ColumnStore, build_table
from repro_torch.device import resolve_device
from repro_torch.models.tabular.linear import LinearRegression
from repro_torch.models.tabular.mlp import MLP
from repro_torch.models.tabular.trees import GradientBoosting, RandomForest

__all__ = ["PIPELINE_NAMES", "PipelineBundle", "make_pipeline", "make_pipeline_median",
           "poisson_arrivals"]


def poisson_arrivals(
    requests: list[dict],
    rate_rps: float,
    n: int | None = None,
    seed: int = 0,
    start_t: float = 0.0,
) -> list[tuple[float, dict]]:
    """Timestamped Poisson arrival trace over a request log.

    Inter-arrival gaps are Exp(rate) — the M/*/1 open-loop workload the
    serving runtime replays (``serving/runtime.py``).  Requests are cycled from
    ``requests`` when ``n`` exceeds the log.  Returns ``[(t_seconds, req)]``
    sorted by time; deterministic in ``seed``, and drawn from numpy's
    ``default_rng(seed)`` as the reference draws it, so the two traces are
    bitwise equal.

    Degenerate inputs are pinned explicitly rather than left to numpy:
    ``rate_rps`` must be a positive finite number (zero, negative, and NaN
    all raise — NaN would silently satisfy neither branch of a ``<= 0``
    check), ``n < 0`` raises, and ``n == 0`` is a well-defined EMPTY trace
    (not whatever an empty ``cumsum`` happens to produce downstream).
    """
    if not (rate_rps > 0) or not np.isfinite(rate_rps):
        raise ValueError(f"rate_rps must be a positive finite number, got {rate_rps}")
    if n is not None and n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if not requests or n == 0:
        return []
    n = len(requests) if n is None else n
    rng = np.random.default_rng(seed)
    ts = start_t + np.cumsum(rng.exponential(1.0 / rate_rps, n))
    return [(float(t), requests[i % len(requests)]) for i, t in enumerate(ts)]


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


def _make_model(kind: str, task: str, seed: int, device):
    if kind in ("lgbm", "xgb"):
        return GradientBoosting(
            n_trees=60, max_depth=5, task=task, seed=seed, learning_rate=0.15
        )
    if kind == "rf":
        return RandomForest(n_trees=40, max_depth=8, task=task, seed=seed)
    if kind == "lr" and task == "regression":
        return LinearRegression()
    if kind == "mlp":
        return MLP(hidden=(48, 24), task=task, epochs=25, seed=seed, device=device)
    # the reference has no linear classifier pipeline ("lr" classification)
    raise ValueError(f"invalid model/task combination {kind!r}/{task!r}")


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
    model = _make_model(spec.model_kind, spec.task, seed, device)
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


def _spec_trip_fare():
    # LGBM regression; 3 AGG (COUNT + 2 AVG from trip history), 5 non-AGG.
    def label(agg, ex, rng):
        cnt, avg_d, avg_t = agg[:, 0], agg[:, 1], agg[:, 2]
        hour, dist, pax, wknd, surge = ex.T
        return (
            2.5
            + 1.9 * np.abs(dist)
            + 0.45 * avg_d
            + 0.0015 * cnt
            + 1.1 * avg_t
            + 0.8 * np.sin(hour)
            + 0.5 * wknd * np.abs(dist)
            + 0.3 * surge**2
            + rng.normal(0, 0.25, len(cnt))
        )

    return _PipeSpec(
        name="trip_fare",
        table="trips",
        cols=(
            _ColSpec("is_long", "indicator"),
            _ColSpec("distance"),
            _ColSpec("tip"),
        ),
        aggs=(("count", "is_long"), ("avg", "distance"), ("avg", "tip")),
        exact_fields=("hour", "req_distance", "passengers", "weekend", "surge"),
        model_kind="lgbm",
        task="regression",
        label_fn=label,
    )


def _spec_tick_price():
    # LR regression; 1 AGG (AVG price over tick window), 6 non-AGG.
    def label(agg, ex, rng):
        avg_p = agg[:, 0]
        bid, ask, spread, vol, hour, lag = ex.T
        return (
            0.72 * avg_p
            + 0.18 * lag
            + 0.06 * (bid + ask)
            - 0.04 * spread
            + 0.02 * vol
            + rng.normal(0, 0.05, len(avg_p))
        )

    return _PipeSpec(
        name="tick_price",
        table="ticks",
        # ticks within a window cluster tightly around the window mean —
        # low row-level spread, like real sub-second FX tick streams
        cols=(_ColSpec("price", row_noise=0.12),),
        aggs=(("avg", "price"),),
        exact_fields=("bid", "ask", "spread", "vol", "hour", "lag_price"),
        model_kind="lr",
        task="regression",
        label_fn=label,
    )


def _spec_battery():
    # LGBM regression; 10 AGG (avg+std of 5 measurement channels), 1 non-AGG.
    def label(agg, ex, rng):
        a = agg
        cyc = ex[:, 0]
        return (
            40.0
            - 3.0 * a[:, 0]                    # avg voltage
            + 1.5 * a[:, 1]                    # std voltage
            - 1.2 * a[:, 2] * np.tanh(a[:, 4]) # current x temp interaction
            + 0.8 * a[:, 6]
            - 0.5 * a[:, 8] ** 2 * 0.1
            - 2.0 * np.tanh(cyc)
            + rng.normal(0, 0.4, len(cyc))
        )

    cols = tuple(
        _ColSpec(c) for c in ("voltage", "current", "temp", "capacity", "resistance")
    )
    aggs = tuple(
        (op, c.name) for c in cols for op in ("avg", "std")
    )
    return _PipeSpec(
        name="battery",
        table="cycles",
        cols=cols,
        aggs=aggs,
        exact_fields=("cycle_idx",),
        model_kind="lgbm",
        task="regression",
        label_fn=label,
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

    cols = tuple(_ColSpec(f"s{i}") for i in range(1, 7))
    aggs = (
        ("avg", "s1"),
        ("avg", "s2"),
        ("avg", "s3"),
        ("avg", "s4"),
        ("std", "s1"),
        ("std", "s2"),
        ("std", "s3"),
        ("sum", "s5"),
        ("avg", "s6"),
    )
    return _PipeSpec(
        name="turbofan",
        table="sensors",
        cols=cols,
        aggs=aggs,
        exact_fields=(),
        model_kind="rf",
        task="regression",
        label_fn=label,
    )


def _spec_bearing():
    # MLP binary classification; 8 AGG (vibration channel stats), 0 non-AGG.
    def label(agg, ex, rng):
        a = agg
        score = (
            1.4 * a[:, 1]          # std x
            + 1.2 * a[:, 3]        # std y
            + 0.9 * a[:, 5]        # std z
            + 0.4 * a[:, 0] * a[:, 2]
            + 0.25 * a[:, 6]
            - 0.2 * np.abs(a[:, 4])
        )
        thr = np.median(score)
        return (score + rng.normal(0, 0.25, len(score)) > thr).astype(np.float64)

    cols = (_ColSpec("vx"), _ColSpec("vy"), _ColSpec("vz"))
    aggs = (
        ("avg", "vx"),
        ("std", "vx"),
        ("avg", "vy"),
        ("std", "vy"),
        ("avg", "vz"),
        ("std", "vz"),
        ("var", "vx"),
        ("var", "vy"),
    )
    return _PipeSpec(
        name="bearing_imbalance",
        table="vibration",
        cols=cols,
        aggs=aggs,
        exact_fields=(),
        model_kind="mlp",
        task="classification",
        label_fn=label,
    )


def _spec_fraud():
    # XGB binary classification; 3 AGG (click counts), 6 non-AGG.
    def label(agg, ex, rng):
        # higher click / repeat / burst counts => more likely fraud
        c1, c2, c3 = agg[:, 0], agg[:, 1], agg[:, 2]
        app, dev, os_, chan, hour, gap = ex.T
        score = (
            0.004 * c1
            + 0.006 * c2
            + 0.003 * c3
            + 0.5 * np.tanh(app)
            - 0.4 * np.abs(gap)
            + 0.3 * chan
        )
        thr = np.quantile(score, 0.7)
        return (score + rng.normal(0, 0.3, len(score)) > thr).astype(np.float64)

    cols = (
        _ColSpec("is_click", "indicator"),
        _ColSpec("is_repeat", "indicator"),
        _ColSpec("is_burst", "indicator"),
    )
    return _PipeSpec(
        name="fraud_detection",
        table="clicks",
        cols=cols,
        aggs=(("count", "is_click"), ("count", "is_repeat"), ("count", "is_burst")),
        exact_fields=("app", "device", "os", "channel", "hour", "click_gap"),
        model_kind="xgb",
        task="classification",
        label_fn=label,
    )


def _spec_student_qa():
    # RF binary classification; 21 AGG over game-log channels, 0 non-AGG.
    def label(agg, ex, rng):
        a = agg
        score = (
            0.8 * a[:, 0]
            + 0.6 * a[:, 1]
            - 0.5 * a[:, 2]
            + 0.4 * np.tanh(a[:, 3])
            + 0.3 * a[:, 4] * np.sign(a[:, 5])
            + 0.002 * a[:, 16]
            + 0.15 * a[:, 8]
            - 0.1 * a[:, 12]
        )
        thr = np.median(score)
        return (score + rng.normal(0, 0.35, len(score)) > thr).astype(np.float64)

    # 8 AVG (the appendix-D MEDIAN substitution targets these), 4 STD,
    # 3 COUNT, 2 SUM, 4 VAR  => 21 aggregate features over 11 columns.
    cols = tuple(_ColSpec(f"c{i}") for i in range(1, 9)) + (
        _ColSpec("f1", "indicator"),
        _ColSpec("f2", "indicator"),
        _ColSpec("f3", "indicator"),
    )
    aggs = (
        tuple(("avg", f"c{i}") for i in range(1, 9))
        + tuple(("std", f"c{i}") for i in range(1, 5))
        + (("count", "f1"), ("count", "f2"), ("count", "f3"))
        + (("sum", "c5"), ("sum", "c6"))
        + tuple(("var", f"c{i}") for i in range(5, 9))
    )
    return _PipeSpec(
        name="student_qa",
        table="gamelog",
        cols=cols,
        aggs=aggs,
        exact_fields=(),
        model_kind="rf",
        task="classification",
        label_fn=label,
    )


def _spec_sensor_health():
    # Holistic-featured workload (beyond Table 1): robust location/tail
    # statistics over noisy sensor channels — MEDIAN + tail QUANTILE next to
    # parametric AVG/STD, the operator mix appendix D covers.  LGBM
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

    cols = (
        _ColSpec("temp", row_noise=1.4),
        _ColSpec("vib"),
        _ColSpec("pressure", row_noise=0.6),
    )
    aggs = (
        ("median", "temp"),
        ("quantile", "vib", 0.9),
        ("avg", "pressure"),
        ("std", "temp"),
        ("median", "vib"),
    )
    return _PipeSpec(
        name="sensor_health",
        table="telemetry",
        cols=cols,
        aggs=aggs,
        exact_fields=("age",),
        model_kind="lgbm",
        task="regression",
        label_fn=label,
    )


_SPECS = {
    "trip_fare": _spec_trip_fare,
    "tick_price": _spec_tick_price,
    "battery": _spec_battery,
    "turbofan": _spec_turbofan,
    "bearing_imbalance": _spec_bearing,
    "fraud_detection": _spec_fraud,
    "student_qa": _spec_student_qa,
    "sensor_health": _spec_sensor_health,
}
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
        raise KeyError(f"unknown pipeline {name!r}; choose from {PIPELINE_NAMES}")
    return _build_from_spec(
        _SPECS[name](),
        seed=seed,
        rows_per_group=rows_per_group,
        n_train_groups=n_train_groups,
        n_serve_groups=n_serve_groups,
        n_requests=n_requests,
        device=resolve_device(device),
    )


def make_pipeline_median(
    name: str,
    seed: int = 0,
    rows_per_group: int = 20000,
    n_train_groups: int = 400,
    n_serve_groups: int = 24,
    n_requests: int = 64,
    *,
    device=None,
) -> PipelineBundle:
    """Appendix D: the pipeline with AVG→MEDIAN substitution (COUNT→MEDIAN
    where it has no AVG), retrained, named ``<name>_median``."""
    if name not in _SPECS:
        raise KeyError(f"unknown pipeline {name!r}; choose from {PIPELINE_NAMES}")
    spec = _SPECS[name]()
    aggs = tuple(_norm_agg(a) for a in spec.aggs)
    target = "avg" if any(op == "avg" for op, _, _ in aggs) else "count"
    spec = replace(
        spec,
        name=f"{name}_median",
        aggs=tuple(("median", c) if op == target else (op, c, q) for (op, c, q) in aggs),
    )
    return _build_from_spec(
        spec,
        seed=seed,
        rows_per_group=rows_per_group,
        n_train_groups=n_train_groups,
        n_serve_groups=n_serve_groups,
        n_requests=n_requests,
        device=resolve_device(device),
    )
