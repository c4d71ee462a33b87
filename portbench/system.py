"""The system under test: the port's continuous-batching server, built from a deployment.

The only module of the benchmark that imports ``repro_torch``.  It hands
the port what the benchmark generated (the rows and their sample order,
the fitted forest, the scaler, the knobs) through the port's public
constructors, and returns the server whose runtime the window drives.
"""
from __future__ import annotations

import numpy as np

__all__ = ["build_server", "knobs", "make_bundle"]


def knobs(dep, setting: dict) -> tuple[float, float]:
    """``(δ, τ)`` of a traffic mix's setting: δ a share of the model's
    held-out MAE for a regression (0 for a classifier), τ by task."""
    if dep.task == "classification":
        return 0.0, float(setting["tau_classification"])
    return float(setting["delta_scale"]) * dep.delta, float(setting["tau_regression"])


def make_bundle(dep, device):
    """The port's ``PipelineBundle`` holding the deployment's rows and forest."""
    from repro_torch.core.pipeline import AggFeature, Pipeline
    from repro_torch.data.store import ColumnStore, Table
    from repro_torch.data.synthetic import PipelineBundle
    from repro_torch.models.tabular.trees import RandomForest, TreeEnsemble

    cfg = dep.config
    n_groups = dep.n_groups
    table = Table(columns=dict(dep.columns), group_ptr=dep.group_ptr.copy(),
                  perm=dep.perm.copy(), group_ids={g: g for g in range(n_groups)},
                  versions=[0] * n_groups)
    store = ColumnStore().add(cfg["table"], table)
    mdl = cfg["model"]
    forest = RandomForest(n_trees=mdl["n_trees"], max_depth=mdl["max_depth"],
                          n_bins=mdl["n_bins"], feature_frac=mdl["feature_frac"],
                          task=cfg["task"])
    f = dep.forest
    forest.ensemble = TreeEnsemble(f["feature"], f["threshold"], f["left"], f["right"],
                                   f["value"], dep.depth)
    forest.base = dep.base
    forest.to(device)
    pipeline = Pipeline(
        name=cfg["name"],
        agg_features=[AggFeature(name=f"{op}_{c}", table=cfg["table"], column=c, agg=op,
                                 group_field=cfg["group_field"]) for op, c in dep.aggs],
        exact_features=[], model=forest, task=cfg["task"], n_classes=int(cfg["n_classes"]),
        scaler_mean=dep.scaler_mean, scaler_scale=dep.scaler_scale, delta_default=dep.delta)
    requests = [{cfg["group_field"]: g} for g in range(n_groups)]
    return PipelineBundle(pipeline=pipeline, store=store, requests=requests,
                          labels=np.zeros(n_groups), table_rows=int(dep.sizes.sum()),
                          name=cfg["name"])


def build_server(dep, traffic: dict, device):
    """A ``ContinuousBatchedServer`` of the traffic's lanes and chunk length,
    with the traffic's knobs and no feature cache."""
    from repro_torch.core.executor import BiathlonConfig
    from repro_torch.serving import ContinuousBatchedServer

    delta, tau = knobs(dep, traffic["setting"])
    b = dep.config["biathlon"]
    cfg = BiathlonConfig(alpha=b["alpha"], gamma=b["gamma"], tau=tau,
                         delta=delta if dep.task == "regression" else None, m=b["m"],
                         m_sobol=b["m_sobol"], n_bootstrap=b["n_bootstrap"],
                         max_iters=b["max_iters"])
    return ContinuousBatchedServer(make_bundle(dep, device), cfg,
                                   batch_size=int(traffic["lanes"]),
                                   chunk_iters=int(traffic["chunk_iters"]), device=device)
