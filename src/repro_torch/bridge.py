"""Build the port's objects from plain numpy arrays and Python metadata.

The bridge lets a caller hand the port a store and a trained pipeline that
were made elsewhere — by the JAX reference in the parity tests, or read from
files — without either package importing the other.  Everything it takes is
numpy arrays, Python scalars, strings, lists and dicts:

* a store: per table, its ``columns`` (name -> array), ``group_ptr``,
  ``perm`` and ``group_ids`` (external key -> dense group index), and
  optionally its generator's ``rng_state`` and its ``versions``;
* a pipeline: its ``name``, ``task``, ``n_classes``, ``agg_features`` and
  ``exact_features`` (lists of field dicts), ``scaler_mean``,
  ``scaler_scale``, ``delta_default`` and a ``model`` dict (below);
* a model: its ``kind`` and ``task``, and for ``"rf"`` / ``"gbm"`` the tree
  arrays (``feature``, ``threshold``, ``left``, ``right``, ``value``), its
  ``depth`` and ``base``; for ``"linear"`` / ``"logistic"`` its ``coef``
  and ``intercept``; for ``"mlp"`` its ``params`` (as below);
* a bundle: ``pipeline``, ``store``, ``requests``, ``labels``, ``name``;
* an LM's parameter tree: nested dicts and lists of arrays (``embed``,
  ``unembed``, ``final_norm``, ``frontend_adapter``, the ``dense0`` list of
  unstacked blocks and the stacked ``blocks.{ln1, ln2, attn.*, ffn.* |
  moe.*}`` leaves with their leading ``(L, …)`` axis), in float32 or in
  ``ml_dtypes`` bfloat16;
* an MLP's parameters: a list of ``{"w", "b"}`` dicts of arrays.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.pipeline import AggFeature, ExactFeature, Pipeline
from repro_torch.data.store import ColumnStore, Table
from repro_torch.data.synthetic import PipelineBundle
from repro_torch.models.tabular.linear import LinearRegression, LogisticRegression
from repro_torch.models.tabular.mlp import MLP
from repro_torch.models.tabular.trees import GradientBoosting, RandomForest, TreeEnsemble

__all__ = [
    "bundle_from_numpy",
    "lm_params_from_numpy",
    "mlp_params_from_numpy",
    "model_from_numpy",
    "pipeline_from_numpy",
    "store_from_numpy",
]

_TREE_KINDS = {"rf": RandomForest, "gbm": GradientBoosting}
_LINEAR_KINDS = {"linear": LinearRegression, "logistic": LogisticRegression}
_MODEL_KINDS = (*_TREE_KINDS, *_LINEAR_KINDS, "mlp")


def store_from_numpy(tables: Mapping[str, Mapping]) -> ColumnStore:
    """A :class:`ColumnStore` from ``{name: {columns, group_ptr, perm, group_ids}}``.

    A table may also carry ``rng_state`` (the ``bit_generator.state`` dict of
    the generator its build drew the permutations from, continued) and
    ``versions`` (per dense group): the bridged table then draws the same
    append positions as the table it was taken from.
    """
    store = ColumnStore()
    for name, t in tables.items():
        extra = {}
        if "rng_state" in t:
            state = t["rng_state"]
            rng = np.random.Generator(getattr(np.random, state["bit_generator"])())
            rng.bit_generator.state = state
            extra["rng"] = rng
        if "versions" in t:
            extra["versions"] = [int(v) for v in t["versions"]]
        # copies: an append grows the index in place
        store.add(name, Table(
            columns={c: np.array(v) for c, v in t["columns"].items()},
            group_ptr=np.array(t["group_ptr"], np.int64),
            perm=np.array(t["perm"], np.int64),
            group_ids={int(k): int(v) for k, v in t["group_ids"].items()},
            name=name,
            **extra,
        ))
    return store


def model_from_numpy(spec: Mapping):
    """A model (on the CPU) from its ``kind``, ``task`` and arrays (see the
    module docstring)."""
    kind = spec["kind"]
    if kind in _LINEAR_KINDS:
        model = _LINEAR_KINDS[kind](task=spec["task"],
                                    coef=np.asarray(spec["coef"], np.float32),
                                    intercept=float(spec["intercept"]))
        return model.to("cpu")
    if kind == "mlp":
        params = mlp_params_from_numpy(spec["params"])
        return MLP(hidden=tuple(p["w"].shape[1] for p in params[:-1]), task=spec["task"],
                   params=params, device=torch.device("cpu"))
    if kind not in _TREE_KINDS:
        raise ValueError(f"unknown model kind {kind!r}; choose from {_MODEL_KINDS}")
    ens = TreeEnsemble(
        spec["feature"], spec["threshold"], spec["left"], spec["right"], spec["value"],
        depth=int(spec["depth"]),
    )
    model = _TREE_KINDS[kind](n_trees=ens.n_trees, max_depth=ens.depth, task=spec["task"])
    model.ensemble = ens
    model.base = float(spec["base"])
    return model


def pipeline_from_numpy(spec: Mapping) -> Pipeline:
    """A :class:`Pipeline` from feature specs, scaler, model arrays and delta."""
    return Pipeline(
        name=spec["name"],
        agg_features=[AggFeature(**f) for f in spec["agg_features"]],
        exact_features=[ExactFeature(**f) for f in spec["exact_features"]],
        model=model_from_numpy(spec["model"]),
        task=spec["task"],
        n_classes=int(spec.get("n_classes", 0)),
        scaler_mean=np.asarray(spec["scaler_mean"], np.float32),
        scaler_scale=np.asarray(spec["scaler_scale"], np.float32),
        delta_default=float(spec["delta_default"]),
    )


def bundle_from_numpy(spec: Mapping) -> PipelineBundle:
    """A :class:`PipelineBundle` from ``{pipeline, store, requests, labels, name}``."""
    store = store_from_numpy(spec["store"])
    return PipelineBundle(
        pipeline=pipeline_from_numpy(spec["pipeline"]),
        store=store,
        requests=[dict(r) for r in spec["requests"]],
        labels=np.asarray(spec["labels"]),
        table_rows=sum(t.n_rows for t in store.tables.values()),
        name=spec.get("name", ""),
    )


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret its bits
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)


# leaves the LM keeps in float32 whatever the model's type, by the last keys
# of their path: the MoE router (``moe.init_moe``), Mamba2's and the xLSTM
# cells' gate and decay leaves (``ssm.init_mamba2``, ``init_mlstm``,
# ``init_slstm``)
FLOAT32_LEAVES = frozenset({
    ("moe", "router"),
    *(("mamba", "cell", name) for name in ("dt_bias", "a_log", "d_skip")),
    *(("mlstm", "cell", name) for name in ("w_i", "w_f", "b_i", "b_f")),
    *(("slstm", "cell", name) for name in ("w", "r", "b")),
})


def _float32_leaf(path: tuple) -> bool:
    return any(path[-len(keys):] == keys for keys in FLOAT32_LEAVES)


def lm_params_from_numpy(tree, dtype: torch.dtype, device="cpu", path: tuple = ()):
    """An LM parameter tree on ``device`` from nested dicts and lists of arrays.

    Each leaf becomes a ``dtype`` tensor (the model's type), but for the
    leaves whose path (the dict keys down to them) ends in one of
    ``FLOAT32_LEAVES``, which stay float32 as the model keeps them; both
    packages then compute the same thing from the same weights.  ``path``
    places a subtree (``("mamba", "cell")`` for one Mamba2 cell)."""
    if isinstance(tree, Mapping):
        return {key: lm_params_from_numpy(val, dtype, device, (*path, key))
                for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_params_from_numpy(val, dtype, device, path) for val in tree]
    return _tensor(tree, torch.float32 if _float32_leaf(path) else dtype, device)


def mlp_params_from_numpy(layers, device="cpu") -> list[dict]:
    """MLP parameters (float32) from a list of ``{"w": (fan_in, fan_out), "b": (fan_out,)}``."""
    return [{"w": _tensor(layer["w"], torch.float32, device),
             "b": _tensor(layer["b"], torch.float32, device)} for layer in layers]
