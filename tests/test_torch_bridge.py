"""The numpy bridge into the PyTorch port, its import hygiene and device policy.

``bundle_to_numpy`` (used by the other ``test_torch_*`` files) turns a
reference ``PipelineBundle`` into the plain-numpy description that
``repro_torch.bridge`` takes, so the port and the reference can be held
against each other on the same store and the same trained trees.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.synthetic import make_pipeline as ref_make_pipeline
from repro_torch.bridge import bundle_from_numpy, store_from_numpy
from repro_torch.serving import BiathlonServer

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(rows_per_group=300, n_train_groups=60, n_serve_groups=3, n_requests=2)


def model_to_numpy(model) -> dict:
    """A reference tabular model (trees, linear, logistic or MLP) as numpy
    arrays and Python metadata: its trained weights, handed over as they are."""
    kind = {"RandomForest": "rf", "GradientBoosting": "gbm", "LinearRegression": "linear",
            "LogisticRegression": "logistic", "MLP": "mlp"}[type(model).__name__]
    if kind in ("linear", "logistic"):
        return {"kind": kind, "task": model.task, "coef": np.asarray(model.coef),
                "intercept": model.intercept}
    if kind == "mlp":
        return {"kind": kind, "task": model.task,
                "params": [{"w": np.asarray(layer["w"]), "b": np.asarray(layer["b"])}
                           for layer in model.params]}
    ens = model.ensemble
    return {"kind": kind, "task": model.task, "base": model.base, "depth": ens.depth,
            **{a: np.asarray(getattr(ens, a))
               for a in ("feature", "threshold", "left", "right", "value")}}


def bundle_to_numpy(bundle) -> dict:
    """A reference ``PipelineBundle`` as numpy arrays and Python metadata."""
    p = bundle.pipeline
    field_names = ("name", "table", "column", "agg", "group_field", "quantile", "approximate")
    exact_names = ("name", "kind", "table", "column", "group_field", "request_field",
                   "transform")
    return {
        "name": bundle.name,
        "store": {
            name: {
                "columns": {c: np.asarray(v) for c, v in t.columns.items()},
                "group_ptr": np.asarray(t.group_ptr),
                "perm": np.asarray(t.perm),
                "group_ids": dict(t.group_ids),
            }
            for name, t in bundle.store.tables.items()
        },
        "pipeline": {
            "name": p.name,
            "task": p.task,
            "n_classes": p.n_classes,
            "agg_features": [{f: getattr(a, f) for f in field_names} for a in p.agg_features],
            "exact_features": [{f: getattr(e, f) for f in exact_names}
                               for e in p.exact_features],
            "scaler_mean": np.asarray(p.scaler_mean),
            "scaler_scale": np.asarray(p.scaler_scale),
            "delta_default": p.delta_default,
            "model": model_to_numpy(p.model),
        },
        "requests": list(bundle.requests),
        "labels": np.asarray(bundle.labels),
    }


@pytest.fixture(scope="module")
def ref_bundle():
    return ref_make_pipeline("turbofan", **TINY)


def test_bridge_round_trips_store_and_trees(ref_bundle):
    spec = bundle_to_numpy(ref_bundle)
    port = bundle_from_numpy(spec)
    rt, pt = ref_bundle.store["sensors"], port.store["sensors"]
    assert (np.asarray(rt.perm) == pt.perm).all()
    assert (np.asarray(rt.group_ptr) == pt.group_ptr).all()
    assert rt.group_ids == pt.group_ids
    for c in rt.columns:
        assert (rt.columns[c] == pt.columns[c]).all()
    re_, pe = ref_bundle.pipeline.model.ensemble, port.pipeline.model.ensemble
    for a in ("feature", "threshold", "left", "right", "value"):
        assert (np.asarray(getattr(re_, a)) == getattr(pe, a).numpy()).all(), a
    assert pe.depth == re_.depth
    assert port.pipeline.model.base == ref_bundle.pipeline.model.base
    assert port.pipeline.delta_default == ref_bundle.pipeline.delta_default
    assert [f.agg for f in port.pipeline.agg_features] == [
        f.agg for f in ref_bundle.pipeline.agg_features
    ]
    assert port.requests == ref_bundle.requests


def test_store_from_numpy_reads_prefixes():
    store = store_from_numpy({"t": {
        "columns": {"v": np.arange(6, dtype=np.float32)},
        "group_ptr": np.array([0, 2, 6]),
        "perm": np.array([1, 0, 5, 4, 3, 2]),
        "group_ids": {10: 0, 20: 1},
    }})
    t = store["t"]
    assert t.group_size(20) == 4
    np.testing.assert_array_equal(t.sample_prefix("v", 20, 8), [5, 4, 3, 2, 0, 0, 0, 0])
    np.testing.assert_array_equal(t.sample_prefix("v", 10, 1), [1])
    with pytest.raises(ValueError, match="unknown group key 30"):
        t.group_size(30)


_HYGIENE_SCRIPT = r"""
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.core.executor import BiathlonConfig
from repro_torch.data.synthetic import PIPELINE_NAMES, make_pipeline, make_pipeline_median
from repro_torch.serving import BiathlonServer
from repro_torch.configs import get_config
from repro_torch.examples import serve_lm_head as ex
from repro_torch.models.tabular import LogisticRegression
small = dict(rows_per_group=300, n_train_groups=60, n_serve_groups=3, n_requests=1,
             device="cpu")
served = {{}}
for name in PIPELINE_NAMES:
    b = make_pipeline(name, **small)
    served[name] = BiathlonServer(b, BiathlonConfig(m=64, m_sobol=16),
                                  device="cpu").serve(b.requests[0])["y_hat"]
b = make_pipeline_median("trip_fare", **small)
served["trip_fare_median"] = BiathlonServer(b, BiathlonConfig(m=64, m_sobol=16),
                                            device="cpu").serve(b.requests[0])["y_hat"]
LogisticRegression(n_steps=2, device="cpu").fit([[0.0], [1.0]], [0.0, 1.0])
sc = ex.build(get_config("qwen1.5-0.5b").reduced(), "cpu", n_users=2, n_events=500)
lm = ex.serve(sc, ex.make_executor(sc, m=32, m_sobol=8), ex.draw_requests(sc, 1))[0]
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(json.dumps({{"bad": bad, "served": served, "lm_y_hat": lm["y_hat"]}}))
"""


def test_port_imports_and_serves_without_jax():
    """A fresh interpreter imports the port and serves on the CPU (a request
    of each of the eight pipelines and of ``trip_fare_median``, the linear,
    logistic and MLP models among them, and an LM-head request) with no
    ``jax`` and no ``repro.*`` module ever loaded."""
    code = _HYGIENE_SCRIPT.format(src=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert len(out["served"]) == 9
    assert all(np.isfinite(y) for y in out["served"].values())
    assert np.isfinite(out["lm_y_hat"])


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_or_reference_imports_in_port_sources():
    port = ROOT / "src" / "repro_torch"
    files = sorted(port.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    walked = {f.parent.relative_to(port).as_posix() for f in files[:-1]}
    for sub in ("configs", "models/lm", "models/tabular", "optim", "examples",
                "kernels/flash_attention", "kernels/sobol"):
        assert sub in walked, sub
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f.relative_to(ROOT)} imports {mod}"


def test_server_defaults_to_cuda_and_raises_without_it(ref_bundle, monkeypatch):
    """No ``device=`` means CUDA; without a card that raises rather than
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = bundle_from_numpy(bundle_to_numpy(ref_bundle))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        BiathlonServer(port)
    with pytest.raises(NotImplementedError, match="mode='fused' only"):
        BiathlonServer(port, mode="host", device="cpu")
