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
from repro_torch.core.executor import BiathlonConfig, run_exact
from repro_torch.serving import BiathlonServer, ContinuousBatchedServer

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
                "rng_state": t.rng.bit_generator.state,
                "versions": list(t.versions),
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
import torch
torch.set_num_threads(1)  # beside other test workers, as torch_pipeline_parity does
from repro_torch.core.executor import BiathlonConfig
from repro_torch.data.synthetic import PIPELINE_NAMES, make_pipeline, make_pipeline_median
from repro_torch.core.executor import run_exact
from repro_torch.serving import BiathlonServer
from repro_torch.configs import get_config
from repro_torch.core import guarantee, sobol_indices
from repro_torch.examples import quickstart, serve_pipelines
from repro_torch.examples import serve_lm_head as ex
from repro_torch.models.tabular import LogisticRegression
small = dict(rows_per_group=300, n_train_groups=60, n_serve_groups=3, n_requests=1,
             device="cpu")
cfg = BiathlonConfig(m=64, m_sobol=16)
served, summaries = {{}}, {{}}
bundles = [make_pipeline(name, **small) for name in PIPELINE_NAMES]
bundles.append(make_pipeline_median("trip_fare", **small))
for b in bundles:
    served[b.pipeline.name] = BiathlonServer(b, cfg, device="cpu").serve(b.requests[0])["y_hat"]
    host = BiathlonServer(b, cfg, mode="host", device="cpu")
    summaries[b.pipeline.name] = host.serve_all(compare_exact=True).summary(
        b.pipeline.delta_default, b.pipeline.task)
tiny = dict(rows_per_group=300, n_train_groups=60, n_serve_groups=2, n_requests=2)
quickstart.run("cpu", tiny, cfg)
serve_pipelines.run("cpu", tiny, cfg, names=("turbofan", "sensor_health"))
LogisticRegression(n_steps=2, device="cpu").fit([[0.0], [1.0]], [0.0, 1.0])
sc = ex.build(get_config("qwen1.5-0.5b").reduced(), "cpu", n_users=2, n_events=500)
lm = ex.serve(sc, ex.make_executor(sc, m=32, m_sobol=8), ex.draw_requests(sc, 1))[0]
b = bundles[0]
cached = BiathlonServer(b, cfg, cache_size=4, device="cpu")
req = b.requests[0]
first = cached.serve(req)["y_hat"]
f = b.pipeline.agg_features[0]
t = b.store[f.table]
g = req[f.group_field]
start = int(t.group_ptr[t.group_ids[g]])
t.append({{c: v[t.perm[start:start + 1]] for c, v in t.columns.items()}}, group_key=[g])
again = cached.serve(req)["y_hat"]
from repro_torch.serving import runtime, continuous, degrade, faults
from repro_torch.launch import serve as launch_serve
from repro_torch.data.synthetic import poisson_arrivals
tight = BiathlonConfig(m=64, m_sobol=16, delta=0.1 * b.pipeline.delta_default)
lanes = continuous.ContinuousBatchedServer(b, tight, batch_size=2, chunk_iters=2, device="cpu")
runtime.ContinuousServingRuntime(lanes).warmup(b.requests)
storm = faults.FaultyContinuousServer(lanes, faults.FaultProfile(
    seed=1, chunk_fail_calls=(0,), refill_fail_calls=(1,)))
ctl = degrade.DegradationController(degrade.default_tiers(cfg.tau, cfg.max_iters),
                                    service_est_s=0.01, lanes=2)
trace = runtime.ContinuousServingRuntime(storm, slo_s=60.0, controller=ctl).run(
    poisson_arrivals(b.requests, 100.0, n=4, seed=0), warmup=False).summary()
import repro_torch.analysis.check, repro_torch.analysis.mutations
from repro_torch.analysis import contracts, program_lint
from repro_torch.launch.mesh import make_serving_mesh, simulated_devices
from repro_torch.serving import BatchedFusedServer
sharded = BatchedFusedServer(b, cfg, batch_size=2, mesh=make_serving_mesh(
    devices=simulated_devices(2, "cpu"))).serve_batch(b.requests[:2])
from repro_torch.launch import train as launch_train
from repro_torch.examples import train_lm
from repro_torch.optim import compress
from repro_torch.checkpoint import CheckpointManager
trained = launch_train.main(["--arch", "qwen1.5-0.5b", "--steps", "2", "--batch", "1", "--seq",
                             "8", "--device", "cpu", "--ckpt", {ckpt!r}, "--save-every", "1"])
from repro_torch.launch import cost, dryrun
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models.lm import LM, collectives, sharding
tp_cfg = get_config("qwen1.5-0.5b").reduced()
tp_lm = LM(tp_cfg, loss_chunk=8)
tp_rules = sharding.ShardingRules(make_lm_mesh((2, 2), devices=simulated_devices(4, "cpu")),
                                  tp_cfg)
with sharding.use_rules(tp_rules):
    tp_loss = float(tp_lm.train_loss(sharding.shard_params(tp_rules, tp_lm.init(
        torch.Generator().manual_seed(0))), {{"tokens": torch.randint(0, 512, (2, 9))}})[0])
dry = dryrun.run_cell("qwen1.5-0.5b", "prefill_32k", False, {ckpt!r} + "_dryrun", reduced=True)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(json.dumps({{"bad": bad, "served": served, "summaries": summaries,
                  "lm_y_hat": lm["y_hat"], "cached": [first, again],
                  "cache": cached.cache.stats, "continuous": trace,
                  "launch": launch_serve.__name__, "sharded": int(sharded.n_devices),
                  "contracts": sorted(contracts.all_contracts()),
                  "trained": [h["loss"] for h in trained],
                  "ckpt_steps": CheckpointManager({ckpt!r}).steps(), "tp_loss": tp_loss,
                  "dryrun": dry["status"]}}))
"""


def test_port_imports_and_serves_without_jax(tmp_path):
    """A fresh interpreter imports the port and serves on the CPU (a request
    of each of the eight pipelines and of ``trip_fare_median``, the linear,
    logistic and MLP models among them, through the fused executor, and the
    request log of each through the host loop with the exact baseline; the
    two ported examples at a tiny scale; an LM-head request; a request through
    the feature cache, an append into its group and the request again, which
    refreshes the cached entry; a tiny trace through the continuous runtime
    with a chunk failure and the degradation controller; the serve launcher
    imported; the contract checker and its mutations imported; a batch over 2
    shards simulated on the CPU; two reduced qwen1.5-0.5b training steps
    through the training launcher, each checkpointed, and the example trainer,
    compression and checkpoint modules imported; a reduced qwen1.5-0.5b
    loss tensor-parallel over a (2, 2) mesh of CPU shards, and a reduced
    dry-run cell traced on the meta device) with no ``jax`` and no
    ``repro.*`` module ever loaded."""
    code = _HYGIENE_SCRIPT.format(src=str(ROOT / "src"), ckpt=str(tmp_path / "ckpt"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert len(out["served"]) == len(out["summaries"]) == 9
    assert all(np.isfinite(y) for y in out["served"].values())
    for summary in out["summaries"].values():
        assert summary["n"] == 1 and summary["speedup"] > 0
        assert 0.0 <= summary["guarantee_rate"] <= 1.0
    assert np.isfinite(out["lm_y_hat"])
    assert np.isfinite(out["cached"]).all()
    assert out["cache"] == dict(hits=0, misses=1, refreshes=1, corruptions=0, entries=1)
    trace = out["continuous"]
    assert trace["n"] + trace["n_shed"] == 4 and trace["n_rollbacks"] == 1
    assert trace["n_retries"] == 2
    assert trace["compile_count"] == 0 and trace["n_chunks"] > 0
    assert out["launch"] == "repro_torch.launch.serve"
    assert out["sharded"] == 2
    assert {"fused", "sharded_lanes", "refill", "chunk"} <= set(out["contracts"])
    assert len(out["trained"]) == 2 and np.isfinite(out["trained"]).all()
    assert out["ckpt_steps"] == [1, 2]
    assert np.isfinite(out["tp_loss"]) and out["dryrun"] == "ok"


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
    for sub in ("configs", "models/lm", "models/tabular", "optim", "examples", "launch",
                "kernels/flash_attention", "kernels/sobol", "analysis", "train", "checkpoint"):
        assert sub in walked, sub
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f.relative_to(ROOT)} imports {mod}"


def test_server_defaults_to_cuda_and_raises_without_it(ref_bundle, monkeypatch):
    """No ``device=`` means CUDA; without a card that raises rather than
    running on the CPU, in either mode.  An unknown mode raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = bundle_from_numpy(bundle_to_numpy(ref_bundle))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        BiathlonServer(port)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        BiathlonServer(port, mode="host")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        run_exact(port.store, port.pipeline, port.requests[0])
    with pytest.raises(ValueError, match="mode must be"):
        BiathlonServer(port, mode="batched", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        ContinuousBatchedServer(port, BiathlonConfig(m=64, m_sobol=16))
