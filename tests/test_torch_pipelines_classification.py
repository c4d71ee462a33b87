"""The port's classification pipelines against the JAX reference's, on the CPU.

``bearing_imbalance`` (MLP), ``fraud_detection`` (gradient boosting) and
``student_qa`` (random forest, 21 aggregates) through the fused
executor's classification branches: the guarantee probability is the AMI
rows' frequency of ŷ's class (a bincount over ``n_classes``), the Sobol
indices are those of the indicator ``f == ŷ``.  The port's
``make_pipeline`` must build the reference's store, trees and scaler bit
for bit; the served plans and classes must equal the reference's under
"ref" and "incremental", at τ = 0.95 and at τ = 0.995 (see
``torch_pipeline_parity``).
"""
import numpy as np
import pytest
import torch
from torch_pipeline_parity import (
    assert_same_store_and_data,
    assert_same_trees,
    bundles,
    one_torch_thread,  # noqa: F401  (autouse)
    port_bundle,
    serve_both,
)

from repro.core.executor_fused import build_fused_executor as ref_build_fused_executor
from repro.models.tabular.linear import LogisticRegression as RefLogisticRegression
from repro_torch.bridge import model_from_numpy
from repro_torch.core.executor_fused import build_fused_executor
from repro_torch.models.tabular.linear import LogisticRegression
from repro_torch.models.tabular.mlp import MLP

NAMES = ("bearing_imbalance", "fraud_detection", "student_qa")


@pytest.mark.parametrize("name", NAMES)
def test_port_make_pipeline_builds_the_reference_bundle(name):
    ref, _ = bundles(name)
    port = port_bundle(name)
    assert_same_store_and_data(ref, port)
    assert port.pipeline.n_classes == 2
    rm, pm = ref.pipeline.model, port.pipeline.model
    if name == "bearing_imbalance":
        # 100 training rows are fewer than one 512-row batch, so neither
        # side takes a step: both serve the seeded initial weights, which
        # the port's threefry draws bit for bit
        assert isinstance(pm, MLP)
        for a, b in zip(rm.params, pm.params):
            for key in ("w", "b"):
                assert (np.asarray(a[key]) == b[key].numpy()).all(), key
    else:
        assert_same_trees(rm, pm)


@pytest.mark.parametrize("tight", [False, True], ids=["tau95", "tau995"])
@pytest.mark.parametrize("afc_backend", ["ref", "incremental"])
@pytest.mark.parametrize("name", NAMES)
def test_served_plans_match_reference(name, afc_backend, tight):
    iters = serve_both(name, afc_backend, tight)
    if tight:
        assert max(iters) > 0, "no request entered the planner loop"


def test_classification_executor_matches_reference_on_a_toy_model():
    """Both executors on one (k, cap) input with a threshold classifier:
    the class, its AMI frequency and the plan are equal at every step."""
    k, cap = 3, 256
    rng = np.random.default_rng(5)
    vals = rng.normal(0.0, 1.0, (k, cap)).astype(np.float32)
    n = np.array([256, 200, 150], np.int32)
    agg = np.zeros(k, np.int32)
    kw = dict(k=k, task="classification", n_classes=2, m=64, m_sobol=16, tau=0.999,
              max_iters=6)
    ref_run = ref_build_fused_executor(
        lambda rows, exact: (rows[:, 0] + 0.5 * rows[:, 1] > 0.02).astype("int32"), **kw)
    run = build_fused_executor(
        lambda rows, exact: (rows[:, 0] + 0.5 * rows[:, 1] > 0.02).to(torch.int32),
        device="cpu", **kw)
    a = ref_run(vals, n, agg, 0.0, np.zeros(0, np.float32))
    b = run(torch.from_numpy(vals), torch.from_numpy(n), torch.from_numpy(agg), 0.0,
            torch.zeros(0))
    assert int(a.iters) == b.iters > 0
    np.testing.assert_array_equal(np.asarray(a.z), b.z.numpy())
    assert float(a.y_hat) == float(b.y_hat)
    assert abs(float(a.prob) - float(b.prob)) <= 1e-6


def test_logistic_regression_fit_matches_reference():
    """300 float32 gradient steps on both sides: weights within 1e-4 +
    1e-4·|w| (reductions ordered differently by XLA and PyTorch), the same
    classes on the training rows; the reference's weights, bridged, give
    its logits to float32 rounding."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 6)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + rng.normal(0, 0.5, 500) > 0).astype(np.float32)
    ref = RefLogisticRegression().fit(X, y)
    port = LogisticRegression(device="cpu").fit(X, y)
    np.testing.assert_allclose(port.coef, ref.coef, rtol=1e-4, atol=1e-4)
    assert abs(port.intercept - ref.intercept) <= 1e-4 * max(1.0, abs(ref.intercept))
    x = torch.from_numpy(X)
    assert (port.predict(x).numpy() == np.asarray(ref.predict(X))).mean() >= 0.99
    bridged = model_from_numpy({"kind": "logistic", "task": "classification",
                                "coef": np.asarray(ref.coef), "intercept": ref.intercept})
    np.testing.assert_allclose(bridged.predict_logit(x).numpy(),
                               np.asarray(ref.predict_logit(X)), rtol=1e-5, atol=1e-5)
