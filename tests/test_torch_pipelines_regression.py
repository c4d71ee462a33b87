"""The port's regression pipelines against the JAX reference's, on the CPU.

``trip_fare`` (gradient boosting), ``tick_price`` (linear regression),
``battery`` (gradient boosting) and the appendix-D variant
``make_pipeline_median("trip_fare")`` (its two AVGs as MEDIANs, served
through the holistic path).  The port's ``make_pipeline`` must build the
reference's store, trees, linear coefficients and scaler bit for bit; the
served plans must equal the reference's under "ref" and "incremental", at
δ and at 0.3·δ (see ``torch_pipeline_parity`` for the tolerances).
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

from repro_torch.models.tabular.linear import LinearRegression

NAMES = ("trip_fare", "tick_price", "battery", "trip_fare_median")


@pytest.mark.parametrize("name", NAMES)
def test_port_make_pipeline_builds_the_reference_bundle(name):
    ref, _ = bundles(name)
    port = port_bundle(name)
    assert_same_store_and_data(ref, port)
    rm, pm = ref.pipeline.model, port.pipeline.model
    if name == "tick_price":
        assert isinstance(pm, LinearRegression)
        assert pm.coef.dtype == rm.coef.dtype and (pm.coef == rm.coef).all()
        assert pm.intercept == rm.intercept
    else:
        assert_same_trees(rm, pm)
    if name.endswith("_median"):
        assert [f.agg for f in port.pipeline.agg_features] == ["count", "median", "median"]


@pytest.mark.parametrize("tight", [False, True], ids=["delta", "tight"])
@pytest.mark.parametrize("afc_backend", ["ref", "incremental"])
@pytest.mark.parametrize("name", NAMES)
def test_served_plans_match_reference(name, afc_backend, tight):
    iters = serve_both(name, afc_backend, tight)
    if tight:
        assert max(iters) > 0, "no request entered the planner loop"


def test_linear_regression_predicts_as_the_reference():
    """The port's product on the reference's coefficients, to float32
    rounding (1e-5 relative: a dot product of 12 terms ordered differently)."""
    ref, port = bundles("tick_price")
    x = np.random.default_rng(3).normal(size=(257, 7)).astype(np.float32)
    want = np.asarray(ref.pipeline.model.predict(x))
    got = port.pipeline.model.predict(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
