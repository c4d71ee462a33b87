"""The port's host-loop server against the JAX reference's on paper pipelines.

``BiathlonServer(mode="host")`` on both sides, at the sizes of
``torch_pipeline_parity`` (1200-row groups, ``m=192``, ``m_sobol=48``), the
reference's bundle handed to the port through the numpy bridge.  Plans and
iterations equal, y_hat within 1e-4·max(1, |y|) or the same class, prob
within 1e-4; the exact baseline's answers within the same y tolerance.
The estimators and executor pieces are held one by one in
``test_torch_host_loop.py``.
"""
import numpy as np
import pytest
from torch_pipeline_parity import QMC, bundles, serve_both
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)

from repro.core.executor import BiathlonConfig as RefConfig
from repro.serving import BiathlonServer as RefServer
from repro_torch.core.executor import BiathlonConfig, run_exact
from repro_torch.serving import BiathlonServer

KNOBS = {"batched": {}, "naive": dict(batch_afc=False), "adaptive": dict(adaptive_ami=True)}


@pytest.mark.parametrize("name,knobs,requests", [
    ("turbofan", "batched", None), ("sensor_health", "batched", (2, 3)),
    ("tick_price", "batched", None), ("fraud_detection", "batched", None),
    ("sensor_health", "naive", (3,)), ("sensor_health", "adaptive", (3,)),
])
def test_host_mode_serves_reference_plans(name, knobs, requests):
    """The pipeline's requests (sensor_health's 1- and 14-iteration ones:
    its others take 25-28) through both host-loop servers, at the tight
    setting (0.3·δ; τ = 0.995 for classification) so that requests
    iterate: plans, iterations, y_hat (or the class) and prob."""
    iters = serve_both(name, "auto", True, mode="host", requests=requests, **KNOBS[knobs])
    assert max(iters) > 1, "no request entered the planner loop"


@pytest.mark.parametrize("name", ["turbofan", "sensor_health", "fraud_detection"])
def test_run_exact_and_serve_all_match_reference(name):
    """``serve_all(compare_exact=True)`` in host mode: the exact answers
    and the errors against them are the reference's (the parity tolerance on
    y), and so are the summary's counts and rates."""
    ref, port = bundles(name)
    delta = ref.pipeline.delta_default
    rs = RefServer(ref, RefConfig(**QMC), mode="host")
    ps = BiathlonServer(port, BiathlonConfig(**QMC), mode="host", device="cpu")
    reqs = ref.requests[2:]  # sensor_health iterates 21 times on each of the first two
    a, b = rs.serve_all(reqs, seed=3), ps.serve_all(reqs, seed=3)
    tol = [1e-4 * max(1.0, abs(y)) for y in a.y_exacts]
    assert np.all(np.abs(np.subtract(a.y_exacts, b.y_exacts)) <= tol)
    assert np.all(np.abs(np.subtract(a.errors_vs_exact, b.errors_vs_exact)) <= np.multiply(tol, 2))
    assert a.iters == b.iters
    assert a.sample_fracs == b.sample_fracs
    for req, y in zip(reqs, b.y_exacts):
        assert run_exact(port.store, port.pipeline, req, device="cpu")[0] == y
    sa, sb = a.summary(delta, ref.pipeline.task), b.summary(delta, ref.pipeline.task)
    assert sa.keys() == sb.keys()
    for key in ("n", "mean_sample_frac", "mean_iters", "guarantee_rate"):
        assert sa[key] == sb[key], key
    assert sb["speedup"] > 0 and np.isfinite(sb["mean_exact_latency_s"])


def test_fused_max_cap_matches_reference():
    """``max_cap`` caps the fused per-request bucket (700 → 1024 columns of
    ~1200-row groups): the buffers and sizes are cut to the cap, the plans
    are the reference's."""
    ref, port = bundles("turbofan")
    cfg = dict(delta=ref.pipeline.delta_default * 0.3, **QMC)
    rs = RefServer(ref, RefConfig(**cfg), mode="fused", max_cap=700)
    ps = BiathlonServer(port, BiathlonConfig(**cfg), max_cap=700, device="cpu")
    for req in ref.requests:
        a, b = rs.serve(req), ps.serve(req)
        assert b["cap"] == 1024 and (b["n"] <= 1024).all()
        np.testing.assert_array_equal(np.asarray(a["n"]), b["n"])
        assert a["iters"] == b["iters"]
        np.testing.assert_array_equal(np.asarray(a["z"]), b["z"])
        assert abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(1.0, abs(a["y_hat"]))
        assert a["sample_frac"] == b["sample_frac"]
