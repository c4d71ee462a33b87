"""The PyTorch port's fused ``turbofan`` server vs the JAX reference's.

Both servers run on the CPU on the same store and trees (handed to the port
through the numpy bridge).  Parametric z-plans and iteration counts must be
equal; y_hat within 1e-4·max(1, |y|) and the Eq. 1 probability within 1e-4
(float32 reductions are ordered differently by XLA and PyTorch).  The port's
own ``make_pipeline`` must build the reference's store and trees bit for bit.
"""
import numpy as np
import pytest
import torch
from test_torch_bridge import bundle_to_numpy

from repro.core.executor import BiathlonConfig as RefConfig
from repro.data.synthetic import make_pipeline as ref_make_pipeline
from repro.serving import BiathlonServer as RefServer
from repro_torch.bridge import bundle_from_numpy
from repro_torch.core.executor import BiathlonConfig
from repro_torch.core.executor_fused import build_fused_executor, fused_rows_per_iteration
from repro_torch.data.synthetic import make_pipeline
from repro_torch.serving import BiathlonServer

SMALL = dict(rows_per_group=1200, n_train_groups=100, n_serve_groups=5, n_requests=4)
QMC = dict(m=192, m_sobol=48)


@pytest.fixture(scope="module")
def bundles():
    ref = ref_make_pipeline("turbofan", **SMALL)
    return ref, bundle_from_numpy(bundle_to_numpy(ref))


def _assert_same_serving(a, b):
    assert a["iters"] == b["iters"]
    np.testing.assert_array_equal(np.asarray(a["z"]), np.asarray(b["z"]))
    assert abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(1.0, abs(a["y_hat"]))
    assert abs(a["prob"] - b["prob"]) <= 1e-4


@pytest.mark.parametrize("afc_backend", ["ref", "incremental"])
@pytest.mark.parametrize("delta_frac", [1.0, 0.3])
def test_fused_server_matches_reference(bundles, afc_backend, delta_frac):
    """``delta_frac=0.3`` tightens δ so requests iterate (up to ~20 steps)."""
    ref, port = bundles
    delta = ref.pipeline.delta_default * delta_frac
    rs = RefServer(ref, RefConfig(delta=delta, **QMC), mode="fused", afc_backend=afc_backend)
    ps = BiathlonServer(port, BiathlonConfig(delta=delta, **QMC), afc_backend=afc_backend,
                        device="cpu")
    iters = []
    for req in ref.requests:
        a, b = rs.serve(req), ps.serve(req)
        _assert_same_serving(a, b)
        assert np.isfinite(b["y_hat"])
        assert b["prob"] >= 0.95 or (b["z"] == b["n"]).all() or b["iters"] == 64
        iters.append(b["iters"])
    if delta_frac < 1.0:
        assert max(iters) > 1


def test_port_make_pipeline_builds_the_reference_bundle(bundles):
    ref, _ = bundles
    port = make_pipeline("turbofan", device="cpu", **SMALL)
    rt, pt = ref.store["sensors"], port.store["sensors"]
    assert (np.asarray(rt.perm) == pt.perm).all()
    assert (np.asarray(rt.group_ptr) == pt.group_ptr).all()
    for c in rt.columns:
        assert rt.columns[c].dtype == pt.columns[c].dtype
        assert (rt.columns[c] == pt.columns[c]).all(), c
    re_, pe = ref.pipeline.model.ensemble, port.pipeline.model.ensemble
    for a in ("feature", "threshold", "left", "right", "value"):
        assert (np.asarray(getattr(re_, a)) == getattr(pe, a).numpy()).all(), a
    assert port.pipeline.model.base == ref.pipeline.model.base
    assert (port.pipeline.scaler_mean == ref.pipeline.scaler_mean).all()
    assert (port.pipeline.scaler_scale == ref.pipeline.scaler_scale).all()
    assert port.requests == ref.requests
    assert (port.labels == ref.labels).all()
    d_ref, d_port = ref.pipeline.delta_default, port.pipeline.delta_default
    assert abs(d_port - d_ref) <= 1e-5 * abs(d_ref)


def test_executor_calls_the_model_once_per_iteration(bundles):
    """z⁰: AMI rows then (only when the loop is entered) the Saltelli block;
    every iteration after that is ONE megabatch call.  An exact-only
    feature (``approximate=False``) starts at z = n and never moves."""
    _, port = bundles
    k = port.pipeline.k
    calls = []

    def model_fn(rows, exact):
        calls.append(rows.shape[0])
        return rows[:, 0] * 0.0 + torch.sin(rows.sum(1))

    run = build_fused_executor(model_fn, k=k, task="regression", m=64, m_sobol=16,
                               max_iters=3, tau=1.1, device="cpu",
                               approximate=(False,) + (True,) * (k - 1))
    vals = torch.from_numpy(np.random.default_rng(0).normal(size=(k, 256)).astype(np.float32))
    n = torch.full((k,), 256, dtype=torch.int32)
    agg = torch.zeros((k,), dtype=torch.int32)
    res = run(vals, n, agg, 0.01, torch.zeros(0))
    per_iter = fused_rows_per_iteration(k, 64, 16)
    assert res.iters == 3
    assert calls == [64 + 1, (k + 2) * 16] + [per_iter] * 3
    assert int(res.z[0]) == 256 and (res.z[1:] < 256).all()
    assert int(res.samples_used) == int(res.z.sum())
