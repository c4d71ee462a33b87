"""Shared parity harness of the ``test_torch_pipelines_*`` files.

The JAX reference and the PyTorch port serve the same requests of one of
the paper's pipelines on the CPU, at the size of ``test_torch_fused.py``
(``rows_per_group=1200``, 100 training and 5 serving groups, 4 requests;
``m=192``, ``m_sobol=48``).  The port serves the reference's bundle handed
over through the numpy bridge, trained weights included, so the two run
the same store and the same model.  Tolerances: y_hat within
1e-4·max(1, |y|) (float32 reductions are ordered differently by XLA and
PyTorch), an equal class for classification, the Eq. 1 probability within
1e-4; plans and iteration counts equal.  Both executors are held so: the
fused one and the host loop (``mode="host"``).
"""
import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_bridge import bundle_to_numpy

from repro.core.executor import BiathlonConfig as RefConfig
from repro.data.synthetic import make_pipeline as ref_make_pipeline
from repro.data.synthetic import make_pipeline_median as ref_make_pipeline_median
from repro.serving import BiathlonServer as RefServer
from repro_torch.bridge import bundle_from_numpy
from repro_torch.core import threefry
from repro_torch.core.executor import BiathlonConfig
from repro_torch.data.synthetic import make_pipeline, make_pipeline_median
from repro_torch.serving import BiathlonServer

SMALL = dict(rows_per_group=1200, n_train_groups=100, n_serve_groups=5, n_requests=4)
QMC = dict(m=192, m_sobol=48)
# the tight setting, where requests enter the planner loop: 0.3·δ for
# regression; for classification τ = 0.995, since at m = 192 the 0.99 of
# the card run is met by 191 of 192 AMI rows and no request here iterates
TIGHT_DELTA, TIGHT_TAU = 0.3, 0.995


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU operators on one thread while a module of these tests
    runs.  Under several test workers on one machine, each worker's torch
    intra-op threads oversubscribe the cores, and the many small operators
    of a served request then run an order of magnitude slower.  The
    tolerances are the same."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _makers(name: str):
    if name.endswith("_median"):
        return ref_make_pipeline_median, make_pipeline_median, name[: -len("_median")]
    return ref_make_pipeline, make_pipeline, name


@functools.cache
def bundles(name: str):
    """``(reference bundle, the port's copy of it through the bridge)``;
    ``name`` may end in ``_median`` (the appendix-D variant)."""
    ref_make, _, base = _makers(name)
    ref = ref_make(base, **SMALL)
    return ref, bundle_from_numpy(bundle_to_numpy(ref))


def port_bundle(name: str):
    """The port's own ``make_pipeline`` (or ``make_pipeline_median``) bundle."""
    _, port_make, base = _makers(name)
    return port_make(base, device="cpu", **SMALL)


def assert_same_store_and_data(ref, port):
    """Store, scaler, requests and labels bit for bit; δ to 1e-5."""
    assert set(ref.store.tables) == set(port.store.tables)
    for tname, rt in ref.store.tables.items():
        pt = port.store[tname]
        assert (np.asarray(rt.perm) == pt.perm).all()
        assert (np.asarray(rt.group_ptr) == pt.group_ptr).all()
        assert set(rt.columns) == set(pt.columns)
        for c in rt.columns:
            assert rt.columns[c].dtype == pt.columns[c].dtype
            assert (rt.columns[c] == pt.columns[c]).all(), c
    rp, pp = ref.pipeline, port.pipeline
    assert pp.name == rp.name and pp.task == rp.task and pp.n_classes == rp.n_classes
    assert [(f.agg, f.column, f.quantile) for f in pp.agg_features] == [
        (f.agg, f.column, f.quantile) for f in rp.agg_features]
    assert [f.request_field for f in pp.exact_features] == [
        f.request_field for f in rp.exact_features]
    assert (pp.scaler_mean == rp.scaler_mean).all()
    assert (pp.scaler_scale == rp.scaler_scale).all()
    assert port.requests == ref.requests
    assert (port.labels == ref.labels).all()
    d_ref, d_port = rp.delta_default, pp.delta_default
    assert abs(d_port - d_ref) <= 1e-5 * abs(d_ref)


def assert_same_trees(ref_model, port_model):
    re_, pe = ref_model.ensemble, port_model.ensemble
    for a in ("feature", "threshold", "left", "right", "value"):
        assert (np.asarray(getattr(re_, a)) == getattr(pe, a).numpy()).all(), a
    assert port_model.base == ref_model.base


def configs(pipeline, tight: bool, **knobs):
    """``(reference config, port config)`` at δ or at the tight setting."""
    delta, tau = pipeline.delta_default, 0.95
    if tight and pipeline.task == "classification":
        tau = TIGHT_TAU
    elif tight:
        delta *= TIGHT_DELTA
    return (RefConfig(delta=delta, tau=tau, **QMC, **knobs),
            BiathlonConfig(delta=delta, tau=tau, **QMC, **knobs))


def serve_both(name: str, afc_backend: str, tight: bool, mode: str = "fused",
               requests=None, **knobs) -> list[int]:
    """Serve the requests of ``name`` (all, or those at the indices
    ``requests``) on both sides; assert equal plans and outputs; returns the
    iteration counts.  ``mode="host"`` serves through the host-loop
    executors, request i under the key ``PRNGKey(i)`` on both sides;
    ``knobs`` (``batch_afc``, ``adaptive_ami``) go to both configs."""
    ref, port = bundles(name)
    rc, pc = configs(ref.pipeline, tight, **knobs)
    rs = RefServer(ref, rc, mode=mode, afc_backend=afc_backend)
    ps = BiathlonServer(port, pc, mode=mode, afc_backend=afc_backend, device="cpu")
    classify = ref.pipeline.task == "classification"
    iters = []
    for i in range(len(ref.requests)) if requests is None else requests:
        req = ref.requests[i]
        a = rs.serve(req, jax.random.PRNGKey(i))
        b = ps.serve(req, threefry.PRNGKey(i))
        assert a["iters"] == b["iters"]
        np.testing.assert_array_equal(np.asarray(a["z"]), np.asarray(b["z"]))
        if classify:
            assert a["y_hat"] == b["y_hat"] and b["y_hat"] in (0.0, 1.0)
        else:
            assert abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(1.0, abs(a["y_hat"]))
        assert abs(a["prob"] - b["prob"]) <= 1e-4
        assert np.isfinite(b["y_hat"])
        assert b["prob"] >= pc.tau or (b["z"] == b["n"]).all() or b["iters"] == pc.max_iters
        iters.append(b["iters"])
    return iters
