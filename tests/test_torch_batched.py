"""The port's ``BatchedFusedServer`` against the JAX reference's, on the CPU.

Both servers (the reference's unsharded and uncached) serve the same
batches of the same bundle (the reference's, bridged to the port with its
trained models): ``turbofan`` (parametric, random forest), ``sensor_health``
(three holistic features, under "auto", which takes the incremental AFC
at these caps, and under "ref", the rescan) and ``fraud_detection`` (a
boosted classifier).  Groups of 1200-2000 rows put every batch in the 2048
cap bucket.  Batches of 1, 3 and ``batch_size`` requests (pad lanes
beside the first two), with per-lane knobs (δ, τ, iteration cap).  Plans
bitwise, iterations equal, ŷ within 1e-4·max(1, |y|) (float32 reductions
are ordered differently by XLA and PyTorch) or the same class, the Eq. 1
probability within 1e-4; ``batch_cap`` and ``straggler_report`` equal.
Each lane also equals the port's own one-lane run of its request at the
batch's cap (plans equal, ŷ within 1e-5·max(1, |y|), prob within 1e-5:
the batch's float32 reductions may round apart from one lane's).
"""
import functools

import numpy as np
import pytest
import torch
from serving_fixtures import SMALL_CFG, make_small_bundle
from test_torch_bridge import bundle_to_numpy

from repro.core.executor import BiathlonConfig as RefConfig
from repro.data.synthetic import make_pipeline as ref_make_pipeline
from repro.serving.batched import BatchedFusedServer as RefBatched
from repro.serving.batched import lane_request_inputs as ref_lane_request_inputs
from repro.serving.batched import straggler_report as ref_straggler_report
from repro.serving.degrade import LaneKnobs as RefLaneKnobs
from repro_torch.bridge import bundle_from_numpy
from repro_torch.core.executor import BiathlonConfig
from repro_torch.data.store import HostStaging
from repro_torch.serving import (
    BatchedFusedServer,
    LaneKnobs,
    device_fill,
    gather_lanes,
    sanitize_lane_inputs,
    straggler_report,
)

SIZES = dict(rows_per_group=1600, n_train_groups=100, n_serve_groups=8, n_requests=8)
QMC = dict(m=96, m_sobol=32)
LANES = 4
CASES = [("turbofan", "auto"), ("sensor_health", "auto"), ("sensor_health", "ref"),
         ("fraud_detection", "auto")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the port's many small CPU operators beside other
    test workers (see ``torch_pipeline_parity.one_torch_thread``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def bundles(name: str):
    ref = ref_make_pipeline(name, **SIZES)
    return ref, bundle_from_numpy(bundle_to_numpy(ref))


@functools.cache
def servers(name: str, afc_backend: str):
    ref, port = bundles(name)
    return (RefBatched(ref, RefConfig(**QMC), batch_size=LANES, afc_backend=afc_backend),
            BatchedFusedServer(port, BiathlonConfig(**QMC), batch_size=LANES,
                               afc_backend=afc_backend, device="cpu"))


def lane_knobs(pipeline, fill: int, cls=LaneKnobs):
    """Per-lane knobs of ``cls`` (the port's ``LaneKnobs``, or the
    reference's for its server): the defaults, a tight lane capped at 6
    iterations, a looser lane and a tight lane capped at 2 (tight: 0.3·δ for
    regression, τ = 0.995 for classification)."""
    d = pipeline.delta_default
    if pipeline.task == "classification":
        kn = [None, cls(d, 0.995, 6), cls(d, 0.9, 64), cls(d, 0.995, 2)]
    else:
        kn = [None, cls(0.3 * d, 0.95, 6), cls(2.0 * d, 0.9, 64), cls(0.3 * d, 0.95, 2)]
    return kn[:fill]


def assert_same_batch(a, b, classify: bool):
    np.testing.assert_array_equal(np.asarray(a.z), b.z)
    np.testing.assert_array_equal(np.asarray(a.iters), b.iters)
    ya, yb = np.asarray(a.y_hat), b.y_hat
    if classify:
        np.testing.assert_array_equal(ya, yb)
    else:
        assert (np.abs(ya - yb) <= 1e-4 * np.maximum(1.0, np.abs(ya))).all(), (ya, yb)
    assert (np.abs(np.asarray(a.prob) - b.prob) <= 1e-4).all()
    np.testing.assert_allclose(np.asarray(a.sample_frac), b.sample_frac, rtol=1e-6)
    assert (a.batch_iters, a.cap, a.lanes) == (b.batch_iters, b.cap, b.lanes)
    ra, rb = ref_straggler_report(a), straggler_report(b)
    assert set(ra) == set(rb)
    for key in ra:
        np.testing.assert_array_equal(np.asarray(ra[key]), np.asarray(rb[key]), err_msg=key)


@pytest.mark.parametrize("name,afc_backend", CASES)
def test_batches_match_reference_and_one_lane_runs(name, afc_backend):
    rs, ps = servers(name, afc_backend)
    ref, port = bundles(name)
    p = port.pipeline
    classify = p.task == "classification"
    iters = []
    for start, fill in ((0, 1), (1, 3), (4, LANES)):
        reqs = ref.requests[start:start + fill]
        knobs = lane_knobs(p, fill)
        assert rs.batch_cap(reqs) == ps.batch_cap(reqs) == 2048
        a = rs.serve_batch(reqs, knobs=lane_knobs(ref.pipeline, fill, RefLaneKnobs))
        b = ps.serve_batch(reqs, knobs=knobs)
        assert_same_batch(a, b, classify)
        assert np.isfinite(b.y_hat).all()
        if classify:
            assert set(b.y_hat.tolist()) <= {0.0, 1.0}
        iters += b.iters.tolist()
        # each lane is the port's own one-lane run of its request, on the
        # inputs serve_batch gathers (bitwise the reference's lane inputs)
        vals, ns, exacts = gather_lanes(p, port.store, reqs, b.cap, LANES, HostStaging("cpu"),
                                        policy="reject")
        assert not vals[fill:].any() and not ns[fill:].any()
        for i, req in enumerate(reqs):
            rv, rn, _, rx = ref_lane_request_inputs(ref.pipeline, ref.store, req, b.cap)
            np.testing.assert_array_equal(vals[i].numpy(), np.asarray(rv))
            np.testing.assert_array_equal(ns[i], np.asarray(rn))
            np.testing.assert_array_equal(exacts[i], np.asarray(rx))
            kn = knobs[i]
            one = ps._run(vals[i], torch.from_numpy(ns[i]), ps._agg_ids,
                          p.delta_default if kn is None else kn.delta,
                          torch.from_numpy(exacts[i]),
                          tau=None if kn is None else kn.tau,
                          iter_cap=None if kn is None else int(kn.iter_cap))
            assert one.iters == int(b.iters[i])
            np.testing.assert_array_equal(one.z.numpy(), b.z[i])
            y = float(one.y_hat)
            assert abs(y - float(b.y_hat[i])) <= 1e-5 * max(1.0, abs(y))
            assert abs(float(one.prob) - float(b.prob[i])) <= 1e-5
    assert max(iters) > 0, "no lane entered the planner loop"
    assert ps.compiled_buckets == [2048]
    assert ps.compile_count == 2         # the (4, 2048) batch slot and the (1, 2048) lane's


def test_compile_count_is_one_per_cap_bucket_whatever_the_fill_and_knobs():
    """The reference's tests/test_degradation.py contract: fills and knobs
    build nothing; a new cap bucket builds one slot."""
    port = bundle_from_numpy(bundle_to_numpy(make_small_bundle()))
    cfg = BiathlonConfig(m=SMALL_CFG.m, m_sobol=SMALL_CFG.m_sobol)
    srv = BatchedFusedServer(port, cfg, batch_size=4, device="cpu")
    srv.serve_batch([{"g": 0}])
    assert srv.compile_count == len(srv.compiled_buckets) == 1
    for kn in (LaneKnobs(0.5, 0.95, 32), LaneKnobs(0.75, 0.92, 16), LaneKnobs(2.0, 0.8, 1)):
        srv.serve_batch([{"g": 0}, {"g": 1}], knobs=[kn, None])
        srv.serve_batch([{"g": g} for g in range(4)], knobs=[None, kn, kn, None])
    assert srv.compile_count == len(srv.compiled_buckets) == 1
    res = srv.serve_batch([{"g": 8}, {"g": 2}])
    assert res.cap == 1024 and srv.compiled_buckets == [128, 1024]
    assert srv.compile_count == 2
    inactive = srv._run(torch.zeros((4, 2, 128)), torch.full((4, 2), 120), srv._agg_ids,
                        0.0, torch.zeros((4, 0)), torch.tensor([True, False, False, False]),
                        None, None)
    assert inactive.iters.tolist()[1:] == [0, 0, 0]
    assert inactive.samples_used.tolist()[1:] == [0, 0, 0]


def test_batch_edges_and_options():
    port = bundle_from_numpy(bundle_to_numpy(make_small_bundle()))
    cfg = BiathlonConfig(m=SMALL_CFG.m, m_sobol=SMALL_CFG.m_sobol)
    srv = BatchedFusedServer(port, cfg, batch_size=2, max_cap=256, device="cpu")
    empty = srv.serve_batch([])
    assert empty.cap == 0 and empty.z.shape == (0, 2)
    assert straggler_report(empty)["straggler"] == -1
    with pytest.raises(ValueError, match="exceeds the fixed lane count"):
        srv.serve_batch([{"g": 0}] * 3)
    big = srv.serve_batch([{"g": 9}])
    assert big.cap == 256 and big.sample_frac[0] <= 256 / 900 + 1e-6
    with pytest.raises(TypeError, match="make_serving_mesh"):
        BatchedFusedServer(port, cfg, mesh=object())
    vals = np.array([[1.0, np.nan]], np.float32)
    with pytest.raises(ValueError, match="non-finite"):
        sanitize_lane_inputs(vals, np.zeros(1), policy="reject", where="lane 0")
    clamped, _ = sanitize_lane_inputs(vals, np.zeros(1), policy="clamp", where="lane 0")
    assert clamped.tolist() == [[1.0, 0.0]]
    assert device_fill(3, 8, 1).tolist() == [3]
