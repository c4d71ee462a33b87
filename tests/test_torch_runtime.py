"""The port's arrival-driven runtime against the JAX reference's, on the CPU.

* ``AdmissionBatcher``: the max-wait / max-size policy and the epsilon that
  absorbs the virtual clock's round-off (the reference's livelock fix).
* ``poisson_arrivals``: traces bitwise the reference's, with its guards.
* ``ServingRuntime`` (fixed lanes over ``BatchedFusedServer``) and
  ``ContinuousServingRuntime`` (the lane table), each on the reference's
  runtime over the reference's server, on arrivals at t = 0 (so no decision
  depends on wall time): per-request dispositions, plans, iterations and
  lanes equal, ŷ within 1e-4·max(1, |y|) and prob within 1e-4; the timing
  fields differ, but ``RuntimeStats.summary()`` has the same keys.
* Deadlines and the degradation controller: infeasible requests are shed,
  generous ones served, and every tier builds nothing.
"""
import functools
import math

import numpy as np
import pytest
import torch
from serving_fixtures import SMALL_CFG, make_small_bundle
from test_torch_bridge import bundle_to_numpy

from repro.data.synthetic import poisson_arrivals as ref_poisson_arrivals
from repro.serving import BatchedFusedServer as RefBatched
from repro.serving import ContinuousBatchedServer as RefContinuous
from repro.serving import ContinuousServingRuntime as RefContinuousRuntime
from repro.serving import ServingRuntime as RefRuntime
from repro_torch.bridge import bundle_from_numpy
from repro_torch.core.executor import BiathlonConfig
from repro_torch.data.synthetic import poisson_arrivals
from repro_torch.serving import (
    AdmissionBatcher,
    BatchedFusedServer,
    ContinuousBatchedServer,
    ContinuousServingRuntime,
    DegradationController,
    RuntimeStats,
    ServingRuntime,
    default_tiers,
)

CFG = BiathlonConfig(m=SMALL_CFG.m, m_sobol=SMALL_CFG.m_sobol)
# t = 0 arrivals: two cap buckets (groups 8 and 9 have 900 rows)
ARRIVALS = [(0.0, {"g": g}) for g in (0, 3, 8, 1, 5, 9, 2, 7, 4, 6)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def bundles():
    ref = make_small_bundle()
    return ref, bundle_from_numpy(bundle_to_numpy(ref))


def assert_same_records(ref_stats, port_stats):
    a = sorted(ref_stats.records, key=lambda r: r.req_id)
    b = sorted(port_stats.records, key=lambda r: r.req_id)
    assert [r.req_id for r in a] == [r.req_id for r in b]
    for ra, rb in zip(a, b):
        for key in ("disposition", "iters", "lane", "batch_id", "batch_fill", "n_chunks", "z",
                    "tier"):
            assert getattr(ra, key) == getattr(rb, key), (ra.req_id, key)
        assert rb.sample_frac == pytest.approx(ra.sample_frac, rel=1e-6)
        if ra.disposition == "ok":
            assert abs(ra.y_hat - rb.y_hat) <= 1e-4 * max(1.0, abs(ra.y_hat))
            assert abs(ra.prob - rb.prob) <= 1e-4
    sa, sb = ref_stats.summary(), port_stats.summary()
    assert set(sa) == set(sb)
    for key in ("n", "n_batches", "n_offered", "n_shed", "n_failed", "n_retries",
                "n_rollbacks", "n_poisoned", "compile_count", "compiled_buckets", "max_tier",
                "n_chunks", "n_recycles"):
        assert sa.get(key) == sb.get(key), key
    for key in ("mean_batch_fill", "mean_sample_frac", "guarantee_rate", "lane_occupancy",
                "chunk_wasted_frac"):
        assert sb.get(key) == pytest.approx(sa.get(key), rel=1e-6), key


def test_admission_batcher_policy():
    b = AdmissionBatcher(max_size=4, max_wait_s=0.02)
    assert not b.ready(0, 0.0, more_coming=True)
    assert not b.ready(2, 0.001, more_coming=True)
    assert b.ready(4, 0.0, more_coming=True)
    assert b.ready(1, 0.02, more_coming=True)
    assert b.ready(1, 0.02 - 1e-12, more_coming=True)
    assert b.ready(1, 0.0, more_coming=False)
    with pytest.raises(ValueError):
        AdmissionBatcher(0, 0.01)
    with pytest.raises(ValueError):
        AdmissionBatcher(4, -1.0)


def test_admission_batcher_epsilon_absorbs_clock_round_off():
    t_oldest, max_wait = 0.7, 0.1
    wait = (t_oldest + max_wait) - t_oldest
    assert wait < max_wait, "precondition: the round-off bites here"
    b = AdmissionBatcher(max_size=8, max_wait_s=max_wait)
    assert b.ready(1, wait, more_coming=True)
    assert not b.ready(1, max_wait / 2, more_coming=True)


def test_poisson_arrivals_bitwise_the_reference():
    reqs = [{"g": g} for g in range(5)]
    for rate, n, seed, start in ((100.0, 50, 7, 0.0), (3.5, 17, 0, 2.25), (1e4, 3, 123, 0.0),
                                 (20.0, None, 1, 0.0)):
        a = ref_poisson_arrivals(reqs, rate, n=n, seed=seed, start_t=start)
        b = poisson_arrivals(reqs, rate, n=n, seed=seed, start_t=start)
        assert a == b
        assert [t for t, _ in b] == sorted(t for t, _ in b)
    for bad_rate in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="rate_rps"):
            poisson_arrivals(reqs, rate_rps=bad_rate, n=4)
    with pytest.raises(ValueError, match="n must"):
        poisson_arrivals(reqs, rate_rps=5.0, n=-1)
    assert poisson_arrivals(reqs, rate_rps=5.0, n=0) == []
    assert poisson_arrivals([], rate_rps=5.0, n=10) == []


@pytest.mark.parametrize("max_batch", [4, 2])
def test_fixed_lane_runtime_matches_reference(max_batch):
    ref, port = bundles()
    rs = RefRuntime(RefBatched(ref, SMALL_CFG, batch_size=4), max_wait_s=0.001,
                    max_batch=max_batch).run(ARRIVALS)
    ps = ServingRuntime(BatchedFusedServer(port, CFG, batch_size=4, device="cpu"),
                        max_wait_s=0.001, max_batch=max_batch).run(ARRIVALS)
    assert ps.compile_count == 0 and ps.compiled_buckets == [128, 1024]
    assert_same_records(rs, ps)
    for rec in ps.records:
        assert rec.queue_delay_s >= 0.0 and rec.exec_s > 0.0
        assert rec.latency_s == pytest.approx(rec.queue_delay_s + rec.done_t - rec.admit_t,
                                              abs=1e-9)
    assert ServingRuntime(BatchedFusedServer(port, CFG, batch_size=2, device="cpu")).run(
        []).summary()["n"] == 0
    with pytest.raises(ValueError):
        ServingRuntime(BatchedFusedServer(port, CFG, batch_size=2, device="cpu"), max_batch=3)


@pytest.mark.parametrize("lanes,chunk_iters", [(4, 2), (2, 3)])
def test_continuous_runtime_matches_reference(lanes, chunk_iters):
    ref, port = bundles()
    arrivals = ARRIVALS[:2] + ARRIVALS[3:5] + ARRIVALS[6:]   # one cap bucket: 128
    rs = RefContinuousRuntime(RefContinuous(ref, SMALL_CFG, batch_size=lanes,
                                            chunk_iters=chunk_iters)).run(arrivals)
    ps = ContinuousServingRuntime(ContinuousBatchedServer(
        port, CFG, batch_size=lanes, chunk_iters=chunk_iters, device="cpu")).run(arrivals)
    assert ps.n_chunks > 0 and ps.n_recycles > 0 and ps.compile_count == 0
    assert_same_records(rs, ps)
    s = ps.summary()
    assert 0.0 < s["lane_occupancy"] <= 1.0
    fixed = ServingRuntime(BatchedFusedServer(port, CFG, batch_size=2, device="cpu")).run(
        arrivals).summary()
    assert "n_chunks" not in fixed and "lane_occupancy" not in fixed
    assert ContinuousServingRuntime(ContinuousBatchedServer(
        port, CFG, batch_size=2, device="cpu")).run([]).summary()["n"] == 0


@pytest.mark.parametrize("continuous", [False, True], ids=["fixed", "continuous"])
def test_deadlines_shed_infeasible_and_serve_generous(continuous):
    """A budget below the loosest tier's floor sheds at admission; a
    generous one serves everything in time; no tier builds a slot."""
    _, port = bundles()
    srv = (ContinuousBatchedServer(port, CFG, batch_size=4, chunk_iters=2, device="cpu")
           if continuous else BatchedFusedServer(port, CFG, batch_size=4, device="cpu"))
    run = (lambda **kw: ContinuousServingRuntime(srv, **kw)) if continuous else (
        lambda **kw: ServingRuntime(srv, max_wait_s=0.001, **kw))
    arrivals = poisson_arrivals(port.requests[:8], 500.0, n=12, seed=9)
    ctl = DegradationController(default_tiers(CFG.tau, CFG.max_iters), service_est_s=0.05,
                                lanes=4, ewma_alpha=1e-6)
    stats = run(slo_s=0.01, controller=ctl).run(arrivals)
    s = stats.summary()
    assert stats.n_shed > 0 and s["n_offered"] == 12
    assert s["shed_rate"] == pytest.approx(stats.n_shed / 12)
    for r in stats.records:
        if r.disposition == "shed":
            assert math.isnan(r.y_hat) and r.batch_id == -1 and not r.deadline_met
        else:
            assert r.tau is not None and r.delta is not None
    assert stats.compile_count == 0
    ctl = DegradationController(default_tiers(CFG.tau, CFG.max_iters), service_est_s=0.005,
                                lanes=4)
    stats = run(slo_s=60.0, controller=ctl).run(arrivals[:10])
    assert stats.n_shed == 0 and stats.summary()["n"] == 10
    assert stats.summary()["deadline_met_rate"] == 1.0
    assert stats.compile_count == 0


def test_runtime_stats_summary_keys_and_tau():
    with pytest.raises(TypeError):
        RuntimeStats()
    empty = RuntimeStats(tau=0.95).summary()
    assert empty["n"] == 0 and math.isnan(empty["p50_latency_ms"])
    assert "n_chunks" not in empty
    assert np.isnan(empty["deadline_met_rate"])
