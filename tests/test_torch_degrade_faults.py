"""The port's degradation controller and fault harness against the JAX
reference's, and the lane table's recovery, on the CPU.

* ``DegradationController``: ``pressure``, ``tier_for``, ``should_shed``,
  ``knobs_for`` and ``retier`` equal the reference's on a grid of (slack,
  queue depth), and the EWMA estimate and hysteretic load tier equal it
  along a sequence of observations; ``validate_tiers`` refuses the same
  ladders.
* ``FaultProfile`` schedules (every stream, the poisoned lane) and
  ``inject_burst`` bitwise the reference's over seeds and calls.
* ``FaultyServer``: a transient failure is retried with virtual backoff;
  exhausted retries fail the batch.
* The lane table: a chunk failure rolls back to its checkpoint and replays
  bitwise; a poisoned lane is quarantined alone, and re-admitting it
  recovers bitwise; a fault storm replays identically and gives the
  reference's events and dispositions on the same trace, with no new slot;
  ``corrupt_cache_entry`` is caught by the cache's checksum.
"""
import functools
import itertools

import numpy as np
import pytest
import torch
from serving_fixtures import SMALL_CFG, make_small_bundle
from test_torch_bridge import bundle_to_numpy

from repro.serving import ContinuousBatchedServer as RefContinuous
from repro.serving import ContinuousServingRuntime as RefContinuousRuntime
from repro.serving import DegradationController as RefController
from repro.serving import FaultProfile as RefProfile
from repro.serving import FaultyContinuousServer as RefFaultyContinuous
from repro.serving import KnobTier as RefKnobTier
from repro.serving import default_tiers as ref_default_tiers
from repro.serving import inject_burst as ref_inject_burst
from repro.serving import validate_tiers as ref_validate_tiers
from repro_torch.bridge import bundle_from_numpy
from repro_torch.core.executor import BiathlonConfig
from repro_torch.serving import (
    BatchedFusedServer,
    ChunkDispatchError,
    ContinuousBatchedServer,
    ContinuousServingRuntime,
    DegradationController,
    FaultProfile,
    FaultyContinuousServer,
    FaultyServer,
    KnobTier,
    LaneKnobs,
    ServingRuntime,
    TransientExecutorError,
    corrupt_cache_entry,
    default_tiers,
    inject_burst,
    validate_tiers,
)

CFG = BiathlonConfig(m=SMALL_CFG.m, m_sobol=SMALL_CFG.m_sobol)
ARRIVALS = [(0.0, {"g": g}) for g in range(6)]
STORM = dict(seed=11, chunk_fail_prob=0.25, refill_fail_prob=0.15, poison_prob=0.2)


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


@functools.cache
def cont4():
    """The port's lane table, warmed first, so fault call indices start at
    0 on measured traffic and a fault run must build nothing."""
    srv = ContinuousBatchedServer(bundles()[1], CFG, batch_size=4, chunk_iters=2, device="cpu")
    ContinuousServingRuntime(srv).warmup([a[1] for a in ARRIVALS])
    return srv


@functools.cache
def ref_cont4():
    srv = RefContinuous(bundles()[0], SMALL_CFG, batch_size=4, chunk_iters=2)
    RefContinuousRuntime(srv).warmup([a[1] for a in ARRIVALS])
    return srv


def run(server, runtime=ContinuousServingRuntime, **kw):
    return runtime(server, backoff_s=0.001, **kw).run(ARRIVALS, warmup=False)


def z_by_req(stats):
    return {r.req_id: r.z for r in stats.records if r.disposition == "ok"}


# ----------------------------------------------------------- the controller
def controllers(**kw):
    return (RefController(ref_default_tiers(0.95, 32), **kw),
            DegradationController(default_tiers(0.95, 32), **kw))


@pytest.mark.parametrize("kw", [dict(service_est_s=0.01, lanes=4),
                                dict(service_est_s=0.2, lanes=8, max_queue=10,
                                     floor_speedup=0.25),
                                dict(service_est_s=0.003, lanes=2,
                                     pressure_thresholds=(0.1, 1.0, 7.5))])
def test_controller_decisions_equal_the_reference(kw):
    a, b = controllers(**kw)
    slacks = [None, -0.1, 0.0, 1e-6, 0.001, 0.004, 0.01, 0.05, 0.2, 1.0, 30.0]
    for slack, depth in itertools.product(slacks, (0, 1, 3, 8, 17, 64)):
        assert b.tier_for(slack, depth) == a.tier_for(slack, depth)
        assert b.should_shed(slack, depth) == a.should_shed(slack, depth)
        if slack is not None:
            assert b.pressure(slack, depth) == a.pressure(slack, depth)
        ka, kb = a.retier(slack, depth, 0.7), b.retier(slack, depth, 0.7)
        assert (ka.delta, ka.tau, ka.iter_cap, ka.tier) == (kb.delta, kb.tau, kb.iter_cap,
                                                            kb.tier)
    # the EWMA and the hysteretic load tier along a service-time sequence
    rng = np.random.default_rng(3)
    for t, depth in zip(rng.exponential(0.02, 60), rng.integers(0, 40, 60)):
        a.observe(float(t), int(depth))
        b.observe(float(t), int(depth))
        assert (b.service_est_s, b.load_tier, b.min_service_s) == (
            a.service_est_s, a.load_tier, a.min_service_s)
        assert b.tier_for(0.05, int(depth)) == a.tier_for(0.05, int(depth))
    for tier in range(-1, 6):
        ka, kb = a.knobs_for(tier, 1.3), b.knobs_for(tier, 1.3)
        assert (ka.delta, ka.tau, ka.iter_cap, ka.tier) == (kb.delta, kb.tau, kb.iter_cap,
                                                            kb.tier)
        assert isinstance(kb, LaneKnobs) and kb.delta.dtype == np.float32


def test_tier_validation_equals_the_reference():
    ladders = [
        [],
        [("a", 1.0, 1.2, 8)],
        [("a", 0.5, 0.9, 8)],
        [("a", 1.0, 0.9, -1)],
        [("a", 1.0, 0.9, 8), ("b", 0.9, 0.8, 4)],
        [("a", 1.0, 0.9, 8), ("b", 2.0, 0.95, 4)],
        [("a", 1.0, 0.9, 8), ("b", 2.0, 0.8, 16)],
        [("a", 1.0, 0.9, 8), ("b", 2.0, 0.8, 4)],
    ]
    for ladder in ladders:
        outcomes = []
        for tier, validate in ((RefKnobTier, ref_validate_tiers), (KnobTier, validate_tiers)):
            try:
                outcomes.append(len(validate([tier(*t) for t in ladder])))
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], ladder
    assert [tuple(vars(t).values()) for t in default_tiers(0.9, 16)] == [
        tuple(vars(t).values()) for t in ref_default_tiers(0.9, 16)]
    for bad in (dict(service_est_s=0.0), dict(service_est_s=0.1, lanes=0),
                dict(service_est_s=0.1, pressure_thresholds=(1.0, 0.5, 2.0)),
                dict(service_est_s=0.1, floor_speedup=0.0),
                dict(service_est_s=0.1, ewma_alpha=0.0),
                dict(service_est_s=0.1, queue_low=3.0, queue_high=2.0)):
        with pytest.raises(ValueError):
            DegradationController(default_tiers(0.95, 32), **bad)


# ------------------------------------------------------------ the schedules
def test_fault_schedules_equal_the_reference():
    streams = ("spikes_at", "fails_at", "chunk_fails_at", "refill_fails_at", "poisons_at")
    for seed in (0, 3, 11, 2**31 - 1):
        kw = dict(seed=seed, spike_prob=0.3, fail_prob=0.2, chunk_fail_prob=0.25,
                  refill_fail_prob=0.15, poison_prob=0.2, spike_calls=(5,), poison_calls=(1,))
        a, b = RefProfile(**kw), FaultProfile(**kw)
        for stream in streams:
            hits = [c for c in range(300) if getattr(b, stream)(c)]
            assert hits == [c for c in range(300) if getattr(a, stream)(c)], (seed, stream)
            assert 0 < len(hits) < 300
        assert [b.poison_lane(c, 4) for c in range(100)] == [
            a.poison_lane(c, 4) for c in range(100)]
    pinned = FaultProfile(chunk_fail_calls=(2,), refill_fail_calls=(1,), poison_calls=(0, 3))
    assert [c for c in range(5) if pinned.chunk_fails_at(c)] == [2]
    assert [c for c in range(5) if pinned.poisons_at(c)] == [0, 3]


def test_inject_burst_equals_the_reference():
    base = [(0.1 * i, {"g": i % 3}) for i in range(7)]
    for seed, n, slo in ((0, 5, None), (3, 12, 0.25), (9, 0, None)):
        a = ref_inject_burst(base, at_t=0.3, n=n, width_s=0.05, seed=seed, slo_s=slo)
        b = inject_burst(base, at_t=0.3, n=n, width_s=0.05, seed=seed, slo_s=slo)
        assert a == b
    for bad in (dict(width_s=0.0), dict(n=-1)):
        with pytest.raises(ValueError):
            inject_burst(base, **{**dict(at_t=0.0, n=1, width_s=0.1), **bad})
    with pytest.raises(ValueError, match="empty"):
        inject_burst([], at_t=0.0, n=1, width_s=0.1)


# -------------------------------------------------- FaultyServer (fixed lanes)
def test_faulty_server_retries_with_virtual_backoff():
    srv = BatchedFusedServer(bundles()[1], CFG, batch_size=4, device="cpu")
    srv.serve_batch([{"g": 0}])   # warm
    fs = FaultyServer(srv, FaultProfile(fail_calls=(0,)))
    stats = ServingRuntime(fs, max_wait_s=0.001, max_retries=2, backoff_s=0.01).run(
        [(0.0, {"g": g}) for g in range(4)], warmup=False)
    assert stats.n_retries == 1 and stats.n_failed == 0
    assert [r.disposition for r in stats.records] == ["ok"] * 4
    assert all(r.latency_s >= 0.01 for r in stats.records)
    assert fs.events == [(0, "fail")]
    fs = FaultyServer(srv, FaultProfile(fail_calls=(0, 1, 2)))
    stats = ServingRuntime(fs, max_wait_s=0.001, max_retries=2, backoff_s=0.01).run(
        [(0.0, {"g": g}) for g in range(4)], warmup=False)
    assert fs.calls == 3 and stats.n_retries == 2 and stats.n_failed == 4
    assert all(r.disposition == "failed" and np.isnan(r.y_hat) for r in stats.records)
    slept = []
    fs = FaultyServer(srv, FaultProfile(spike_calls=(0,), spike_s=0.5), sleep=slept.append)
    fs.serve_batch([{"g": 1}])
    assert slept == [0.5] and fs.events == [(0, "spike")]
    assert fs.batch_size == 4 and fs.compile_count == srv.compile_count


# --------------------------------------------------- the lane table's recovery
def test_chunk_failure_rolls_back_and_replays_bitwise():
    srv = cont4()
    want = z_by_req(run(srv))
    fs = FaultyContinuousServer(srv, FaultProfile(chunk_fail_calls=(0,)))
    table, _ = srv.admit(srv.new_table(128), 128, [(0, {"g": 0}, None)])
    with pytest.raises(ChunkDispatchError) as err:
        fs.run_chunk(table)
    wreck = srv.readback(err.value.table)
    assert err.value.table is table
    assert np.isnan(wreck["y_hat"]).all() and (wreck["z"] == -1).all()
    assert fs.events == [(0, "chunk_fail")]
    fs = FaultyContinuousServer(srv, FaultProfile(chunk_fail_calls=(1,)))
    stats = run(fs, max_retries=2)
    assert stats.n_rollbacks == 1 and stats.n_retries == 1 and stats.n_failed == 0
    assert z_by_req(stats) == want
    fs = FaultyContinuousServer(srv, FaultProfile(refill_fail_calls=(0,)))
    stats = run(fs, max_retries=2)
    assert stats.n_retries == 1 and z_by_req(stats) == want
    fs = FaultyContinuousServer(srv, FaultProfile(chunk_fail_calls=(0, 1, 2)))
    stats = run(fs, max_retries=2)
    assert stats.n_rollbacks == 3 and stats.n_failed > 0 and len(stats.records) == 6
    assert any(r.disposition == "ok" for r in stats.records)


def _poison_seed(stats, lanes=4):
    """A seed whose chunk-0 poison lands on a lane occupied during chunk 0."""
    live = {r.lane for r in stats.records if r.batch_id == 0 and r.n_chunks >= 1}
    return next(s for s in range(100) if FaultProfile(seed=s).poison_lane(0, lanes) in live)


def test_poisoned_lane_is_quarantined_alone_and_readmission_recovers():
    srv = cont4()
    free = run(srv)
    seed = _poison_seed(free)
    lane = FaultProfile(seed=seed).poison_lane(0, 4)
    fs = FaultyContinuousServer(srv, FaultProfile(seed=seed, poison_calls=(0,)))
    stats = run(fs, poison_retries=0)
    assert fs.events == [(0, f"poison:{lane}")]
    poisoned = [r for r in stats.records if r.disposition == "poisoned"]
    assert len(poisoned) == 1 and stats.n_poisoned == 1 and poisoned[0].lane == lane
    want = z_by_req(free)
    assert z_by_req(stats) == {k: v for k, v in want.items() if k != poisoned[0].req_id}
    fs = FaultyContinuousServer(srv, FaultProfile(seed=seed, poison_calls=(0,)))
    stats = run(fs, poison_retries=1)
    assert stats.n_poisoned == 0 and [r.disposition for r in stats.records] == ["ok"] * 6
    assert z_by_req(stats) == want


def test_fault_storm_replays_identically_and_as_the_reference():
    srv = cont4()
    before = srv.compile_count

    def go(server, faulty, profile, runtime):
        fs = faulty(server, profile(**STORM))
        st = run(fs, runtime=runtime, max_retries=2, poison_retries=1)
        disp = [(r.req_id, r.disposition, r.z, r.lane, r.iters)
                for r in sorted(st.records, key=lambda r: r.req_id)]
        return fs.events, disp, st.n_rollbacks, st.n_retries, st.n_poisoned, st.n_failed

    first = go(srv, FaultyContinuousServer, FaultProfile, ContinuousServingRuntime)
    assert first == go(srv, FaultyContinuousServer, FaultProfile, ContinuousServingRuntime)
    assert first == go(ref_cont4(), RefFaultyContinuous, RefProfile, RefContinuousRuntime)
    kinds = {kind.split(":")[0] for _, kind in first[0]}
    assert {"chunk_fail", "poison"} <= kinds, first[0]
    assert srv.compile_count == before == 2


def test_corrupt_cache_entry_is_detected():
    port = bundles()[1]
    srv = ContinuousBatchedServer(port, CFG, batch_size=2, chunk_iters=2, cache_size=8,
                                  device="cpu")
    assert corrupt_cache_entry(srv.cache) is False
    table, _ = srv.admit(srv.new_table(128), 128, [(0, {"g": 1}, None)])
    want = srv.readback(srv.run_chunk(table))["z"][0].copy()
    assert corrupt_cache_entry(srv.cache, seed=4) is True
    srv.cache.verify_hits = True
    fs = FaultyContinuousServer(srv, FaultProfile(cache_corrupt_calls=(0,)))
    table, _ = fs.admit(srv.new_table(128), 128, [(1, {"g": 1}, None)])
    assert fs.events == [(0, "cache_corrupt")]
    assert srv.cache.corruptions == 1 and srv.cache.stats["misses"] == 2
    out = srv.readback(srv.run_chunk(table))
    np.testing.assert_array_equal(out["z"][1], want)   # rebuilt, then served as before
    assert corrupt_cache_entry(srv.cache, seed=5) and srv.cache.revalidate() == 1
    with pytest.raises(TransientExecutorError):
        FaultyContinuousServer(srv, FaultProfile(refill_fail_calls=(0,))).admit(
            table, 128, [(0, {"g": 2}, None)])
