"""The port's continuous batching against its own monolithic run and the JAX
reference's ``ContinuousBatchedServer``, on the CPU.

* Chunked against monolithic: a batch admitted into the lane table and
  drained chunk by chunk at ``chunk_iters`` 1, 2 and ``max_iters`` gives
  the port's ``BatchedFusedServer`` plans (bitwise) and iteration counts,
  ŷ and prob within 1e-5 (a one-lane refill may round apart from an L-lane
  z⁰ evaluation).
* The table against the reference's unsharded table, chunk by chunk: the
  same ``new_table`` / ``admit`` (with knobs) / ``run_chunk`` sequence, a
  lane recycled mid-trace, ``readback`` compared after every admission and
  chunk (plans bitwise, iterations, ``done`` and ``active`` equal, ŷ within
  1e-4·max(1, |y|) or the same class, prob within 1e-4: XLA and PyTorch
  order float32 sums differently), on turbofan, sensor_health under "auto"
  and "ref" and fraud_detection, uncached and cached.
* Recycling against serial replay: a saturating trace through
  ``ContinuousServingRuntime`` gives each request the plan and iterations
  of serving it alone (ŷ, prob within 1e-5), as the reference's
  ``tests/test_continuous.py::test_recycling_matches_serial_replay``.
* An empty or cleared lane stays inert; ``admit`` and ``chunk_iters`` are
  validated; two slots per cap bucket across fills; ``chunked_straggler_report``
  equals the reference's.
"""
import functools

import numpy as np
import pytest
import torch
from serving_fixtures import SMALL_CFG, make_small_bundle
from test_torch_bridge import bundle_to_numpy

from repro.core.executor import BiathlonConfig as RefConfig
from repro.data.synthetic import make_pipeline as ref_make_pipeline
from repro.serving.batched import chunked_straggler_report as ref_chunked_straggler_report
from repro.serving.continuous import ContinuousBatchedServer as RefContinuous
from repro.serving.degrade import LaneKnobs as RefLaneKnobs
from repro_torch.bridge import bundle_from_numpy
from repro_torch.core.executor import BiathlonConfig
from repro_torch.data.synthetic import poisson_arrivals
from repro_torch.serving import (
    BatchedFusedServer,
    ContinuousBatchedServer,
    ContinuousServingRuntime,
    LaneKnobs,
    chunked_straggler_report,
)

SIZES = dict(rows_per_group=1600, n_train_groups=100, n_serve_groups=8, n_requests=8)
QMC = dict(m=96, m_sobol=32)
LANES = 4
CASES = [("turbofan", "auto"), ("sensor_health", "auto"), ("sensor_health", "ref"),
         ("fraud_detection", "auto")]
SMALL = dict(m=SMALL_CFG.m, m_sobol=SMALL_CFG.m_sobol)


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
def small_port():
    return bundle_from_numpy(bundle_to_numpy(make_small_bundle()))


def knobs(pipeline, cls):
    """Per-admission knobs: the defaults, a tight lane capped at 6
    iterations, a looser lane, a tight lane capped at 2 (tight: 0.3·δ for
    regression, τ = 0.995 for classification), and a recycled tight lane."""
    d = pipeline.delta_default
    if pipeline.task == "classification":
        return [None, cls(d, 0.995, 6), cls(d, 0.9, 64), cls(d, 0.995, 2), cls(d, 0.995, 64)]
    return [None, cls(0.3 * d, 0.95, 6), cls(2.0 * d, 0.9, 64), cls(0.3 * d, 0.95, 2),
            cls(0.3 * d, 0.95, 64)]


def drain(srv, table, max_chunks=200):
    out, chunks = srv.readback(table), 0
    while not out["done"].all():
        out = srv.readback(srv.run_chunk(table))
        chunks += 1
        assert chunks <= max_chunks, "the table never drained"
    return out, chunks


def assert_same_readback(a, b, classify: bool, *, tol: float, where: str):
    for key in ("z", "it", "n", "done", "active"):
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=f"{where}: {key}")
    occ = np.asarray(a["active"])
    ya, yb = np.asarray(a["y_hat"])[occ], np.asarray(b["y_hat"])[occ]
    if classify:
        np.testing.assert_array_equal(ya, yb, err_msg=where)
    else:
        assert (np.abs(ya - yb) <= tol * np.maximum(1.0, np.abs(ya))).all(), (where, ya, yb)
    pa, pb = np.asarray(a["prob"])[occ], np.asarray(b["prob"])[occ]
    assert (np.abs(pa - pb) <= tol).all(), (where, pa, pb)


@pytest.mark.parametrize("chunk_iters", [1, 2, SMALL_CFG.max_iters])
def test_chunked_matches_monolithic(chunk_iters):
    """Admitting a whole batch and draining it gives the fixed-lane run;
    one chunk at ``max_iters`` IS the monolithic loop."""
    port = small_port()
    cfg = BiathlonConfig(**SMALL)
    reqs = [{"g": g} for g in range(LANES)]
    kn = [None, LaneKnobs(0.15, 0.95, 5), LaneKnobs(1.0, 0.9, 64), LaneKnobs(0.15, 0.99, 64)]
    want = BatchedFusedServer(port, cfg, batch_size=LANES, device="cpu").serve_batch(reqs, kn)
    assert want.batch_iters > 0
    srv = ContinuousBatchedServer(port, cfg, batch_size=LANES, chunk_iters=chunk_iters,
                                  device="cpu")
    cap = srv.trace_cap(reqs)
    assert cap == want.cap
    table, rows = srv.admit(srv.new_table(cap), cap,
                            [(i, r, k) for i, (r, k) in enumerate(zip(reqs, kn))])
    assert rows == {i: int(port.pipeline.group_sizes(port.store, r).sum())
                    for i, r in enumerate(reqs)}
    out, chunks = drain(srv, table)
    np.testing.assert_array_equal(out["z"], want.z)
    np.testing.assert_array_equal(out["it"], want.iters)
    assert (np.abs(out["y_hat"] - want.y_hat) <= 1e-5 * np.maximum(1, np.abs(want.y_hat))).all()
    assert (np.abs(out["prob"] - want.prob) <= 1e-5).all()
    if chunk_iters >= SMALL_CFG.max_iters:
        assert chunks == 1
    else:
        assert chunks == -(-want.batch_iters // chunk_iters)


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
@pytest.mark.parametrize("name,afc_backend", CASES)
def test_table_matches_reference_chunk_by_chunk(name, afc_backend, cached):
    ref, port = bundles(name)
    p = port.pipeline
    cache = 16 if cached else None
    rs = RefContinuous(ref, RefConfig(**QMC), batch_size=LANES, chunk_iters=2,
                       afc_backend=afc_backend, cache_size=cache)
    ps = ContinuousBatchedServer(port, BiathlonConfig(**QMC), batch_size=LANES, chunk_iters=2,
                                 afc_backend=afc_backend, cache_size=cache, device="cpu")
    classify = p.task == "classification"
    kr, kp = knobs(ref.pipeline, RefLaneKnobs), knobs(p, LaneKnobs)
    reqs = ref.requests[:LANES + 1]
    cap = rs.trace_cap(reqs)
    assert ps.trace_cap(reqs) == cap == 2048
    rt, pt = rs.new_table(cap), ps.new_table(cap)
    first = list(range(LANES))
    rt, rows_r = rs.admit(rt, cap, [(i, reqs[i], kr[i]) for i in first])
    pt, rows_p = ps.admit(pt, cap, [(i, reqs[i], kp[i]) for i in first])
    assert rows_r == rows_p
    assert_same_readback(rs.readback(rt), ps.readback(pt), classify, tol=1e-4, where="admit")
    steps = recycled = 0
    while True:
        a, b = rs.readback(rt), ps.readback(pt)
        assert_same_readback(a, b, classify, tol=1e-4, where=f"chunk {steps}")
        if not recycled and a["done"].any():
            # recycle the first lane done with the fifth request, tight
            lane = int(np.flatnonzero(a["done"])[0])
            rt, _ = rs.admit(rt, cap, [(lane, reqs[LANES], kr[LANES])])
            pt, _ = ps.admit(pt, cap, [(lane, reqs[LANES], kp[LANES])])
            recycled = 1
            continue
        if a["done"].all():
            break
        rt, pt = rs.run_chunk(rt), ps.run_chunk(pt)
        steps += 1
        assert steps < 100
    assert recycled and steps > 0
    assert ps.compile_count == 2 and ps.compiled_buckets == [cap]
    if cached:
        st = dict(ps.cache.stats)
        assert st["misses"] + st["hits"] == LANES + 1
        assert st["misses"] == len({tuple(p.agg_specs(r)) for r in reqs})
        # a second pass of the same requests hits every entry
        pt = ps.new_table(cap)
        ps.admit(pt, cap, [(i, reqs[i], kp[i]) for i in first])
        assert ps.cache.stats["hits"] == st["hits"] + LANES
        assert ps.compile_count == 2


def test_recycling_matches_serial_replay():
    """A saturating trace with recycled lanes gives every request its plan
    and iterations served alone."""
    port = small_port()
    cfg = BiathlonConfig(**SMALL)
    reqs = [{"g": g} for g in range(8)]
    arrivals = poisson_arrivals(reqs, 500.0, n=20, seed=13)
    srv = ContinuousBatchedServer(port, cfg, batch_size=2, chunk_iters=2, device="cpu")
    stats = ContinuousServingRuntime(srv).run(arrivals)
    s = stats.summary()
    assert s["n"] == 20 and s["n_recycles"] > 0 and s["compile_count"] == 0
    serial = BatchedFusedServer(port, cfg, batch_size=1, device="cpu")
    for rec in stats.records:
        res = serial.serve_batch([arrivals[rec.req_id][1]])
        assert rec.z == tuple(int(x) for x in res.z[0]), rec.req_id
        assert rec.iters == int(res.iters[0])
        y = float(res.y_hat[0])
        assert abs(rec.y_hat - y) <= 1e-5 * max(abs(y), 1.0)
        assert abs(rec.prob - float(res.prob[0])) <= 1e-5


def test_empty_and_cleared_lanes_stay_inert():
    port = small_port()
    srv = ContinuousBatchedServer(port, BiathlonConfig(**SMALL), batch_size=4, chunk_iters=3,
                                  device="cpu")
    table = srv.new_table(128)
    out = srv.readback(table)
    assert out["done"].all() and not out["active"].any() and not out["it"].any()
    srv.run_chunk(table)   # an empty table: no lane moves
    assert srv.readback(table)["it"].tolist() == [0, 0, 0, 0]
    table, _ = srv.admit(table, 128, [(1, {"g": 0}, LaneKnobs(0.05, 0.99, 64)),
                                      (2, {"g": 1}, LaneKnobs(0.05, 0.99, 64))])
    out = srv.readback(table)
    assert out["active"].tolist() == [False, True, True, False]
    assert not out["done"][1] and not out["done"][2]
    srv.clear_lanes(table, [2])
    before = {k: v.copy() for k, v in srv.readback(table).items()}
    assert before["done"][2] and not before["active"][2] and before["z"][2].tolist() == [0, 0]
    srv.run_chunk(table)
    after = srv.readback(table)
    assert after["it"][1] == 3
    for lane in (0, 2, 3):
        for key in ("z", "it", "done", "active", "y_hat", "prob"):
            np.testing.assert_array_equal(after[key][lane], before[key][lane])


def test_admit_and_chunk_iters_are_validated():
    port = small_port()
    cfg = BiathlonConfig(**SMALL)
    srv = ContinuousBatchedServer(port, cfg, batch_size=2, chunk_iters=2, device="cpu")
    table = srv.new_table(128)
    with pytest.raises(ValueError, match="lane"):
        srv.admit(table, 128, [(2, {"g": 0}, None)])
    with pytest.raises(ValueError, match="twice"):
        srv.admit(table, 128, [(0, {"g": 0}, None), (0, {"g": 1}, None)])
    with pytest.raises(ValueError, match="cap"):
        srv.admit(table, 128, [(0, {"g": 8}, None)])  # a 900-row group
    with pytest.raises(ValueError, match="chunk_iters"):
        ContinuousBatchedServer(port, cfg, chunk_iters=0, device="cpu")
    with pytest.raises(TypeError, match="make_serving_mesh"):
        ContinuousBatchedServer(port, cfg, mesh=object())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            raise RuntimeError("device='cpu' (a card is present: nothing to check)")
        ContinuousBatchedServer(port, cfg)


def test_compile_count_is_two_per_bucket_across_fills():
    """The refill slot and the table slot, once per cap bucket: partial and
    full admissions, reused lanes, knobs and a second table build nothing;
    a new bucket builds two more."""
    port = small_port()
    srv = ContinuousBatchedServer(port, BiathlonConfig(**SMALL), batch_size=4, chunk_iters=3,
                                  device="cpu")
    assert srv.compile_count == 0
    table = srv.new_table(128)
    table, _ = srv.admit(table, 128, [(0, {"g": 0}, None)])
    drain(srv, table)
    assert (srv.refill_compiles, srv.chunk_compiles, srv.cold_compiles) == (1, 1, 0)
    table, _ = srv.admit(table, 128, [(i, {"g": i}, LaneKnobs(0.2, 0.9, 3)) for i in (0, 2, 3)])
    drain(srv, table)
    table, _ = srv.admit(srv.new_table(128), 128, [(1, {"g": 5}, None)])
    drain(srv, table)
    assert srv.compile_count == 2 * len(srv.compiled_buckets) == 2
    big = srv.new_table(1024)
    big, _ = srv.admit(big, 1024, [(0, {"g": 8}, None)])
    drain(srv, big)
    assert srv.compiled_buckets == [128, 1024]
    assert srv.refill_compiles == srv.chunk_compiles == 2 and srv.compile_count == 4


def test_chunked_straggler_report_matches_reference():
    rng = np.random.default_rng(5)
    for lanes, n_dev in ((4, 1), (4, 2), (8, 4), (6, 3)):
        for n_chunks in (0, 1, 7):
            it = rng.integers(0, 5, (n_chunks, lanes))
            occ = rng.random((n_chunks, lanes)) < 0.7
            a = ref_chunked_straggler_report(it, occ, lanes=lanes, n_devices=n_dev)
            b = chunked_straggler_report(it, occ, lanes=lanes, n_devices=n_dev)
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                              err_msg=key)
    for fn in (ref_chunked_straggler_report, chunked_straggler_report):
        with pytest.raises(ValueError):
            fn(np.zeros((2, 3), np.int64), np.zeros((2, 3), bool), lanes=4)
        with pytest.raises(ValueError):
            fn(np.zeros((2, 4), np.int64), np.zeros((3, 4), bool), lanes=4)
        with pytest.raises(ValueError, match="divisible"):
            fn(np.zeros((1, 4), np.int64), np.zeros((1, 4), bool), lanes=4, n_devices=3)
