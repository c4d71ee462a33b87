"""Lanes sharded over a serving mesh, in the port, on the CPU.

The mesh's shards are simulated on the CPU (``launch.mesh.simulated_devices``:
each shard has its own executor, slot and, on a card, stream):

* ``make_serving_mesh`` and ``validate_serving_mesh`` raise as the
  reference's do; ``device_fill`` and ``straggler_report`` split lanes by
  shard.
* ``BatchedFusedServer`` over 2 and 4 shards against the reference's
  unsharded server on the same inputs (the reference's bundle bridged to the
  port): plans bitwise, iterations equal, ŷ within 1e-4·max(1, |y|), prob
  within 1e-4 (as ``test_torch_batched.py``); against the port's unsharded
  server plans bitwise, ŷ and prob within 1e-5 (a shard of L/D lanes may
  round apart from L lanes).  A 1-shard mesh is the unsharded server bit for
  bit, batched and continuous (the reference's
  ``test_mesh_table_matches_unsharded`` fails on its 1-device mesh).
* ``ContinuousBatchedServer(mesh=)`` over a recycled lane, and both runtimes
  over sharded servers on a t = 0 trace: dispositions and plans those of the
  unsharded ones; the fault helpers reach the global lane's shard.
* One slot a cap bucket across fills 1, 3 and 4 and mesh sizes 1, 2 and 4,
  on every shard; ``cache_size`` with ``mesh`` raises; the launcher serves
  ``--mode fused-sharded --devices 2`` and ``fused-continuous --devices 2``.
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
from repro.serving.degrade import LaneKnobs as RefLaneKnobs
from repro_torch.bridge import bundle_from_numpy
from repro_torch.core.executor import BiathlonConfig
from repro_torch.launch.mesh import LANES_AXIS, make_serving_mesh, simulated_devices
from repro_torch.launch.serve import main as serve_main
from repro_torch.serving import (
    BatchedFusedServer,
    BatchResult,
    ContinuousBatchedServer,
    ContinuousServingRuntime,
    LaneKnobs,
    ServingRuntime,
    device_fill,
    poison_lane_carry,
    scramble_chunk_carry,
    straggler_report,
    validate_serving_mesh,
)

CFG = BiathlonConfig(m=SMALL_CFG.m, m_sobol=SMALL_CFG.m_sobol)
LANES = 4
SIZES = dict(rows_per_group=1200, n_train_groups=60, n_serve_groups=4, n_requests=4)
QMC = dict(m=64, m_sobol=16)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int):
    return make_serving_mesh(devices=simulated_devices(n, "cpu"))


@functools.cache
def small_port():
    return bundle_from_numpy(bundle_to_numpy(make_small_bundle()))


@functools.cache
def bundles(name: str):
    if name == "small":
        ref = make_small_bundle()
        return ref, bundle_from_numpy(bundle_to_numpy(ref)), SMALL_CFG, CFG
    ref = ref_make_pipeline(name, **SIZES)
    return ref, bundle_from_numpy(bundle_to_numpy(ref)), RefConfig(**QMC), BiathlonConfig(**QMC)


def knobs(pipeline, fill: int, cls=LaneKnobs):
    """The defaults, a tight lane capped at 6 iterations, a looser lane and a
    tight lane capped at 2."""
    d = pipeline.delta_default
    return [None, cls(0.3 * d, 0.95, 6), cls(2.0 * d, 0.9, 64), cls(0.3 * d, 0.95, 2)][:fill]


def bits(x) -> list:
    return np.asarray(x, np.float32).view(np.int32).tolist()


# ----------------------------------------------------------------- the mesh
def test_make_serving_mesh_validation():
    mesh = make_serving_mesh(1, devices=["cpu", "cpu"])
    assert mesh.axis_names == (LANES_AXIS,) and mesh.size == 1
    assert mesh.devices == (torch.device("cpu"),)
    assert cpu_mesh(4).devices == (torch.device("cpu"),) * 4
    # the default is every visible card
    assert make_serving_mesh(devices=None if torch.cuda.is_available() else ["cpu"]).size >= 1
    with pytest.raises(ValueError, match=">= 1"):
        make_serving_mesh(0, devices=["cpu"])
    with pytest.raises(ValueError, match="simulated_devices"):
        make_serving_mesh(10_000, devices=["cpu"])
    with pytest.raises(ValueError, match=">= 1"):
        simulated_devices(0, "cpu")


@pytest.mark.parametrize("server", [BatchedFusedServer, ContinuousBatchedServer])
def test_servers_reject_bad_meshes(server):
    port = small_port()

    class _FakeMesh:
        devices = np.empty(3, dtype=object)
        axis_names = (LANES_AXIS,)

    class _FakeMesh2D:
        devices = np.empty((2, 2), dtype=object)
        axis_names = ("data", "model")

    class _FakeMeshWrongAxis:
        devices = np.empty(2, dtype=object)
        axis_names = ("data",)

    with pytest.raises(ValueError, match="divisible"):
        server(port, CFG, batch_size=4, mesh=_FakeMesh())
    with pytest.raises(ValueError, match="1-D"):
        server(port, CFG, batch_size=4, mesh=_FakeMesh2D())
    with pytest.raises(ValueError, match="named 'lanes'"):
        server(port, CFG, batch_size=4, mesh=_FakeMeshWrongAxis())
    with pytest.raises(TypeError, match="make_serving_mesh"):
        server(port, CFG, batch_size=4, mesh=object())
    with pytest.raises(ValueError, match="mutually exclusive"):
        server(port, CFG, batch_size=4, mesh=cpu_mesh(2), cache_size=4)
    with pytest.raises(ValueError, match="device="):
        server(port, CFG, batch_size=4, mesh=cpu_mesh(2), device="cpu")
    assert validate_serving_mesh(None, 4) == 1 and validate_serving_mesh(cpu_mesh(4), 8) == 4


def test_device_fill_and_straggler_report_per_shard():
    np.testing.assert_array_equal(device_fill(5, 8, 4), [2, 2, 1, 0])
    np.testing.assert_array_equal(device_fill(0, 8, 2), [0, 0])
    with pytest.raises(ValueError, match="divisible"):
        device_fill(3, 8, 3)
    iters = np.asarray([1, 5, 2, 0, 7], np.int32)
    f = np.zeros(5, np.float32)
    res = BatchResult(y_hat=f, prob=f, iters=iters, sample_frac=f, batch_iters=7, cap=128,
                      lanes=8, z=np.zeros((5, 2), np.int32), n_devices=4)
    rep = straggler_report(res)
    np.testing.assert_allclose(rep["per_device_fill"], [1.0, 1.0, 0.5, 0.0])
    np.testing.assert_array_equal(rep["wasted_iters"], [4, 0, 0, 2, 0])
    assert rep["n_devices"] == 4 and rep["lane_imbalance"] == pytest.approx(1.0)


# ------------------------------------------------------ batched parity
@pytest.mark.parametrize("name", ["small", "sensor_health"])
def test_sharded_batches_match_reference_and_unsharded(name):
    ref, port, ref_cfg, cfg = bundles(name)
    rs = RefBatched(ref, ref_cfg, batch_size=LANES)
    base = BatchedFusedServer(port, cfg, batch_size=LANES, device="cpu")
    meshes = {d: BatchedFusedServer(port, cfg, batch_size=LANES, mesh=cpu_mesh(d))
              for d in (1, 2, 4)}
    iters = []
    for start, fill in ((0, 1), (1, 3), (0, LANES)):
        reqs = ref.requests[start:start + fill]
        a = rs.serve_batch(reqs, knobs=knobs(ref.pipeline, fill, RefLaneKnobs))
        b = base.serve_batch(reqs, knobs=knobs(port.pipeline, fill))
        iters += b.iters.tolist()
        for d, srv in meshes.items():
            c = srv.serve_batch(reqs, knobs=knobs(port.pipeline, fill))
            assert c.n_devices == d and c.cap == b.cap == a.cap
            np.testing.assert_array_equal(np.asarray(a.z), c.z)
            np.testing.assert_array_equal(np.asarray(a.iters), c.iters)
            ya = np.asarray(a.y_hat)
            assert (np.abs(ya - c.y_hat) <= 1e-4 * np.maximum(1.0, np.abs(ya))).all()
            assert (np.abs(np.asarray(a.prob) - c.prob) <= 1e-4).all()
            np.testing.assert_array_equal(b.z, c.z)
            np.testing.assert_array_equal(b.iters, c.iters)
            assert (np.abs(b.y_hat - c.y_hat) <= 1e-5 * np.maximum(1.0, np.abs(b.y_hat))).all()
            assert (np.abs(b.prob - c.prob) <= 1e-5).all()
            if d == 1:
                assert bits(b.y_hat) == bits(c.y_hat) and bits(b.prob) == bits(c.prob)
            np.testing.assert_array_equal(c.sample_frac, b.sample_frac)
            assert straggler_report(c)["n_devices"] == d
    assert max(iters) > 0, "no lane entered the planner loop"
    for srv in meshes.values():
        srv.check_compile_contract()
        assert srv.compile_count == len(srv.compiled_buckets)


def test_compile_count_is_one_per_bucket_across_fills_and_mesh_sizes():
    port = small_port()
    for d in (1, 2, 4):
        srv = BatchedFusedServer(port, CFG, batch_size=LANES, mesh=cpu_mesh(d))
        assert srv.compile_count == 0 and srv.shard_compile_counts == [0] * d
        srv.serve_batch([{"g": 0}])
        srv.serve_batch([{"g": 1}, {"g": 2}, {"g": 3}], knobs=[LaneKnobs(0.2, 0.9, 3)] * 3)
        srv.serve_batch([{"g": g} for g in range(4)])
        assert srv.compile_count == 1 and srv.shard_compile_counts == [1] * d
        srv.check_compile_contract(buckets=[128])
        srv.serve_batch([{"g": 8}])              # a new cap bucket: one slot on every shard
        srv.check_compile_contract(buckets=[128, 1024])
        assert srv.shard_compile_counts == [2] * d
        srv._run.shards[-1].exe.slots_built += 1     # a shard that built one more slot
        with pytest.raises(AssertionError, match=f"shard {d - 1}"):
            srv.check_compile_contract()


# --------------------------------------------------- the continuous table
def drain(srv, table, max_chunks=200):
    out = srv.readback(table)
    for _ in range(max_chunks):
        if out["done"].all():
            return out
        out = srv.readback(srv.run_chunk(table))
    raise AssertionError("the table never drained")


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_table_over_a_recycled_lane(shards):
    """The table over 1, 2 and 4 shards against the unsharded one, readback
    by readback through admissions, chunks, a recycled lane and a rollback:
    plans, iterations and flags equal; ŷ and prob bitwise on one shard,
    within 1e-5 on more; two slots a bucket on every shard."""
    port = small_port()
    kn = [None, LaneKnobs(0.15, 0.95, 5), LaneKnobs(1.0, 0.9, 64), LaneKnobs(0.15, 0.99, 64)]
    a = ContinuousBatchedServer(port, CFG, batch_size=LANES, chunk_iters=2, device="cpu")
    b = ContinuousBatchedServer(port, CFG, batch_size=LANES, chunk_iters=2, mesh=cpu_mesh(shards))
    ta, tb = a.new_table(128), b.new_table(128)
    admits = [[(lane, {"g": lane}, kn[lane]) for lane in range(LANES)],
              [(1, {"g": 5}, LaneKnobs(0.15, 0.95, 64))]]

    def same(x, y):
        for key in ("z", "it", "n", "done", "active"):
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)
        if shards == 1:
            assert bits(x["y_hat"]) == bits(y["y_hat"]) and bits(x["prob"]) == bits(y["prob"])
        else:
            assert (np.abs(x["y_hat"] - y["y_hat"]) <= 1e-5 * np.maximum(1, np.abs(x["y_hat"]))
                    ).all()
            assert (np.abs(x["prob"] - y["prob"]) <= 1e-5).all()

    for assignments in admits:
        a.admit(ta, 128, assignments)
        b.admit(tb, 128, assignments)
        same(a.readback(ta), b.readback(tb))
        for _ in range(2):
            same(a.readback(a.run_chunk(ta)), b.readback(b.run_chunk(tb)))
    ckpt = b.snapshot(tb)
    want = b.readback(b.run_chunk(tb))
    scramble_chunk_carry(tb)
    b.restore(tb, ckpt)
    np.testing.assert_array_equal(b.readback(b.run_chunk(tb))["z"], want["z"])
    same(drain(a, ta), drain(b, tb))
    b.check_compile_contract(buckets=[128])
    assert b.shard_compile_counts == [2] * shards
    # a global lane's poison lands in its shard's table, and clearing evicts it there
    poison_lane_carry(tb, LANES - 1)
    part, row = tb.locate(LANES - 1)
    assert np.isnan(float(tb.shards[part].y_hat[row]))
    b.clear_lanes(tb, [LANES - 1])
    assert not b.readback(tb)["active"][LANES - 1]


@pytest.mark.parametrize("continuous", [False, True], ids=["fixed", "continuous"])
def test_runtimes_over_sharded_servers_match_unsharded(continuous):
    """Both runtimes on a t = 0 trace over a 2-shard server: dispositions,
    lanes, plans and iterations those of the unsharded server."""
    port = small_port()
    arrivals = [(0.0, {"g": g}) for g in (0, 3, 1, 5, 2, 7, 4, 6)]
    if continuous:
        run = lambda **on: ContinuousServingRuntime(ContinuousBatchedServer(  # noqa: E731
            port, CFG, batch_size=LANES, chunk_iters=2, **on)).run(arrivals)
    else:
        run = lambda **on: ServingRuntime(BatchedFusedServer(  # noqa: E731
            port, CFG, batch_size=LANES, **on), max_wait_s=0.001).run(arrivals)
    a, b = run(device="cpu"), run(mesh=cpu_mesh(2))
    assert b.compile_count == 0 and b.n_devices == 2
    ra = sorted(a.records, key=lambda r: r.req_id)
    rb = sorted(b.records, key=lambda r: r.req_id)
    for x, y in zip(ra, rb, strict=True):
        for key in ("disposition", "z", "iters", "lane", "batch_id", "batch_fill"):
            assert getattr(x, key) == getattr(y, key), (x.req_id, key)
        assert abs(x.y_hat - y.y_hat) <= 1e-5 * max(1.0, abs(x.y_hat))
    s = b.summary()
    assert s["n"] == len(arrivals) and s["n_devices"] == 2 and len(s["per_device_fill"]) == 2


@pytest.mark.parametrize("mode", ["fused-sharded", "fused-continuous"])
def test_launcher_serves_two_simulated_shards(mode, capsys):
    summary = serve_main(["--pipeline", "turbofan", "--device", "cpu", "--rows-per-group", "400",
                          "--requests", "6", "--m", "64", "--arrival-rate", "200", "--mode", mode,
                          "--devices", "2", "--batch-size", "4"])
    out = capsys.readouterr().out
    assert f"mode={mode}" in out and "devices=2" in out and "slots_built" in out
    assert summary["n"] == 6 and summary["n_devices"] == 2
    assert summary["compile_count"] == 0 and summary["guarantee_rate"] > 0.0
