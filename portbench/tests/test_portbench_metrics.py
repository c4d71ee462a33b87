"""The metric readers' arithmetic on a made-up window."""
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import catalog, work

CONFIG = {"biathlon": {"m": 10, "m_sobol": 4}, "model": {"n_trees": 3, "max_depth": 2},
          "aggs": [["avg", "a"], ["sum", "b"]]}
TRACED = {"refills": 50, "iterating": 20, "lane_steps": 30, "table_rows": 10000}


def _stats(n_chunks, occ, wasted, total):
    return SimpleNamespace(n_chunks=n_chunks, lane_occupancy=occ,
                           chunk_stats={"wasted_iters": np.array(wasted), "total_iters": total})


@pytest.fixture
def ctx():
    return SimpleNamespace(
        setup_s=12.5, window_s=2.0,
        runs=[(0, _stats(10, 0.5, [1, 2], 7)), (10, _stats(30, 0.25, [0, 1], 9))],
        spans=[("refill", 0.0, 0.004, 2), ("refill", 1.0, 1.006, 3),
               ("chunk", 0.0, 0.002, 0), ("chunk", 1.0, 1.004, 0)],
        served=[(0, 1.0, 0.9, (10, 20), 2), (1, 2.0, 0.99, (5, 5), 0)],
        dep=SimpleNamespace(sizes=np.array([100, 50])),
        trace={"busy_s": 0.5, "window_s": 2.0,
               "kernels": {"void (anonymous namespace)::smem_kernel(int const*)": 0.01,
                           "void (anonymous namespace)::chunked_kernel<256>(float const*)": 0.002,
                           "void at::native::elementwise_kernel()": 1.0}},
        traced_work=TRACED, config=CONFIG, work_fns=work)


def read(name, ctx):
    return catalog.metric_reader(name)(ctx)


def test_end_to_end_arithmetic(ctx):
    assert read("setup_s", ctx) == 12.5
    assert read("throughput_rps", ctx) == pytest.approx(1.0)


def test_runtime_and_span_arithmetic(ctx):
    assert read("lane_occupancy.sat", ctx) == pytest.approx((0.5 * 10 + 0.25 * 30) / 40)
    assert read("chunk_wasted_frac.sat", ctx) == pytest.approx(4 / (4 + 16))
    # (4 + 6) ms over 5 lanes
    assert read("refill_ms.sat", ctx) == pytest.approx(2.0)
    assert read("chunk_ms.sat", ctx) == pytest.approx(3.0)
    assert read("sample_frac.sat", ctx) == pytest.approx(40 / 300)
    assert read("iters_per_request.sat", ctx) == pytest.approx(1.0)


def test_trace_arithmetic(ctx):
    w = work.counted_work(TRACED, CONFIG)
    assert read("device_idle_frac.sat", ctx) == pytest.approx(0.75)
    assert read("tree_qmc_roofline.sat", ctx) == pytest.approx(
        100 * work.bound_s(*w["tree"]) / 0.01)
    assert read("prefix_stats_roofline.sat", ctx) == pytest.approx(
        100 * work.bound_s(*w["prefix"]) / 0.002)
    assert read("step_mfu.sat", ctx) == pytest.approx(
        100 * sum(work.bound_s(*v) for v in w.values()) / 2.0)


def test_nothing_to_read_reads_nothing(ctx):
    ctx.trace = None
    ctx.runs = [(0, _stats(0, 0.0, [], 0))]
    ctx.served, ctx.spans = [], []
    for name in ("tree_qmc_roofline.sat", "prefix_stats_roofline.sat", "step_mfu.sat",
                 "device_idle_frac.sat", "lane_occupancy.sat", "chunk_wasted_frac.sat",
                 "throughput_rps", "refill_ms.sat", "chunk_ms.sat", "sample_frac.sat",
                 "iters_per_request.sat"):
        assert read(name, ctx) is None, name
    ctx.trace = {"busy_s": 0.5, "window_s": 2.0, "kernels": {"other": 1.0}}
    assert read("tree_qmc_roofline.sat", ctx) is None
