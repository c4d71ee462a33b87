"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: it is marked ``cuda`` and skips
without one.  The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import contextlib
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import MLAConfig, get_config
from repro_torch.core import threefry
from repro_torch.core.executor import BiathlonConfig
from repro_torch.core.executor_fused import build_fused_executor
from repro_torch.core.guarantee import guarantee_prob
from repro_torch.core.propagation import qmc_uniforms
from repro_torch.data import aggregates
from repro_torch.data.synthetic import make_pipeline, make_pipeline_median
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.emulation import beyond, bf16_path, key_tile
from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.sampled_agg import ops
from repro_torch.kernels.sampled_agg.emulation import (
    chunked_prefix_power_sums,
    clustered_sampled_moments,
)
from repro_torch.kernels.sampled_agg.prefix_stats import (
    chunk_threads,
    prefix_power_sums,
    prefix_power_sums_ref,
)
from repro_torch.kernels.sampled_agg.quantile_select import RADIX_THREADS
from repro_torch.kernels.sampled_agg.quantile_select import Plan as SelectPlan
from repro_torch.kernels.sampled_agg.quantile_select import candidates as select_candidates
from repro_torch.kernels.sampled_agg.quantile_select import masked_select_ranks
from repro_torch.kernels.sampled_agg.quantile_select import plan as select_plan
from repro_torch.kernels.sampled_agg.ref import sampled_moments_ref
from repro_torch.kernels.sampled_agg.sampled_agg import chunk_cols, moment_blocks, sampled_moments
from repro_torch.kernels.sobol.ops import points, to_uniforms, uniforms
from repro_torch.kernels.sobol.sobol import MAX_RUN, sobol_points
from repro_torch.kernels.tree_qmc.ops import predict_sum
from repro_torch.kernels.tree_qmc.tree_qmc import Plan, candidates, ensemble_sum, plan
from repro_torch.launch.mesh import make_serving_mesh, simulated_devices
from repro_torch.models.lm import LM
from repro_torch.models.lm import moe as lm_moe
from repro_torch.models.lm.layers import attention_block
from repro_torch.models.tabular.trees import GradientBoosting, RandomForest, TreeEnsemble
from repro_torch.serving import (
    BatchedFusedServer,
    BiathlonServer,
    ContinuousBatchedServer,
    poison_lane_carry,
    scramble_chunk_carry,
)

pytestmark = pytest.mark.cuda
TABLE_TOL = dict(rtol=3e-5, atol=1e-3)
# flash_attention vs its plain version: float32 differs in summation order
# only; bf16 outputs are the float32 results rounded once, so within one
# bf16 ulp (at most 2^-7 relative)
ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# the bf16 kernel against its roundings emulated in PyTorch: both outputs
# are bf16, so one ulp (2^-7 relative) of the rounding apart at most
EMULATION_TOL = dict(rtol=2 ** -7, atol=2 ** -8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _heavy_tailed(n=60000, seed=7):
    rng = np.random.default_rng(seed)
    v = rng.normal(1.25, 0.12, n).astype(np.float32)
    v[0] = 100.0
    return v


# the executors' one-launch grids (max(m, m_sobol), 2k) at BiathlonConfig()'s
# m = 1000, m_sobol = 256: k = 1, 3, 5, 8, 9, 10, 21 over the eight
# pipelines; the LM head's m = 400, m_sobol = 96, k = 3
SERVED_GRIDS = [(1000, 2), (1000, 6), (1000, 10), (1000, 16), (1000, 18), (1000, 20),
                (1000, 42), (400, 6)]


@pytest.mark.parametrize("m,d,skip", [(1000, 9, 0), (256, 18, 0), (1000, 9, 4096), (1, 1, 0)]
                         + [(m, d, 0) for m, d in SERVED_GRIDS]
                         + [(1000, 18, 2**32 - 70), (65536, 64, 99), (777, 64, 2**31 - 300)])
def test_sobol_points_bit_exact_with_plain(dev, m, d, skip):
    """The runs path (its planned run length), points and uniforms bitwise
    the plain version's, and the direct path (the earlier design) too."""
    build.reset_launch_counts()
    got = points(m, d, skip, device=dev)
    u = uniforms(m, d, skip, device=dev)
    direct = sobol_points(m, d, skip, device=dev, run=0)
    assert build.PATHS == {"sobol_points.runs": 2, "sobol_points.direct": 1}
    want = points(m, d, skip, device=dev, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(direct, want)
    assert torch.equal(u.view(torch.int32), to_uniforms(want).view(torch.int32))


@pytest.mark.parametrize("m,d,skip", [(1000, 18, 0), (1000, 42, 2**32 - 40), (65, 7, 5)])
def test_sobol_points_every_run_length_gives_the_plain_bits(dev, m, d, skip):
    want = points(m, d, skip, device=dev, use_kernel=False)
    for run in range(1, MAX_RUN + 1):
        bits = sobol_points(m, d, skip, device=dev, run=run)
        assert torch.equal(bits.to(torch.int64) & 0xFFFFFFFF, want), run


@pytest.mark.parametrize("m,d,skip", [(1000, 18, 0), (65536, 64, 0), (257, 21, 1000)])
def test_public_qmc_grids_launch_sobol_points_and_equal_the_cpu(dev, m, d, skip):
    """``sobol_sequence`` (both ``shift_half``) and ``normal_qmc_samples``
    (with and without a key): one ``sobol_points`` launch each, bitwise the
    plain version on the card and the CPU's grid."""
    from repro_torch import core

    key = threefry.PRNGKey(7)
    calls = [lambda dv, k: core.sobol_sequence(m, d, skip, device=dv, use_kernel=k),
             lambda dv, k: core.sobol_sequence(m, d, skip, shift_half=False, device=dv,
                                               use_kernel=k),
             lambda dv, k: core.normal_qmc_samples(m, d, None, skip, device=dv, use_kernel=k),
             lambda dv, k: core.normal_qmc_samples(m, d, key, skip, device=dv, use_kernel=k)]
    build.reset_launch_counts()
    got = [f(dev, True) for f in calls]
    assert build.PATHS == {"sobol_points.runs": 4}
    for g, f in zip(got, calls):
        assert torch.equal(g.view(torch.int32), f(dev, False).view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), f("cpu", True).view(torch.int32))


@pytest.mark.parametrize("kind", ["rf", "gbm"])
def test_predict_proba_launches_ensemble_sum(dev, kind):
    """A classifier's ``predict_proba``: one ``ensemble_sum`` launch, bitwise
    the plain version's probabilities, in [0, 1]."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2000, 9)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] > 0).astype(np.float32)
    model = (RandomForest(n_trees=16, max_depth=6, task="classification") if kind == "rf"
             else GradientBoosting(n_trees=20, max_depth=5, task="classification")).fit(x, y)
    model.to(dev)
    rows = torch.from_numpy(rng.normal(0, 1, (3817, 9)).astype(np.float32)).to(dev)
    build.reset_launch_counts()
    got = model.predict_proba(rows)
    assert build.LAUNCHES == {"ensemble_sum": 1}
    want = model.predict_proba(rows, use_kernel=False)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(((got >= 0) & (got <= 1)).all())


def test_executor_build_launches_sobol_points_once(dev):
    """One launch covers the AMI and the Saltelli grids, and no request
    launches it again."""
    build.reset_launch_counts()
    run = build_fused_executor(lambda rows, exact: rows[:, 0], k=9, task="regression",
                               m=1000, m_sobol=256, device=dev)
    assert build.LAUNCHES["sobol_points"] == 1
    k, cap = 9, 256
    vals = torch.randn((k, cap), device=dev)
    run(vals, torch.full((k,), cap, dtype=torch.int32, device=dev),
        torch.zeros((k,), dtype=torch.int32, device=dev), 0.1, torch.zeros(0, device=dev))
    assert build.LAUNCHES["sobol_points"] == 1


@pytest.mark.parametrize("k,cap", [(9, 32768), (9, 16384), (9, 1024), (5, 129), (1, 1)])
def test_afc_kernels_match_plain(dev, k, cap):
    rng = np.random.default_rng(cap)
    v = torch.from_numpy(rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)).to(dev)
    z = torch.from_numpy(rng.integers(0, cap + 1, k).astype(np.int32)).to(dev)
    z[0] = 0
    shift = v[:, 0].contiguous()
    torch.testing.assert_close(ops.prefix_power_sums(v, shift),
                               ops.prefix_power_sums(v, shift, use_kernel=False), **TABLE_TOL)
    got = ops.moments(v, z, shift)
    torch.testing.assert_close(got, ops.moments(v, z, shift, use_kernel=False), **TABLE_TOL)
    torch.cuda.synchronize()
    assert (got[0] == 0).all()


def test_afc_kernels_at_60k_within_1e6_of_float64(dev):
    v = _heavy_tailed()
    t = torch.from_numpy(v[None]).to(dev)
    want = np.stack([(v.astype(np.float64) ** p).cumsum() for p in range(1, 5)], axis=-1)
    build.reset_launch_counts()
    tab = ops.prefix_power_sums(t)[0].cpu().numpy()
    assert build.PATHS == {"prefix_power_sums.chunks": 1}
    assert (np.abs(tab - want) / np.abs(want)).max() < 1e-6
    mom = ops.moments(t, torch.tensor([v.size], device=dev))[0].cpu().numpy()
    assert mom[0] == v.size
    assert (np.abs(mom[1:] - want[-1]) / np.abs(want[-1])).max() < 1e-6


_FORESTS = {
    "rf": lambda: RandomForest(n_trees=13, max_depth=6),
    "gbm": lambda: GradientBoosting(n_trees=10, max_depth=5),
    "rf40": lambda: RandomForest(n_trees=40, max_depth=8),          # turbofan's shape
    "gbm60": lambda: GradientBoosting(n_trees=60, max_depth=5),     # sensor_health's
}


def _forest(kind, dev, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (800, 9)).astype(np.float32)
    y = X[:, 0] * 2 + np.sin(3 * X[:, 1])
    return _FORESTS[kind]().fit(X, y).to(dev).ensemble


def _tables(ens):
    return ens.feature, ens.threshold, ens.left, ens.right, ens.value


@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("cap", [1, 129, 2049, 4095, 32768, 65536])
def test_prefix_power_sums_is_bitwise_stable_and_its_emulation(dev, k, cap):
    """The chunked kernel: two launches give the same bits, equal to its
    emulation in PyTorch (chunks of 1024 or 2048 columns that need not
    divide cap), within the table tolerance of the plain version; the rows
    kernel too."""
    rng = np.random.default_rng(k * cap)
    v = torch.from_numpy(rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)).to(dev)
    shift = v[:, 0].contiguous()
    threads = chunk_threads(k, cap)
    assert threads in (256, 512)
    build.reset_launch_counts()
    a, b = prefix_power_sums(v, shift), prefix_power_sums(v, shift)
    rows = prefix_power_sums(v, shift, threads=0)
    assert build.PATHS == {"prefix_power_sums.chunks": 2, "prefix_power_sums.rows": 1}
    want = prefix_power_sums_ref(v, shift)
    emulated = chunked_prefix_power_sums(v, shift, threads=threads)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, emulated)
    torch.testing.assert_close(a, want, **TABLE_TOL)
    torch.testing.assert_close(rows, want, **TABLE_TOL)


def test_prefix_power_sums_replays_in_a_cuda_graph(dev):
    """The chunked kernel's launch state (tickets, flags, epoch) is left
    ready by each launch: launches replayed from a CUDA graph give the
    eager launch's bits, on both chunk sizes."""
    rng = np.random.default_rng(1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for k, cap in ((9, 32768), (3, 65536)):
        v = torch.from_numpy(rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)).to(dev)
        with torch.cuda.stream(side):
            want = prefix_power_sums(v)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                outs = [prefix_power_sums(v) for _ in range(3)]
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            for out in outs:
                assert torch.equal(out, want)


def test_prefix_power_sums_graph_replays_beside_eager_launches(dev):
    """A graph captured on a stream that has launched eagerly keeps a launch
    state of its own: replayed on another stream while eager launches run
    on the capture stream, every table is still the eager launch's bits."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(1.0, 3.0, (9, 32768)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(1.0, 3.0, (3, 65536)).astype(np.float32)).to(dev)
    want_v, want_w = prefix_power_sums(v), prefix_power_sums(w)
    capture, other = torch.cuda.Stream(), torch.cuda.Stream()
    capture.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(capture):
        prefix_power_sums(v)                      # the capture stream's eager state
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture):
            replayed = [prefix_power_sums(v) for _ in range(4)]
    torch.cuda.synchronize()
    eager = []
    for _ in range(25):
        with torch.cuda.stream(other):
            graph.replay()
        with torch.cuda.stream(capture):
            eager += [prefix_power_sums(w), prefix_power_sums(v)]
    torch.cuda.synchronize()
    for out in replayed:
        assert torch.equal(out, want_v)
    for out_w, out_v in zip(eager[::2], eager[1::2]):
        assert torch.equal(out_w, want_w)
        assert torch.equal(out_v, want_v)


@pytest.mark.parametrize("kind", ["rf", "gbm", "rf40", "gbm60"])
@pytest.mark.parametrize("m", [3817, 1001, 2816, 5, 1, 65536])
def test_ensemble_sum_matches_plain_and_is_bitwise_stable(dev, kind, m):
    """Bitwise equal to the plain version (the same tree order), and to
    itself, on the path the planner picks (shared memory up to the served
    megabatches); the global path gives the same bits."""
    ens = _forest(kind, dev, seed=m)
    x = torch.from_numpy(np.random.default_rng(m).normal(0, 1, (m, 9)).astype(np.float32)).to(dev)
    path = plan(*ens.feature.shape, 9, m).path
    assert path == "smem" or m > 3817
    build.reset_launch_counts()
    a, b = predict_sum(ens, x), predict_sum(ens, x)
    assert build.PATHS == {f"ensemble_sum.{path}": 2}
    want = predict_sum(ens, x, use_kernel=False)
    g = ensemble_sum(*_tables(ens), x, depth=ens.depth, launch=Plan(0, 0, 0, 0))
    assert build.PATHS["ensemble_sum.global"] == 1 + 2 * (path == "global")
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a, want)
    assert torch.equal(g, want)


def test_ensemble_sum_every_plan_gives_the_same_bits(dev):
    """turbofan's forest on its megabatch under every row tile and cluster
    size that fits, groups that divide the 40 trees and groups that do not."""
    ens = _forest("rf40", dev)
    m = 3817
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (m, 9)).astype(np.float32)).to(dev)
    want = predict_sum(ens, x, use_kernel=False)
    n_tried = 0
    for p in candidates(40, 511, 9, m):
        for clusters in {1, 7, p.clusters}:
            got = ensemble_sum(*_tables(ens), x, depth=ens.depth, launch=p._replace(
                clusters=min(clusters, -(-m // p.rows))))
            assert torch.equal(got, want), (p, clusters)
            n_tried += 1
    assert n_tried >= 40


def test_ensemble_sum_deep_forest_takes_the_global_path(dev):
    """One complete tree of depth 14 (32767 nodes, 512 KB of tables) cannot
    be staged in shared memory: the global path, bitwise equal to plain."""
    depth, rng = 14, np.random.default_rng(14)
    n_nodes = 2 ** (depth + 1) - 1
    node = np.arange(n_nodes)
    inner = node < 2 ** depth - 1
    feature = np.where(inner, rng.integers(0, 9, n_nodes), 0).astype(np.int32)
    threshold = rng.normal(0, 0.5, n_nodes).astype(np.float32)
    left = np.where(inner, 2 * node + 1, node).astype(np.int32)
    right = np.where(inner, 2 * node + 2, node).astype(np.int32)
    value = rng.normal(0, 1, n_nodes).astype(np.float32)
    ens = TreeEnsemble(feature[None], threshold[None], left[None], right[None], value[None],
                       depth).to(dev)
    x = torch.from_numpy(rng.normal(0, 1, (3817, 9)).astype(np.float32)).to(dev)
    build.reset_launch_counts()
    got = predict_sum(ens, x)
    assert build.PATHS == {"ensemble_sum.global": 1}
    want = predict_sum(ens, x, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _selection_rows(dev, cap, zs, rng, *, inf_row=None):
    """Rows with ties and both signed zeros (values rounded to 0.1), +inf at
    every 97th column of ``inf_row``, and 257 targets in and out of the
    prefix and of the buffer."""
    h = len(zs)
    vals = np.round(rng.normal(0, 2, (h, cap)), 1).astype(np.float32)
    assert (np.signbit(vals) & (vals == 0)).any() and (~np.signbit(vals) & (vals == 0)).any()
    if inf_row is not None:
        vals[inf_row, 7::97] = np.inf
    targets = rng.integers(-3, cap + 3, (h, 257)).astype(np.int32)
    return (torch.from_numpy(vals).to(dev), torch.tensor(zs, dtype=torch.int32, device=dev),
            torch.from_numpy(targets).to(dev))


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("cap", [512, 16384, 32768, 65536])
def test_masked_select_ranks_bitwise_equal_to_plain(dev, cap):
    """z = 0, 1, ~5% of the buffer, one chunk of the radix plan (block 0
    alone), one column past it (the cluster) and 100%; ties, ±0 and +inf in
    the prefix; targets in and out of the prefix and the buffer.  The int32
    bits equal the plain version's (which keeps ±0 in column order), and
    the launch before's, on the radix path."""
    rng = np.random.default_rng(cap)
    chunk = RADIX_THREADS * select_plan(cap).items
    zs = [0, 1, cap // 20, min(chunk, cap), min(chunk + 1, cap), cap]
    vals, z, targets = _selection_rows(dev, cap, zs, rng, inf_row=2)
    targets[2, :5] = torch.arange(5, dtype=torch.int32)
    build.reset_launch_counts()
    got, again = ops.select_ranks(vals, z, targets), ops.select_ranks(vals, z, targets)
    assert build.PATHS == {"masked_select_ranks.radix": 2}
    want = ops.select_ranks(vals, z, targets, use_kernel=False)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(again), _bits(got))
    assert torch.isinf(got[0]).all() and torch.isfinite(got[-1]).all()


@pytest.mark.parametrize("cap", [2048, 32768, 65536])
def test_masked_select_ranks_bootstrap_rows_bitwise_equal_to_plain(dev, cap):
    """The host loop's bootstrap shape: 256 resampled rows of one prefix,
    one target a row (the replicate quantile's rank), at z = 1, the last
    prefix ranked by counting (352), the first sorted (353) and z = cap;
    int32 bits equal to the plain version's on the radix path."""
    rng = np.random.default_rng(cap + 1)
    base = torch.from_numpy(np.round(rng.normal(0, 2, cap), 1).astype(np.float32)).to(dev)
    for zr in (1, 352, 353, cap):
        idx = torch.from_numpy(rng.integers(0, zr, (256, cap))).to(dev)
        rows = base[idx]
        z = torch.full((256,), zr, dtype=torch.int32, device=dev)
        t = torch.full((256, 1), int(0.9 * (zr - 1) + 0.5), dtype=torch.int32, device=dev)
        build.reset_launch_counts()
        got = ops.select_ranks(rows, z, t)
        assert build.PATHS == {"masked_select_ranks.radix": 1}
        want = ops.select_ranks(rows, z, t, use_kernel=False)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(want)), zr


@pytest.mark.parametrize("cap", [1000, 4096, 32768])
def test_masked_select_ranks_every_plan_gives_the_plain_bits(dev, cap):
    """Every radix plan that covers the row (1, 2, 4 or 8 elements a thread,
    clusters of 1..8), and the rank path (PR 13's design), at prefixes
    inside block 0's chunk and across the cluster."""
    rng = np.random.default_rng(cap + 1)
    zs = [0, 3, cap // 7, cap // 2, cap - 1, cap]
    vals, z, targets = _selection_rows(dev, cap, zs, rng, inf_row=3)
    want = _bits(ops.select_ranks(vals, z, targets, use_kernel=False))
    plans = select_candidates(cap) + [SelectPlan(0, 0)]
    assert len(plans) >= 3
    build.reset_launch_counts()
    for p in plans:
        got = masked_select_ranks(vals, z, targets, launch=p)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), want), p
    assert build.PATHS == {"masked_select_ranks.radix": len(plans) - 1,
                           "masked_select_ranks.rank": 1}


def test_masked_select_ranks_nan_where_the_plain_sort_puts_it(dev):
    """NaN sorts above +inf and after the +inf past z, as the plain version
    on the CPU (and the JAX reference) puts it: targets near the end of the
    buffer select the prefix's NaNs in column order, with their own bits,
    the sign-bit one too.  (The card's ``torch.sort`` orders NaNs by their
    bits and puts a sign-bit NaN before −inf, so the plain version runs on
    the CPU here.)  Long prefixes take the radix passes, z = 300 the count."""
    cap = 20000
    rng = np.random.default_rng(9)
    vals, z, targets = _selection_rows(dev, cap, [cap, cap // 2, 5000, 300], rng)
    nan_bits = np.array([0x7FC00000, 0xFFC00001, 0x7F800001], dtype=np.uint32).view(np.float32)
    for f, cols in enumerate([[0, 9, 19999], [3, 4, 9999], [4999], [1, 2, 299]]):
        vals[f, cols] = torch.from_numpy(np.resize(nan_bits, len(cols))).to(dev)
    targets[:, :8] = torch.arange(cap - 8, cap, dtype=torch.int32)
    for p in (select_plan(cap), SelectPlan(8, 3)):
        got = masked_select_ranks(vals, z, targets, launch=p).cpu()
        want = ops.select_ranks(vals.cpu(), z.cpu(), targets.cpu())
        assert torch.equal(_bits(got), _bits(want)), p
    assert torch.isnan(got[:, 7]).all()


def test_afc_rescan_kernels_replay_in_a_cuda_graph_beside_eager_launches(dev):
    """Both rescan kernels captured in one CUDA graph and replayed on another
    stream while eager launches run: every output has the eager launch's
    bits, on each path of each kernel."""
    rng = np.random.default_rng(4)
    vals, z, targets = _selection_rows(dev, 32768, [760, 16384, 32768], rng)
    v4, z4 = vals[:, :4096].contiguous(), z.clamp(max=4096)
    v = torch.from_numpy(rng.normal(1.0, 3.0, (9, 32768)).astype(np.float32)).to(dev)
    zm = torch.tensor([0, 1, 1051, 4096, 4097, 20000, 32767, 32768, 9000],
                      dtype=torch.int32, device=dev)
    shift = v[:, 0].contiguous()
    calls = [lambda: ops.select_ranks(vals, z, targets),
             lambda: masked_select_ranks(v4, z4, targets, launch=SelectPlan(1, 4)),
             lambda: ops.moments(v, zm, shift),
             lambda: sampled_moments(v, zm, shift, blocks=3)]
    want = [c() for c in calls]
    capture, other = torch.cuda.Stream(), torch.cuda.Stream()
    capture.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(capture):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture):
            replayed = [c() for c in calls for _ in range(2)]
    torch.cuda.synchronize()
    eager = []
    for _ in range(10):
        with torch.cuda.stream(other):
            graph.replay()
        with torch.cuda.stream(capture):
            eager += [c() for c in calls]
    torch.cuda.synchronize()
    for i, out in enumerate(replayed):
        assert torch.equal(_bits(out), _bits(want[i // 2]))
    for i, out in enumerate(eager):
        assert torch.equal(_bits(out), _bits(want[i % len(calls)]))


@pytest.mark.parametrize("k,cap", [(9, 32768), (3, 65536), (9, 1024), (5, 129), (2, 4095),
                                   (1, 60000), (9, 512)])
def test_sampled_moments_is_bitwise_its_emulation(dev, k, cap):
    """The cluster kernel at the plan and at other cluster sizes equals its
    emulation bit for bit, and the launch before, at z = 0, 1, z⁰-like,
    a chunk and one past it, and cap, from a row base on a 16-byte boundary
    and 4 bytes past one; it and the rows kernel within the table tolerance
    of the plain version."""
    rng = np.random.default_rng(k * cap + 5)
    blocks = moment_blocks(cap)
    chunk = chunk_cols(cap, blocks)
    zs = [0, 1, min(cap, 1051), min(cap, chunk), min(cap, chunk + 1), cap]
    flat = torch.from_numpy(rng.normal(1.0, 3.0, k * cap + 1).astype(np.float32)).to(dev)
    for turn in range(max(2, -(-len(zs) // k))):
        zv = torch.tensor([zs[(turn * k + i) % len(zs)] for i in range(k)], dtype=torch.int32,
                          device=dev)
        v = flat[turn % 2:][:k * cap].view(k, cap)   # odd turns: 4 bytes past the base
        shift = v[:, 0].contiguous()
        for b in sorted({blocks, 1, 3, 8}):
            build.reset_launch_counts()
            a = sampled_moments(v, zv, shift, blocks=b)
            again = sampled_moments(v, zv, shift, blocks=b)
            assert build.PATHS == {"sampled_moments.cluster": 2}
            emulated = clustered_sampled_moments(v, zv, shift, blocks=b)
            torch.cuda.synchronize()
            assert torch.equal(a, again), b
            assert torch.equal(a, emulated), b
        rows = sampled_moments(v, zv, shift, blocks=0)
        torch.testing.assert_close(rows, sampled_moments_ref(v, zv, shift), **TABLE_TOL)
        torch.testing.assert_close(a, sampled_moments_ref(v, zv, shift), **TABLE_TOL)


def test_wrappers_reject_cpu_tensors(dev):
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        prefix_power_sums(torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        flash_attention(*(torch.zeros((1, 2, 8, 32)) for _ in range(3)))
    with pytest.raises(ValueError, match="exceed 256"):
        flash_attention(*(torch.zeros((1, 2, 8, 288), device=dev) for _ in range(3)))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        masked_select_ranks(torch.zeros((2, 8)), torch.zeros(2, dtype=torch.int32),
                            torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        sampled_moments(torch.zeros((2, 8)), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="expected a CUDA device"):
        sobol_points(8, 2, device="cpu")
    with pytest.raises(ValueError, match="1 to 64 dimensions"):
        sobol_points(8, 65, device=dev)
    with pytest.raises(ValueError, match="points only"):
        sobol_points(8, 2, device=dev, uniforms=True, run=0)
    with pytest.raises(ValueError, match="does not cover"):
        masked_select_ranks(torch.zeros((2, 4096), device=dev),
                            torch.zeros(2, dtype=torch.int32, device=dev),
                            torch.zeros((2, 3), dtype=torch.int32, device=dev),
                            launch=SelectPlan(1, 2))


def test_guarantee_prob_degenerate_sigma_on_card(dev):
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    assert float(guarantee_prob(f(0.0), f(1e-38), f(0.0), f(0.0))) == 0.0


@pytest.mark.parametrize("afc_backend", ["auto", "ref", "incremental"])
def test_kernel_path_matches_plain_path(dev, afc_backend):
    """Served on the card through the kernels and through the plain
    versions: equal plans; every kernel of the path launched."""
    bundle = make_pipeline("turbofan", rows_per_group=1200, n_train_groups=100,
                           n_serve_groups=5, n_requests=4, device=dev)
    cfg = BiathlonConfig(m=192, m_sobol=48, delta=bundle.pipeline.delta_default * 0.3)
    build.reset_launch_counts()
    ks = BiathlonServer(bundle, cfg, afc_backend=afc_backend, device=dev)
    kernel_out = [ks.serve(r) for r in bundle.requests]
    launched = dict(build.LAUNCHES)
    ps = BiathlonServer(bundle, cfg, afc_backend=afc_backend, device=dev, use_kernel=False)
    for a, b in zip([ps.serve(r) for r in bundle.requests], kernel_out):
        assert a["iters"] == b["iters"] and (a["z"] == b["z"]).all()
        assert abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(1.0, abs(a["y_hat"]))
        assert abs(a["prob"] - b["prob"]) <= 1e-4
    # caps are 2048 here, so "auto" takes the incremental path
    afc = "sampled_moments" if afc_backend == "ref" else "prefix_power_sums"
    for name in ("sobol_points", "ensemble_sum", afc):
        assert launched.get(name, 0) > 0, name


@pytest.mark.parametrize("afc_backend", ["auto", "ref", "incremental"])
def test_sensor_health_kernel_plans_equal_plain_plans(dev, afc_backend):
    """The holistic pipeline on the card: kernel and plain paths give one
    plan; the rescan ("ref", and "auto" at these caps of 1024 or less)
    launches ``masked_select_ranks``, the incremental path does not."""
    bundle = make_pipeline("sensor_health", rows_per_group=500, n_train_groups=100,
                           n_serve_groups=5, n_requests=4, device=dev)
    cfg = BiathlonConfig(m=192, m_sobol=48, delta=bundle.pipeline.delta_default * 0.3)
    build.reset_launch_counts()
    ks = BiathlonServer(bundle, cfg, afc_backend=afc_backend, device=dev)
    kernel_out = [ks.serve(r) for r in bundle.requests]
    launched = dict(build.LAUNCHES)
    ps = BiathlonServer(bundle, cfg, afc_backend=afc_backend, device=dev, use_kernel=False)
    for a, b in zip([ps.serve(r) for r in bundle.requests], kernel_out):
        assert a["iters"] == b["iters"] and (a["z"] == b["z"]).all()
        assert abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(1.0, abs(a["y_hat"]))
    assert max(o["cap"] for o in kernel_out) <= 1024
    rescan = afc_backend != "incremental"
    assert (launched.get("masked_select_ranks", 0) > 0) == rescan
    assert launched.get("ensemble_sum", 0) > 0


@pytest.mark.parametrize("name", ["trip_fare", "tick_price", "battery", "bearing_imbalance",
                                  "fraud_detection", "student_qa", "trip_fare_median"])
def test_paper_pipelines_kernel_plans_equal_plain_plans(dev, name):
    """Each of the six other pipelines (and an appendix-D variant) on the
    card at the tight setting: kernel and plain paths give one plan and one
    class; the tree pipelines launch ``ensemble_sum``, the median variant
    ``masked_select_ranks`` (caps of 2048 or less: "auto" rescans at 1024)."""
    make = make_pipeline_median if name.endswith("_median") else make_pipeline
    bundle = make(name.removesuffix("_median"), rows_per_group=600, n_train_groups=100,
                  n_serve_groups=5, n_requests=4, device=dev)
    p = bundle.pipeline
    classify = p.task == "classification"
    cfg = BiathlonConfig(m=192, m_sobol=48, tau=0.995 if classify else 0.95,
                         delta=p.delta_default * (1.0 if classify else 0.3))
    build.reset_launch_counts()
    ks = BiathlonServer(bundle, cfg, afc_backend="ref", device=dev)
    kernel_out = [ks.serve(r) for r in bundle.requests]
    launched = dict(build.LAUNCHES)
    ps = BiathlonServer(bundle, cfg, afc_backend="ref", device=dev, use_kernel=False)
    for a, b in zip([ps.serve(r) for r in bundle.requests], kernel_out):
        assert a["iters"] == b["iters"] and (a["z"] == b["z"]).all()
        if classify:
            assert a["y_hat"] == b["y_hat"]
        else:
            assert abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(1.0, abs(a["y_hat"]))
        assert abs(a["prob"] - b["prob"]) <= 1e-4
    trees = name not in ("tick_price", "bearing_imbalance")
    assert (launched.get("ensemble_sum", 0) > 0) == trees
    assert launched.get("sobol_points", 0) == 1
    assert launched.get("sampled_moments", 0) > 0
    assert (launched.get("masked_select_ranks", 0) > 0) == name.endswith("_median")


def _batch_bundle(dev, name):
    """A small bundle whose groups (1200-2000 rows) all take the 2048 bucket,
    the QMC sizes of the CPU tests, and per-lane knobs for 8 lanes: defaults,
    tight lanes (0.3·δ, or τ = 0.995 for a classifier) capped at 6 and 2
    iterations, a looser lane."""
    bundle = make_pipeline(name, rows_per_group=1600, n_train_groups=100, n_serve_groups=8,
                           n_requests=8, device=dev)
    p = bundle.pipeline
    d = p.delta_default
    if p.task == "classification":
        tight = [SimpleNamespace(delta=d, tau=0.995, iter_cap=c) for c in (6, 2)]
    else:
        tight = [SimpleNamespace(delta=0.3 * d, tau=0.95, iter_cap=c) for c in (6, 2)]
    loose = SimpleNamespace(delta=2.0 * d, tau=0.9, iter_cap=64)
    return bundle, BiathlonConfig(m=192, m_sobol=48), [None, tight[0], loose, tight[1]] * 2


def _host_bits(x):
    """The bits of host float32 values (a numpy array or a list)."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).view(torch.int32)


@pytest.mark.parametrize("afc_backend", ["auto", "ref"])
@pytest.mark.parametrize("name", ["turbofan", "sensor_health", "fraud_detection"])
def test_batched_captured_run_is_bitwise_the_eager_run(dev, name, afc_backend):
    """Batches of 8 lanes at fill 8 and 3 with per-lane knobs: the captured
    graphs and the eager programs give bitwise-equal plans, iterations, ŷ
    and prob on every lane; one capture for the bucket."""
    bundle, cfg, knobs = _batch_bundle(dev, name)
    captured = BatchedFusedServer(bundle, cfg, afc_backend=afc_backend, device=dev)
    eager = BatchedFusedServer(bundle, cfg, afc_backend=afc_backend, device=dev, capture=False)
    iters = []
    for reqs, kn in ((bundle.requests[:8], knobs), (bundle.requests[2:5], knobs[:3])):
        a, b = captured.serve_batch(reqs, knobs=kn), eager.serve_batch(reqs, knobs=kn)
        assert (a.z == b.z).all() and (a.iters == b.iters).all() and a.cap == b.cap == 2048
        assert torch.equal(_host_bits(a.y_hat), _host_bits(b.y_hat))
        assert torch.equal(_host_bits(a.prob), _host_bits(b.prob))
        iters += a.iters.tolist()
    assert max(iters) > 0
    assert captured.compile_count == eager.compile_count == 1
    assert captured._run._slots[(8, 2048, len(bundle.pipeline.exact_features))].graphs
    assert eager._run._slots[(8, 2048, len(bundle.pipeline.exact_features))].graphs is None


@pytest.mark.parametrize("afc_backend", ["auto", "ref"])
@pytest.mark.parametrize("name", ["turbofan", "sensor_health", "fraud_detection"])
def test_batched_kernel_plans_equal_plain_plans(dev, name, afc_backend):
    """The batched path through the kernels and through the plain versions
    (both captured): equal plans and iterations, ŷ within 1e-4·max(1, |y|)
    or the same class; the path's kernels launched (by replays)."""
    bundle, cfg, knobs = _batch_bundle(dev, name)
    build.reset_launch_counts()
    ks = BatchedFusedServer(bundle, cfg, afc_backend=afc_backend, device=dev)
    a = ks.serve_batch(bundle.requests[:8], knobs=knobs)
    launched = dict(build.LAUNCHES)
    ps = BatchedFusedServer(bundle, cfg, afc_backend=afc_backend, device=dev, use_kernel=False)
    b = ps.serve_batch(bundle.requests[:8], knobs=knobs)
    assert (a.z == b.z).all() and (a.iters == b.iters).all()
    assert (np.abs(a.y_hat - b.y_hat) <= 1e-4 * np.maximum(1.0, np.abs(b.y_hat))).all()
    assert (np.abs(a.prob - b.prob) <= 1e-4).all()
    afc = "sampled_moments" if afc_backend == "ref" else "prefix_power_sums"
    assert launched.get(afc, 0) > 0 and launched.get("ensemble_sum", 0) > 0
    assert (launched.get("masked_select_ranks", 0) > 0) == (
        name == "sensor_health" and afc_backend == "ref")


def test_second_batch_at_a_bucket_captures_nothing(dev):
    """The bucket's graphs are captured once; a later batch of another fill
    and other knobs replays them (its launches counted a replay each)."""
    bundle, cfg, knobs = _batch_bundle(dev, "turbofan")
    srv = BatchedFusedServer(bundle, cfg, device=dev)
    srv.serve_batch(bundle.requests[:8], knobs=knobs)
    (slot,) = srv._run._slots.values()
    graphs = slot.graphs
    build.reset_launch_counts()
    res = srv.serve_batch(bundle.requests[3:5], knobs=knobs[1:3])
    assert srv.compile_count == 1 and srv._run.slots_built == 1 and slot.graphs is graphs
    assert build.LAUNCHES["prefix_power_sums"] == 1          # the z⁰ graph, replayed once
    # z⁰, then (if a lane iterates) the Saltelli block and at least one step an iteration
    assert build.LAUNCHES["ensemble_sum"] >= 1 + (1 + res.batch_iters if res.batch_iters else 0)
    assert build.PATHS["prefix_power_sums.chunks"] == 1


def test_capture_survives_collectable_graphs(dev):
    """Executors left in reference cycles hold graphs that only the garbage
    collector frees; with the collector run every few allocations, new
    captures must still succeed (destroying a graph inside a capture would
    invalidate it) and give the eager bits."""
    import gc

    bundle = make_pipeline("turbofan", rows_per_group=600, n_train_groups=100,
                           n_serve_groups=5, n_requests=4, device=dev)
    cfg = BiathlonConfig(m=192, m_sobol=48, delta=bundle.pipeline.delta_default * 0.3)
    thresholds = gc.get_threshold()
    gc.set_threshold(10)
    try:
        for req in bundle.requests:
            srv = BiathlonServer(bundle, cfg, device=dev)
            srv.cycle = srv            # freed by the collector only
            out = srv.serve(req)
            want = BiathlonServer(bundle, cfg, device=dev, capture=False).serve(req)
            assert out["iters"] == want["iters"] and (out["z"] == want["z"]).all()
            assert torch.equal(_host_bits([out["y_hat"]]), _host_bits([want["y_hat"]]))
            del srv
    finally:
        gc.set_threshold(*thresholds)


def test_single_request_captured_equals_eager(dev):
    """``BiathlonServer(mode="fused")`` is the one-lane case: captured and
    eager give the same bits."""
    bundle = make_pipeline("sensor_health", rows_per_group=1600, n_train_groups=100,
                           n_serve_groups=5, n_requests=4, device=dev)
    cfg = BiathlonConfig(m=192, m_sobol=48, delta=bundle.pipeline.delta_default * 0.3)
    a_srv = BiathlonServer(bundle, cfg, device=dev)
    b_srv = BiathlonServer(bundle, cfg, device=dev, capture=False)
    for req in bundle.requests:
        a, b = a_srv.serve(req), b_srv.serve(req)
        assert a["iters"] == b["iters"] and (a["z"] == b["z"]).all()
        assert torch.equal(_host_bits([a["y_hat"], a["prob"]]),
                           _host_bits([b["y_hat"], b["prob"]]))


@pytest.mark.parametrize("name", ["turbofan", "sensor_health"])
def test_cached_batches_are_bitwise_the_uncached_and_a_hit_launches_nothing(dev, name):
    """``BatchedFusedServer(cache_size=...)`` at fill 8 and 3: the miss batch
    (one ``prefix_power_sums`` launch for all its misses, none in the
    executor) and the hit batch (no launch, no slot) give the uncached
    captured server's bits on every lane."""
    bundle, cfg, knobs = _batch_bundle(dev, name)
    plain = BatchedFusedServer(bundle, cfg, device=dev)
    cached = BatchedFusedServer(bundle, cfg, cache_size=16, device=dev)
    distinct = len({tuple(bundle.pipeline.agg_specs(r)) for r in bundle.requests[:8]})
    for first, reqs, kn in ((True, bundle.requests[:8], knobs),
                            (False, bundle.requests[2:5], knobs[:3])):
        want = plain.serve_batch(reqs, knobs=kn)
        for turn in ("miss", "hit"):
            torch.cuda.synchronize()
            build.reset_launch_counts()
            slots = cached.compile_count
            got = cached.serve_batch(reqs, knobs=kn)
            torch.cuda.synchronize()
            launches = build.LAUNCHES.get("prefix_power_sums", 0)
            assert (got.z == want.z).all() and (got.iters == want.iters).all(), turn
            assert torch.equal(_host_bits(got.y_hat), _host_bits(want.y_hat)), turn
            assert torch.equal(_host_bits(got.prob), _host_bits(want.prob)), turn
            if turn == "miss" and first:
                assert launches == 1, launches
            else:
                assert launches == 0 and cached.compile_count == slots, turn
    assert cached.compile_count == 1
    assert cached.cache.stats["misses"] == distinct
    assert cached.cache.stats["hits"] == 8 - distinct + 8 + 2 * 3


def test_cached_single_request_hit_builds_no_slot_and_launches_no_prefix(dev):
    bundle, cfg, _ = _batch_bundle(dev, "turbofan")
    srv = BiathlonServer(bundle, cfg, cache_size=4, device=dev)
    want = BiathlonServer(bundle, cfg, device=dev).serve(bundle.requests[0])
    miss = srv.serve(bundle.requests[0])
    torch.cuda.synchronize()
    build.reset_launch_counts()
    hit = srv.serve(bundle.requests[0])
    torch.cuda.synchronize()
    assert build.LAUNCHES.get("prefix_power_sums", 0) == 0 and srv.compile_count == 1
    for got in (miss, hit):
        assert got["iters"] == want["iters"] and (got["z"] == want["z"]).all()
        assert torch.equal(_host_bits([got["y_hat"], got["prob"]]),
                           _host_bits([want["y_hat"], want["prob"]]))


# ----------------------------------------------------- continuous batching
def _table_trace(srv, bundle, knobs, chunks_before_recycle=1):
    """Admit 8 requests with their knobs, run chunks; after the first chunk
    refill every done lane with requests 8..; drain.  Returns every
    read-back along the way."""
    reqs = bundle.requests
    cap = srv.trace_cap(reqs)
    table, _ = srv.admit(srv.new_table(cap), cap,
                         [(lane, reqs[lane], knobs[lane]) for lane in range(8)])
    outs = [srv.readback(table)]
    nxt = 8
    for step in range(200):
        out = outs[-1]
        if step >= chunks_before_recycle and nxt < len(reqs) and out["done"].any():
            free = [int(lane) for lane in np.flatnonzero(out["done"])][:len(reqs) - nxt]
            srv.admit(table, cap, [(lane, reqs[nxt + i], knobs[lane])
                                   for i, lane in enumerate(free)])
            nxt += len(free)
            outs.append(srv.readback(table))
            continue
        if out["done"].all():
            return outs
        outs.append(srv.readback(srv.run_chunk(table)))
    raise AssertionError("the table never drained")


def _same_readbacks(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for key in ("z", "it", "n", "done", "active"):
            assert (x[key] == y[key]).all(), key
        for key in ("y_hat", "prob"):
            assert torch.equal(_host_bits(x[key]), _host_bits(y[key])), key


@pytest.mark.parametrize("afc_backend", ["auto", "ref"])
@pytest.mark.parametrize("name", ["turbofan", "sensor_health", "fraud_detection"])
def test_continuous_captured_table_is_bitwise_the_eager_table(dev, name, afc_backend):
    """The captured lane table (refill and lane-write graphs, the step
    graph) against the eager programs on the same trace: 8 lanes with
    knobs, done lanes refilled after the first chunk, every read-back
    bitwise equal; two slots for the bucket, each captured."""
    bundle, cfg, knobs = _batch_bundle(dev, name)
    bundle.requests = bundle.requests + bundle.requests[:4]
    kw = dict(batch_size=8, chunk_iters=2, afc_backend=afc_backend, device=dev)
    captured = ContinuousBatchedServer(bundle, cfg, **kw)
    eager = ContinuousBatchedServer(bundle, cfg, capture=False, **kw)
    a, b = _table_trace(captured, bundle, knobs), _table_trace(eager, bundle, knobs)
    _same_readbacks(a, b)
    assert max(int(o["it"].max()) for o in a) > 0
    assert captured.compile_count == eager.compile_count == 2
    (table,) = captured._exe._tables.values()
    assert table.graphs and table.src.graphs


def test_one_refill_graph_serves_every_lane(dev):
    """One request admitted into each of the 8 lanes in turn, each by its
    own admission: the same captured refill and lane-write graphs serve
    every lane, and every lane holds the bits of the eager refill."""
    bundle, cfg, knobs = _batch_bundle(dev, "sensor_health")
    srv = ContinuousBatchedServer(bundle, cfg, batch_size=8, device=dev)
    eager = ContinuousBatchedServer(bundle, cfg, batch_size=8, device=dev, capture=False)
    cap = srv.trace_cap(bundle.requests)
    table, etable = srv.new_table(cap), eager.new_table(cap)
    graphs = (table.graphs, table.src.graphs)
    eager.admit(etable, cap, [(0, bundle.requests[1], knobs[1])])
    want = eager.readback(etable)
    for lane in range(8):
        srv.admit(table, cap, [(lane, bundle.requests[1], knobs[1])])
    out = srv.readback(table)
    assert (table.graphs, table.src.graphs) == graphs and srv.compile_count == 2
    for lane in range(8):
        assert (out["z"][lane] == want["z"][0]).all() and out["it"][lane] == 0
        assert torch.equal(_host_bits(out["y_hat"][lane:lane + 1]), _host_bits(want["y_hat"][:1]))
        assert torch.equal(_host_bits(out["prob"][lane:lane + 1]), _host_bits(want["prob"][:1]))


def test_restore_then_replay_is_bitwise(dev):
    """A checkpoint taken at a chunk boundary, a chunk, the carry wrecked
    (``scramble_chunk_carry``) and restored: the replayed chunk gives the
    first chunk's bits, and the table drains as the fault-free one."""
    bundle, cfg, knobs = _batch_bundle(dev, "turbofan")
    srv = ContinuousBatchedServer(bundle, cfg, batch_size=8, chunk_iters=2, device=dev)
    cap = srv.trace_cap(bundle.requests)
    table, _ = srv.admit(srv.new_table(cap), cap,
                         [(lane, bundle.requests[lane], knobs[lane]) for lane in range(8)])
    ckpt = srv.snapshot(table)
    first = srv.readback(srv.run_chunk(table))
    scramble_chunk_carry(table)
    assert (srv.readback(table)["z"] == -1).all()
    srv.restore(table, ckpt)
    again = srv.readback(srv.run_chunk(table))
    _same_readbacks([first], [again])
    assert srv.compile_count == 2


def test_cleared_poisoned_lane_leaves_the_context_healthy(dev):
    """A lane poisoned after a chunk (``z = -1``, NaN ŷ and prob) is cleared
    before the next replay; the table then drains, the card stays healthy,
    and requests admitted afterwards (the poisoned one into its own lane
    again) get the bits of a fresh table."""
    bundle, cfg, knobs = _batch_bundle(dev, "sensor_health")
    srv = ContinuousBatchedServer(bundle, cfg, batch_size=8, chunk_iters=2, device=dev)
    cap = srv.trace_cap(bundle.requests)
    assign = [(lane, bundle.requests[lane], knobs[lane]) for lane in range(8)]
    table, _ = srv.admit(srv.new_table(cap), cap, assign)
    srv.run_chunk(table)
    poison_lane_carry(table, 1)
    assert np.isnan(srv.readback(table)["y_hat"][1])
    srv.clear_lanes(table, [1])
    for _ in range(50):
        if srv.readback(srv.run_chunk(table))["done"].all():
            break
    torch.cuda.synchronize()
    got = _table_trace(srv, bundle, knobs, chunks_before_recycle=10**6)
    fresh = ContinuousBatchedServer(bundle, cfg, batch_size=8, chunk_iters=2, device=dev)
    _same_readbacks(got, _table_trace(fresh, bundle, knobs, chunks_before_recycle=10**6))
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["turbofan", "sensor_health"])
def test_cached_refill_launches_no_prefix_power_sums(dev, name):
    """A cached table: a miss admission builds its entry by one ``cold``
    launch, a hit admission launches no ``prefix_power_sums``, gathers
    nothing and builds no slot; both give the uncached table's bits."""
    bundle, cfg, knobs = _batch_bundle(dev, name)
    plain = ContinuousBatchedServer(bundle, cfg, batch_size=8, device=dev)
    cached = ContinuousBatchedServer(bundle, cfg, batch_size=8, cache_size=16, device=dev)
    cap = plain.trace_cap(bundle.requests)
    assign = [(lane, bundle.requests[lane], knobs[lane]) for lane in range(8)]
    want = plain.readback(plain.admit(plain.new_table(cap), cap, assign)[0])
    for turn in ("miss", "hit"):
        table = cached.new_table(cap)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        got = cached.readback(cached.admit(table, cap, assign)[0])
        launches = build.LAUNCHES.get("prefix_power_sums", 0)
        _same_readbacks([got], [want])
        if turn == "hit":
            assert launches == 0
        else:
            assert launches == len({tuple(bundle.pipeline.agg_specs(r))
                                    for r in bundle.requests[:8]})
    assert cached.compile_count == 2


@pytest.mark.parametrize("name", ["turbofan", "sensor_health", "fraud_detection"])
def test_a_request_gets_the_same_bits_in_every_lane(dev, name):
    """One request in all 8 lanes, at a tight setting: the batch gives every
    lane the same bits, and so does the lane table after every chunk (each
    lane's model outputs start 16-byte aligned, so the card's reductions
    split every lane's rows alike)."""
    bundle, cfg, knobs = _batch_bundle(dev, name)
    batched = BatchedFusedServer(bundle, cfg, device=dev)
    table_srv = ContinuousBatchedServer(bundle, cfg, batch_size=8, chunk_iters=1, device=dev)
    iterated = 0
    for req in bundle.requests[:4]:
        res = batched.serve_batch([req] * 8, knobs=[knobs[1]] * 8)
        for field in ("y_hat", "prob"):
            bits = _host_bits(getattr(res, field))
            assert (bits == bits[0]).all(), (field, res.iters.tolist())
        assert (res.z == res.z[0]).all() and (res.iters == res.iters[0]).all()
        cap = table_srv.trace_cap([req])
        table, _ = table_srv.admit(table_srv.new_table(cap), cap,
                                   [(lane, req, knobs[1]) for lane in range(8)])
        out = table_srv.readback(table)
        while True:
            for field in ("y_hat", "prob"):
                bits = _host_bits(out[field])
                assert (bits == bits[0]).all(), (field, out["it"].tolist())
            assert (out["z"] == out["z"][0]).all()
            if out["done"].all():
                break
            out = table_srv.readback(table_srv.run_chunk(table))
        iterated += int(out["it"][0])
    assert iterated > 0


def test_pinned_gather_is_the_pageable_gather(dev):
    """The pinned staging buffer, copied asynchronously, and reused by a
    second gather: each copy holds the pageable gather's bits."""
    from repro_torch.data.store import HostStaging

    bundle, _, _ = _batch_bundle(dev, "sensor_health")
    p, store = bundle.pipeline, bundle.store
    staging = HostStaging(dev)
    for reqs in (bundle.requests[:8], bundle.requests[3:6]):
        specs = [p.agg_specs(r) for r in reqs]
        buf = staging.gather(store, specs, 2048, rows=8)
        assert buf.is_pinned() and tuple(buf.shape) == (8, p.k, 2048)
        got = staging.to_device(buf)
        want = torch.zeros((8, p.k, 2048), device=dev)
        for i, sp in enumerate(specs):
            want[i] = store.request_buffers(sp, 2048, dev)[0]
        assert torch.equal(got, want)


@pytest.mark.parametrize("k", [9, 72])
def test_prefix_power_sums_at_the_cached_cap_512(dev, k):
    """A cached server runs ``prefix_power_sums`` at caps of 1024 and below,
    which the uncached path rescans: (k, 512) and (8·k, 512) twice, bitwise
    equal, and within the tables' tolerance of the plain version."""
    rng = np.random.default_rng(k)
    vals = torch.from_numpy(rng.normal(1.0, 2.0, (k, 512)).astype(np.float32)).to(dev)
    shift = vals[:, 0].contiguous()
    a, b = prefix_power_sums(vals, shift), prefix_power_sums(vals, shift)
    assert torch.equal(a, b)
    torch.testing.assert_close(a, prefix_power_sums_ref(vals, shift), **TABLE_TOL)


@pytest.mark.parametrize("z", [0, 1, 353, 1499, 1500, 2048])
def test_host_loop_draws_on_card_equal_cpu(dev, z):
    """The host loop's random draws on the card are the CPU's (and so the
    reference's, ``tests/test_torch_host_loop.py``): the keyed QMC uniforms
    and the holistic estimates, value and bootstrap replicates, bit for
    bit; parametric estimates within float32 summation order."""
    key = threefry.PRNGKey(z)
    u = qmc_uniforms(1000, 9, key, device=dev)
    assert torch.equal(u.cpu().view(torch.int32),
                       qmc_uniforms(1000, 9, key, device="cpu").view(torch.int32))
    rng = np.random.default_rng(3)
    n = 1500 if z <= 1500 else 5000
    vals = np.zeros(2048, np.float32)
    vals[: min(n, 2048)] = np.round(rng.gamma(2.0, 3.0, min(n, 2048)), 2)
    for agg in ("median", "quantile", "avg", "std"):
        a = aggregates.estimate(agg, torch.from_numpy(vals).to(dev), z, n, key, quantile=0.9)
        b = aggregates.estimate(agg, torch.from_numpy(vals), z, n, key, quantile=0.9)
        if agg in aggregates.HOLISTIC_AGGS:
            assert torch.equal(a.replicates.cpu().view(torch.int32), b.replicates.view(torch.int32))
            assert torch.equal(a.value.cpu().view(torch.int32), b.value.view(torch.int32))
        else:
            torch.testing.assert_close(a.value.cpu(), b.value, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(a.sigma.cpu(), b.sigma, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3, 5, 8, 9, 10, 21])
def test_host_loop_sobol_grids_equal_plain(dev, k):
    """Every QMC grid the host loop draws at ``BiathlonConfig()``'s m = 1000
    and m_sobol = 256, for each pipeline's k: (m, k) for AMI and (m_sobol,
    2k) for the indices, odd dimensions (a partial tile of runs) included.
    The kernel's points equal the plain version's, and the keyed uniforms
    are the CPU's bit for bit."""
    key = threefry.PRNGKey(k)
    for m, d in ((1000, k), (256, 2 * k)):
        assert torch.equal(points(m, d, 0, device=dev),
                           points(m, d, 0, device=dev, use_kernel=False))
        u = qmc_uniforms(m, d, key, device=dev)
        assert torch.equal(u.cpu().view(torch.int32),
                           qmc_uniforms(m, d, key, device="cpu").view(torch.int32))


@pytest.mark.parametrize("name", ["turbofan", "fraud_detection", "sensor_health"])
def test_host_mode_kernel_plans_equal_plain_plans(dev, name):
    """The host-loop server on the card, through the kernels and through the
    plain versions, at the tight setting: one plan, one iteration count, one
    class; the exact baseline gives one answer on both paths.  Every QMC
    grid is a ``sobol_points`` launch, the tree models launch
    ``ensemble_sum`` and the holistic estimates ``masked_select_ranks``."""
    bundle = make_pipeline(name, rows_per_group=1200, n_train_groups=100, n_serve_groups=5,
                           n_requests=4, device=dev)
    p = bundle.pipeline
    classify = p.task == "classification"
    cfg = BiathlonConfig(m=192, m_sobol=48, tau=0.995 if classify else 0.95,
                         delta=p.delta_default * (1.0 if classify else 0.3))
    build.reset_launch_counts()
    ks = BiathlonServer(bundle, cfg, mode="host", device=dev)
    kernel = ks.serve_all(seed=1)
    launched = dict(build.LAUNCHES)
    ps = BiathlonServer(bundle, cfg, mode="host", device=dev, use_kernel=False)
    build.reset_launch_counts()
    plain = ps.serve_all(seed=1)
    assert not build.LAUNCHES
    assert kernel.iters == plain.iters and kernel.sample_fracs == plain.sample_fracs
    assert kernel.y_exacts == plain.y_exacts
    for a, b in zip(plain.y_hats, kernel.y_hats):
        assert (a == b) if classify else abs(a - b) <= 1e-4 * max(1.0, abs(a))
    for i, req in enumerate(bundle.requests):
        a = ps.serve(req, threefry.PRNGKey(i))
        b = ks.serve(req, threefry.PRNGKey(i))
        assert (a["z"] == b["z"]).all() and a["iters"] == b["iters"]
    assert max(kernel.iters) > 1
    assert launched.get("sobol_points", 0) >= sum(kernel.iters)
    assert launched.get("ensemble_sum", 0) > 0
    assert (launched.get("masked_select_ranks", 0) > 0) == (name == "sensor_health")
    assert not launched.get("prefix_power_sums") and not launched.get("sampled_moments")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,dv,model_layout", [
    (1, 4, 4, 48, 48, 64, 64, False),       # the LM-head prompt, ragged against the tiles
    (2, 4, 2, 100, 100, 32, 32, False),     # ragged, GQA
    (1, 2, 2, 100, 37, 128, 128, False),    # Sq > Sk
    (1, 2, 1, 48, 130, 256, 256, False),    # Sq < Sk, D = 256
    (1, 2, 2, 64, 64, 192, 128, False),     # D != Dv (MLA's 192/128)
    # the bf16 kernel's edges: 128-row q tiles, 128-key tiles (64 at D = 256)
    (1, 2, 2, 127, 127, 64, 64, False),
    (1, 2, 2, 128, 128, 64, 64, False),
    (1, 2, 2, 129, 129, 64, 64, False),
    (1, 2, 2, 127, 129, 64, 64, False),
    (1, 2, 2, 129, 127, 64, 64, False),
    (1, 2, 1, 129, 127, 256, 256, False),
    (1, 2, 2, 512, 512, 256, 256, False),   # D = Dv = 256 over 8 key tiles of 64
    (1, 16, 16, 4096, 4096, 64, 64, False),  # the 4096-token prefill
    (1, 8, 1, 1024, 1024, 128, 128, False),  # 8-on-1 GQA
    (1, 16, 4, 300, 300, 64, 64, True),     # (B, S, H, D) tensors read as strided views
    (1, 2, 2, 100, 100, 36, 36, False),     # 72-byte rows: no TMA, the producer loads
])
def test_flash_attention_matches_plain(dev, dtype, causal, b, h, hkv, sq, sk, d, dv,
                                       model_layout):
    rng = np.random.default_rng(sq * 1000 + sk + d)
    shapes = ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv))
    if model_layout:
        q, k, v = (torch.from_numpy(rng.normal(0, 1, (s[0], s[2], s[1], s[3])).astype(np.float32))
                   .to(dev, dtype).transpose(1, 2) for s in shapes)
    else:
        q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dev, dtype)
                   for s in shapes)
    build.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    # bf16 views whose rows are not a multiple of 16 bytes are the only ones
    # TMA cannot read
    path = "simt" if dtype == torch.float32 else "loads" if d % 8 or dv % 8 else "tma"
    assert build.PATHS == {f"flash_attention.{path}": 1}
    rep = h // hkv
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    want = flash_attention_ref(q, kr, vr, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, sq, dv)
    assert got.stride(1) < got.stride(2) if model_layout else got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    if dtype == torch.bfloat16:
        # the same roundings in PyTorch: what is left is the order of the
        # tensor cores' float32 sums and ex2.approx, then one bf16 rounding
        emulated = bf16_path(q, kr, vr, causal=causal, block_k=key_tile(d, dv))
        torch.testing.assert_close(got.float(), emulated.float(), **EMULATION_TOL)


@pytest.mark.parametrize("seed", [65536, 5, 6])
def test_flash_attention_at_65536_batch_heads(dev, seed):
    """B·H = 65536 (batch 4096 × 16 heads, 16 tokens, bf16 causal), past the
    65535 that a grid's y axis takes: every head launches, within the card
    tolerance of the plain version, and within one bf16 ulp of the emulation
    plus each output's slack from p's the kernel may round to the other
    side of a bf16 tie (rows of 1 to 16 keys, where one such p can move an
    output by several ulps)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (4096, 16, 16, 64)).astype(np.float32))
               .to(dev, torch.bfloat16) for _ in range(3))
    build.reset_launch_counts()
    got = flash_attention(q, k, v, causal=True)
    assert build.PATHS == {"flash_attention.tma": 1}
    want = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[torch.bfloat16])
    emulated, slack = bf16_path(q, k, v, causal=True, block_k=key_tile(64, 64), slack=True)
    assert int(beyond(got, emulated, slack, **EMULATION_TOL).sum()) == 0


def test_flash_attention_is_deterministic(dev):
    """Two launches on one input give bitwise-equal outputs (no atomics, a
    fixed order of tiles), at the 4096 prefill and under GQA."""
    rng = np.random.default_rng(15)
    for shape in ((1, 16, 16, 4096, 64), (1, 8, 1, 1024, 128)):
        b, h, hkv, s, d = shape
        q, k, v = (torch.from_numpy(rng.normal(0, 1, sh).astype(np.float32)).to(dev, torch.bfloat16)
                   for sh in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        assert torch.equal(flash_attention(q, k, v), flash_attention(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,dv,window", [
    (1, 2, 2, 300, 300, 64, 64, 5),        # a window under one tile
    (1, 2, 2, 300, 300, 64, 64, 128),      # a tile's width
    (1, 2, 1, 520, 520, 64, 64, 129),      # across tile edges, GQA
    (1, 2, 2, 1000, 1000, 128, 128, 300),
    (1, 2, 2, 200, 200, 256, 256, 70),     # 64-key tiles at D = 256
    (1, 2, 2, 130, 130, 64, 64, 130),      # the window covers every key (W >= Sk)
    (1, 2, 2, 130, 130, 64, 64, 1000),
    (1, 4, 4, 700, 700, 80, 80, 256),      # zamba2's head dim 80 (DP = 128)
    (2, 2, 2, 256, 1024, 64, 64, 100),     # Sq < Sk (seamless's cross shape)
    (1, 2, 2, 600, 300, 64, 64, 400),      # Sq > Sk, Sq - W < Sk
    (1, 2, 2, 300, 300, 36, 36, 77),       # 72-byte rows: the producer loads
])
def test_flash_attention_window_matches_plain(dev, dtype, causal, b, h, hkv, sq, sk, d, dv,
                                              window):
    """A sliding window on both kernels: keys at or below q − W masked, the
    tiles wholly below it skipped; within the card tolerance of the plain
    version and, bf16, one ulp of the emulated roundings plus each output's
    tie slack."""
    rng = np.random.default_rng(sq * 7 + window + d)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dev, dtype)
               for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv)))
    build.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window)
    path = "simt" if dtype == torch.float32 else "loads" if d % 8 else "tma"
    assert build.PATHS == {f"flash_attention.{path}": 1}
    rep = h // hkv
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    want = flash_attention_ref(q, kr, vr, causal=causal, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
    if dtype == torch.bfloat16:
        emulated, slack = bf16_path(q, kr, vr, causal=causal, block_k=key_tile(d, dv),
                                    slack=True, window=window)
        assert int(beyond(got, emulated, slack, **EMULATION_TOL).sum()) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_window_zero_is_no_window(dev, dtype):
    """``window=0`` and a window past every key give bitwise-equal outputs
    (no key masked, no tile skipped), and a window that leaves a row without
    a key is refused."""
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 4, 700, 64)).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    for causal in (True, False):
        base = flash_attention(q, k, v, causal=causal)
        assert torch.equal(base, flash_attention(q, k, v, causal=causal, window=0))
        assert torch.equal(base, flash_attention(q, k, v, causal=causal, window=700 + 128))
    with pytest.raises(ValueError, match="without a key"):
        flash_attention(q, k[:, :, :100], v[:, :, :100], causal=False, window=600)
    with pytest.raises(ValueError, match="without a key"):
        flash_attention(q, k, v, window=-1)


def test_attention_routes_to_the_kernel_on_the_card(dev):
    """A CUDA tensor launches the kernel (one count per call, reading the
    model layout in place); ``use_kernel=False`` launches nothing; a sliding
    window launches the kernel with the window."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dev, torch.bfloat16)
               for s in ((2, 48, 4, 32), (2, 48, 2, 32), (2, 48, 2, 32)))
    build.reset_launch_counts()
    got = attn_ops.attention(q, k, v)
    assert build.LAUNCHES["flash_attention"] == 1
    want = attn_ops.attention(q, k, v, use_kernel=False)
    assert build.LAUNCHES["flash_attention"] == 1
    torch.cuda.synchronize()
    assert got.shape == (2, 48, 4, 32) and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[torch.bfloat16])
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
    layer0 = {n: t[0] for n, t in params["blocks"]["attn"].items()}
    x = torch.from_numpy(rng.normal(0, 1, (1, 48, cfg.d_model)).astype(np.float32)).to(
        dev, torch.bfloat16)
    build.reset_launch_counts()
    got = attention_block(layer0, x, cfg, window=16)
    assert build.LAUNCHES["flash_attention"] == 1
    want = attention_block(layer0, x, cfg, window=16, use_kernel=False)
    assert build.LAUNCHES["flash_attention"] == 1
    torch.cuda.synchronize()
    err = (got - want).float().abs().max() / want.float().abs().max()
    assert float(err) < 3e-2


def test_lm_backbone_kernel_matches_plain(dev):
    """The reduced qwen1.5-0.5b (GQA) on the card: one launch per layer, and
    the plain path's hidden states within two bf16 ulps of the largest."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 48))).to(dev)
    outs = {}
    for use_kernel in (True, False):
        lm = LM(cfg, use_kernel=use_kernel)
        build.reset_launch_counts()
        outs[use_kernel] = lm._backbone(params, lm.embed(params, tokens)).float()
        assert build.LAUNCHES["flash_attention"] == (cfg.n_layers if use_kernel else 0)
    torch.cuda.synchronize()
    err = (outs[True] - outs[False]).abs().max() / outs[False].abs().max()
    assert float(err) < 3e-2


def _serving_cfg(kind: str):
    """Reduced configs at the served head dims: MLA's q/k 192 and v 128
    (deepseek-v2-236b's dims on 4 heads, its FFNs dense: a top-k choice
    within a bf16 rounding of a tie would let the two paths route apart),
    and gemma-7b's 256."""
    if kind == "mla":
        cfg = get_config("deepseek-v2-236b").reduced()
        return dataclasses.replace(cfg, family="dense", moe=None, mla=MLAConfig())
    return dataclasses.replace(get_config("gemma-7b").reduced(), head_dim=256)


@pytest.mark.parametrize("kind", ["mla", "head_dim_256"])
def test_lm_prefill_kernel_matches_plain_at_served_head_dims(dev, kind):
    """Prefill and two decode steps, kernel path against plain path: one
    flash_attention launch a layer (dense0 included) in prefill, none in
    decode; logits and caches within 3e-2 relative."""
    cfg = _serving_cfg(kind)
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 200))).to(dev)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 2, 1))).to(dev)
    outs = {}
    for use_kernel in (True, False):
        lm = LM(cfg, use_kernel=use_kernel)
        build.reset_launch_counts()
        logits, cache = lm.prefill(params, tokens)
        assert build.LAUNCHES["flash_attention"] == (cfg.n_layers if use_kernel else 0)
        got = [logits]
        for tok in steps:
            logits, cache = lm.decode_step(params, cache, tok)
            got.append(logits)
        assert build.LAUNCHES["flash_attention"] == (cfg.n_layers if use_kernel else 0)
        outs[use_kernel] = got + [cache[n] for n in sorted(cache) if n != "pos"]
    torch.cuda.synchronize()
    for a, b in zip(outs[True], outs[False]):
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        live = b > -1e29
        assert float((a - b)[live].abs().max() / b[live].abs().max()) < 3e-2


def _family_cfg(arch: str):
    """Reduced configs of the SSM, hybrid and audio families; zamba2's at
    its published head dim 80."""
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, head_dim=80) if cfg.family == "hybrid" else cfg


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "seamless-m4t-large-v2", "xlstm-1.3b"])
def test_lm_families_kernel_matches_plain(dev, arch):
    """Prefill and two decode steps of the SSM, hybrid and audio families,
    kernel path against plain path: flash_attention once a group (hybrid,
    windowed, S = 200 past its window of 64) or once an encoder layer and
    twice a decoder layer (audio: causal self and non-causal cross
    attention, Sq 200 on Sk 8 frames) in prefill, never in decode, never
    in the xLSTM; logits and caches within 3e-2 relative."""
    cfg = _family_cfg(arch)
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 200))).to(dev)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 2, 1))).to(dev)
    fe = (torch.from_numpy(rng.normal(0, 1, (2, cfg.n_frontend_tokens, cfg.d_model))
                           .astype(np.float32)).to(dev) if cfg.frontend else None)
    launches = {"hybrid": cfg.n_layers // max(cfg.attn_every, 1),
                "audio": cfg.enc_layers + 2 * cfg.n_layers, "ssm": 0}[cfg.family]
    outs = {}
    for use_kernel in (True, False):
        lm = LM(cfg, use_kernel=use_kernel)
        build.reset_launch_counts()
        logits, cache = lm.prefill(params, tokens, fe)
        assert build.LAUNCHES["flash_attention"] == (launches if use_kernel else 0)
        got = [logits]
        for tok in steps:
            logits, cache = lm.decode_step(params, cache, tok)
            got.append(logits)
        assert build.LAUNCHES["flash_attention"] == (launches if use_kernel else 0)
        if use_kernel and launches:
            assert set(build.PATHS) == {"flash_attention.tma"}
        outs[use_kernel] = got + [cache[n] for n in sorted(cache) if n != "pos"]
    torch.cuda.synchronize()
    for a, b in zip(outs[True], outs[False]):
        a, b = a.float(), b.float()
        assert bool(torch.isfinite(a).all())
        live = b > -1e29
        assert float((a - b)[live].abs().max() / b[live].abs().max()) < 3e-2


def test_sorted_moe_is_bitwise_run_to_run_on_the_card(dev):
    cfg = get_config("granite-moe-1b-a400m").reduced()
    p = lm_moe.init_moe(torch.Generator(device=dev).manual_seed(0), cfg.d_model, cfg.moe,
                        torch.bfloat16)
    x = torch.randn((2, 512, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    runs = [lm_moe.moe_ffn_sorted(p, x, cfg.moe) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    # dropless: the backends' capacities differ by design (a group's, the call's)
    moe_cfg = lm_moe.dropless(cfg).moe
    einsum = lm_moe.moe_ffn_einsum(p, x, moe_cfg)
    runs[0] = lm_moe.moe_ffn_sorted(p, x, moe_cfg)
    assert float((runs[0] - einsum).float().abs().max() / einsum.float().abs().max()) < 3e-2


def test_lm_decode_capacity_guard_on_the_card(dev):
    cfg = get_config("qwen1.5-0.5b").reduced()
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 16))).to(dev)
    _, cache = lm.prefill(params, tokens, max_seq=18)
    assert cache["k"].is_cuda and cache["pos"] == 16
    for _ in range(2):
        _, cache = lm.decode_step(params, cache, tokens[:, :1])
    with pytest.raises(ValueError, match="cache exhausted"):
        lm.decode_step(params, cache, tokens[:, :1])
    assert lm.init_cache(2, 8)["k"].is_cuda


# ----------------------------------------------------- lanes over a mesh
def _close_batches(a, b, tol: float = 1e-5):
    """Equal plans and iterations, ŷ within tol·max(1, |y|), prob within tol."""
    assert (a.z == b.z).all() and (a.iters == b.iters).all() and a.cap == b.cap
    assert (np.abs(a.y_hat - b.y_hat) <= tol * np.maximum(1.0, np.abs(a.y_hat))).all()
    assert (np.abs(a.prob - b.prob) <= tol).all()


def test_one_card_mesh_is_bitwise_the_unsharded_server(dev):
    """``BatchedFusedServer(mesh=make_serving_mesh())`` over every visible
    card at fills 8, 3 and 1 with knobs: on one card (one shard) every lane
    is bitwise the unsharded server's; one slot a bucket on every shard."""
    bundle, cfg, knobs = _batch_bundle(dev, "turbofan")
    mesh = make_serving_mesh()
    base = BatchedFusedServer(bundle, cfg, device=dev)
    srv = BatchedFusedServer(bundle, cfg, mesh=mesh)
    for fill in (8, 3, 1):
        a = base.serve_batch(bundle.requests[:fill], knobs=knobs[:fill])
        b = srv.serve_batch(bundle.requests[:fill], knobs=knobs[:fill])
        assert b.n_devices == mesh.size
        if mesh.size == 1:
            assert (a.z == b.z).all() and (a.iters == b.iters).all()
            assert torch.equal(_host_bits(a.y_hat), _host_bits(b.y_hat))
            assert torch.equal(_host_bits(a.prob), _host_bits(b.prob))
        else:
            _close_batches(a, b)
    srv.check_compile_contract(buckets=[2048])
    assert srv.shard_compile_counts == [1] * mesh.size


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", ["turbofan", "sensor_health"])
def test_simulated_shards_on_one_card_hold_plans(dev, name, shards):
    """2 and 4 shards simulated on one card, each with its own executor,
    slot, graphs and stream: plans and iterations the unsharded server's,
    ŷ and prob within 1e-5, the same batch twice bitwise; each shard's z⁰
    replay launches its own ``prefix_power_sums``."""
    bundle, cfg, knobs = _batch_bundle(dev, name)
    base = BatchedFusedServer(bundle, cfg, device=dev)
    srv = BatchedFusedServer(bundle, cfg, mesh=make_serving_mesh(
        devices=simulated_devices(shards, dev)))
    for fill in (8, 3, 1):
        _close_batches(base.serve_batch(bundle.requests[:fill], knobs=knobs[:fill]),
                       srv.serve_batch(bundle.requests[:fill], knobs=knobs[:fill]))
    build.reset_launch_counts()
    a = srv.serve_batch(bundle.requests[:8], knobs=knobs)
    assert build.LAUNCHES["prefix_power_sums"] == shards
    b = srv.serve_batch(bundle.requests[:8], knobs=knobs)
    assert (a.z == b.z).all() and torch.equal(_host_bits(a.y_hat), _host_bits(b.y_hat))
    assert torch.equal(_host_bits(a.prob), _host_bits(b.prob))
    streams = {sh.stream.cuda_stream for sh in srv._run.shards}
    assert len(streams) == shards
    assert all(s.graphs for sh in srv._run.shards for s in sh.exe._slots.values())
    srv.check_compile_contract(buckets=[2048])


def test_sharded_table_on_one_card_holds_plans(dev):
    """``ContinuousBatchedServer`` over 2 shards on one card against the
    unsharded table on the same trace (recycled lanes): plans, iterations
    and flags equal at every read-back, ŷ and prob within 1e-5; two slots a
    bucket on every shard."""
    bundle, cfg, knobs = _batch_bundle(dev, "sensor_health")
    bundle.requests = bundle.requests + bundle.requests[:4]
    kw = dict(batch_size=8, chunk_iters=2)
    a = _table_trace(ContinuousBatchedServer(bundle, cfg, device=dev, **kw), bundle, knobs)
    srv = ContinuousBatchedServer(bundle, cfg, mesh=make_serving_mesh(
        devices=simulated_devices(2, dev)), **kw)
    b = _table_trace(srv, bundle, knobs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for key in ("z", "it", "n", "done", "active"):
            assert (x[key] == y[key]).all(), key
        assert (np.abs(x["y_hat"] - y["y_hat"]) <= 1e-5 * np.maximum(1, np.abs(x["y_hat"]))).all()
        assert (np.abs(x["prob"] - y["prob"]) <= 1e-5).all()
    srv.check_compile_contract()
    assert srv.shard_compile_counts == [2, 2]


def test_captured_replays_hold_no_sync(dev):
    """Every captured graph of a batched slot, of a 2-shard mesh's slots and
    of a lane table replays under ``torch.cuda.set_sync_debug_mode("error")``."""
    from repro_torch.analysis import check

    bundle, cfg, knobs = _batch_bundle(dev, "sensor_health")
    srv = BatchedFusedServer(bundle, cfg, mesh=make_serving_mesh(
        devices=simulated_devices(2, dev)))
    srv.serve_batch(bundle.requests[:8], knobs=knobs)
    slots = [(f"shard {i}", s) for i, sh in enumerate(srv._run.shards)
             for s in sh.exe._slots.values()]
    cont = ContinuousBatchedServer(bundle, cfg, batch_size=8, device=dev)
    table = cont.new_table(cont.trace_cap(bundle.requests))
    assert len(slots) == 2 and table.graphs and table.src.graphs
    assert check.sync_debug_findings(slots + [("table", table), ("refill", table.src)],
                                     "card") == []


def test_checker_on_the_card(dev):
    """``python -m repro_torch.analysis.check --device cuda`` on turbofan: no
    finding, the facts of ``baseline.json``'s cuda section; every seeded
    mutation caught on the card."""
    from repro_torch.analysis import check

    assert check.main(["--device", "cuda", "--pipelines", "turbofan"]) == 0
    assert check.run_mutations(dev) == 0


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


# ------------------------------------------------ flash_attention backward
# the backward kernels against the plain backward, max |Δ| over max |plain|
# of each gradient: float32 differs in summation order only; bf16 gradients
# are float32 sums rounded once to bf16 (2^-8 relative), and the kernel's Δ
# takes the forward's bf16 output, as the plain version here does
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the bf16 kernels against their roundings emulated in PyTorch, elementwise:
# one bf16 ulp of the final rounding (2^-7 relative at most), plus 2^-9 of
# the gradient's largest magnitude for a P or dS that the tensor cores'
# summation order or ex2.approx moved across a bf16 rounding tie (each such
# move is one bf16 ulp of a single term of a sum over a row or column)
BWD_EMULATION_TOL = dict(rtol=2 ** -7, atol=2 ** -9)


def _bwd_inputs(dev, dtype, b, h, hkv, sq, sk, d, dv, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dev, dtype)
                 for s in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, dv), (b, h, sq, dv)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,dv,causal,window", [
    (2, 4, 4, 100, 100, 64, 64, True, 0),       # ragged tiles
    (1, 8, 2, 256, 256, 128, 128, True, 0),     # GQA
    (2, 4, 4, 200, 200, 192, 128, True, 0),     # MLA's D != Dv
    (1, 4, 4, 300, 300, 80, 80, True, 64),      # a window (zamba2's head dim)
    (2, 4, 4, 160, 160, 64, 64, False, 0),      # bidirectional
    (2, 4, 4, 48, 200, 64, 64, False, 0),       # cross: Sq != Sk
    (1, 2, 2, 130, 130, 256, 256, True, 0),     # gemma's 256
    (1, 2, 1, 90, 70, 40, 24, False, 40),       # odd dims, a non-causal window
    (1, 4, 2, 150, 150, 36, 36, True, 0),       # 72-byte rows: no TMA, the producer loads
])
def test_flash_attention_backward_matches_plain(dev, dtype, b, h, hkv, sq, sk, d, dv, causal,
                                                window):
    """Both backward kernels against the plain backward (``BWD_TOL``), the
    path each launch took (bf16: the tensor-core kernels, fed by TMA but
    for views whose rows are not a multiple of 16 bytes; float32: the
    scalar kernels) and, bf16, the emulated roundings
    (``emulation.bf16_backward``) within ``BWD_EMULATION_TOL``."""
    from repro_torch.kernels.flash_attention.backward import DKV, DQ, flash_attention_bwd
    from repro_torch.kernels.flash_attention.emulation import bf16_backward
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, live_keys

    q, k, v, do = _bwd_inputs(dev, dtype, b, h, hkv, sq, sk, d, dv, seed=sq + d)
    plain_out = flash_attention(q, k, v, causal=causal, window=window)
    out, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    assert torch.equal(out, plain_out)
    kf = k.float().repeat_interleave(h // hkv, 1)
    s = (q.float() * d ** -0.5) @ kf.transpose(-1, -2)
    keep = live_keys(sq, sk, causal, window, dev)
    if keep is not None:
        s = torch.where(keep, s, -torch.inf)
    assert float((lse - torch.logsumexp(s, -1)).abs().max()) < 1e-4
    build.reset_launch_counts()
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES == {DQ: 1, DKV: 1}
    path = "simt" if dtype == torch.float32 else "loads" if d % 8 or dv % 8 else "tma"
    assert build.PATHS == {f"{DQ}.{path}": 1, f"{DKV}.{path}": 1}
    want = flash_attention_bwd_ref(q, k, v, out, do, causal=causal, window=window)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape, what
        assert bool(torch.isfinite(g).all()), what
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert err < BWD_TOL[dtype], (what, err)
    if dtype == torch.bfloat16:
        emulated = bf16_backward(q, k, v, out, do, lse, causal=causal, window=window)
        for g, e, what in zip(got, emulated, ("dq", "dk", "dv")):
            g, e = g.float(), e.float()
            slack = BWD_EMULATION_TOL["rtol"] * e.abs() + BWD_EMULATION_TOL["atol"] * e.abs().max()
            assert int(((g - e).abs() > slack).sum()) == 0, (
                what, float((g - e).abs().max() / e.abs().max()))


def test_flash_attention_backward_is_deterministic(dev):
    """No atomics: two backward launches on one input give the same bits,
    GQA's group sums included."""
    from repro_torch.kernels.flash_attention.backward import flash_attention_bwd

    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, 1, 16, 4, 1024, 1024, 128, 128, seed=3)
    out, lse = flash_attention(q, k, v, return_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, do)
    second = flash_attention_bwd(q, k, v, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_backward_is_deterministic_at_qwen3_8b(dev):
    """qwen3-8b's GQA shape (32 query heads on 8 KV heads, head dim 128,
    1024 tokens, causal): two launches of each backward kernel give the same
    bits (the dK/dV block's two consumers add their sums in a fixed order),
    both on the TMA path."""
    from repro_torch.kernels.flash_attention.backward import DKV, DQ, flash_attention_bwd

    q, k, v, do = _bwd_inputs(dev, torch.bfloat16, 1, 32, 8, 1024, 1024, 128, 128, seed=8)
    out, lse = flash_attention(q, k, v, return_lse=True)
    build.reset_launch_counts()
    first = flash_attention_bwd(q, k, v, out, lse, do)
    second = flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert build.PATHS == {f"{DQ}.tma": 2, f"{DKV}.tma": 2}
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("kind", ["gqa", "mla", "window", "cross"])
def test_gradients_reach_the_projections_through_the_kernel(dev, kind):
    """A bf16 attention block on the card under autograd: the forward is one
    flash_attention launch and the backward one launch of each backward
    kernel; every projection's gradient is finite, not zero, and within 3e-2
    (max-normalised) of the plain path's (``use_kernel=False``, autograd of
    the plain version)."""
    from repro_torch.kernels.flash_attention.backward import DKV, DQ
    from repro_torch.models.lm.layers import (
        cross_attention_with_kv,
        init_attention,
        init_mla,
        mla_block,
    )

    cfg = dataclasses.replace(get_config({"gqa": "qwen3-8b", "mla": "deepseek-v2-236b",
                                          "window": "zamba2-2.7b",
                                          "cross": "seamless-m4t-large-v2"}[kind]).reduced(),
                              dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = (init_mla if kind == "mla" else init_attention)(gen, cfg, torch.bfloat16)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (2, 160, cfg.d_model)).astype(np.float32)).to(
        dev, torch.bfloat16)
    enc = torch.from_numpy(rng.normal(0, 1, (2, 96, cfg.d_model)).astype(np.float32)).to(
        dev, torch.bfloat16)
    grads = {}
    for use_kernel in (True, False):
        leaves = {n: t.detach().clone().requires_grad_(True) for n, t in p.items()}
        build.reset_launch_counts()
        if kind == "mla":
            y = mla_block(leaves, x, cfg, use_kernel=use_kernel)
        elif kind == "cross":
            y = cross_attention_with_kv(leaves, x, enc, use_kernel=use_kernel)[0]
        else:
            y = attention_block(leaves, x, cfg, window=cfg.sliding_window, use_kernel=use_kernel)
        assert build.LAUNCHES["flash_attention"] == int(use_kernel)
        y.float().square().mean().backward()
        torch.cuda.synchronize()
        assert build.LAUNCHES[DQ] == build.LAUNCHES[DKV] == int(use_kernel)
        grads[use_kernel] = {n: t.grad for n, t in leaves.items()}
    names = ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo") if kind == "mla" else ("wq", "wk", "wv", "wo")
    for n in names:
        g, w = grads[True][n], grads[False][n]
        assert g is not None and bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0), n
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert err < 3e-2, (n, err)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-236b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_train_step_kernel_matches_plain(dev, arch):
    """One bf16 train step of a reduced config on the card, kernel path
    against plain path from the same weights and batch: loss and grad norm
    within 3e-2 relative; the kernel path launches each backward kernel once
    an attention call (twice under remat, with the forward recomputed)."""
    from repro_torch.kernels.flash_attention.backward import DKV, DQ
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import build_train_step, synthetic_batch

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0))
    out = {}
    for use_kernel in (True, False):
        lm = LM(cfg, use_kernel=use_kernel, remat=True, loss_chunk=64)
        step = build_train_step(lm)
        batch = synthetic_batch(lm, 2, 128, 0, 0, device=dev)
        build.reset_launch_counts()
        _, _, m = step(dict(params), adamw_init(params), batch, 0)
        torch.cuda.synchronize()
        out[use_kernel] = m
        if use_kernel:
            assert build.LAUNCHES[DQ] == build.LAUNCHES[DKV] > 0
            assert build.LAUNCHES["flash_attention"] >= build.LAUNCHES[DQ]
            # bf16: every backward launch on the tensor cores
            assert build.PATHS[f"{DQ}.tma"] + build.PATHS[f"{DQ}.loads"] == build.LAUNCHES[DQ]
            assert build.PATHS[f"{DKV}.tma"] + build.PATHS[f"{DKV}.loads"] == build.LAUNCHES[DKV]
        else:
            assert not build.LAUNCHES
    for key in ("loss", "grad_norm"):
        a, b = float(out[True][key]), float(out[False][key])
        assert np.isfinite(a) and abs(a - b) <= 3e-2 * abs(b), key


@pytest.mark.parametrize("dims", [(1, 4), (2, 2)], ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-236b", "zamba2-2.7b", "xlstm-1.3b",
                                  "seamless-m4t-large-v2"])
def test_tensor_parallel_decode_float32_matches_unsharded(dev, arch, dims):
    """Phase 21(a) at ``.reduced()``: float32, TF32 off, shards simulated on
    the card, the cache placed by ``cache_pspecs``: a cached prefill of
    B = 2 x 32 and 4 decode steps against the unsharded port on the same
    weights, every step's logits and every gathered cache leaf within 1e-4;
    ``flash_attention`` launches in the prefill only, none in decode."""
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.lm.sharding import (
        ShardingRules,
        gather_cache,
        shard_params,
        use_rules,
    )

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        lm = LM(cfg, remat=False)
        params = lm.init(torch.Generator(device=dev).manual_seed(6))
        gen = torch.Generator(device=dev).manual_seed(7)
        s, steps = 32, 4
        tokens = torch.randint(0, cfg.vocab, (2, s + steps), device=dev, generator=gen)
        fe = (torch.randn((2, cfg.n_frontend_tokens, cfg.d_model), device=dev, generator=gen)
              if cfg.frontend else None)
        n = dims[0] * dims[1]
        rules = ShardingRules(make_lm_mesh(dims, devices=simulated_devices(n, dev)), cfg)
        placed = shard_params(rules, params)
        runs = {}
        for name, p in (("unsharded", params), ("sharded", placed)):
            with torch.no_grad(), (use_rules(rules) if name == "sharded" else
                                   contextlib.nullcontext()):
                build.reset_launch_counts()
                logits, cache = lm.prefill(p, tokens[:, :s], fe)
                at_prefill = build.LAUNCHES.get("flash_attention", 0)
                out = [logits]
                for i in range(steps):
                    logits, cache = lm.decode_step(p, cache, tokens[:, s + i:s + i + 1])
                    out.append(logits)
                assert build.LAUNCHES.get("flash_attention", 0) == at_prefill
                assert (at_prefill > 0) == (cfg.family != "ssm")
            runs[name] = out, (gather_cache(cache) if name == "sharded" else cache)
        for got, want in zip(runs["sharded"][0], runs["unsharded"][0]):
            g, w = got[:, :cfg.vocab], want[:, :cfg.vocab]
            assert float((g - w).abs().max() / w.abs().max()) <= 1e-4
        got, want = runs["sharded"][1], runs["unsharded"][1]
        assert got["pos"] == want["pos"]
        for name, w in want.items():
            if name != "pos":
                err = (got[name].float() - w.float()).abs().max() / w.float().abs().max()
                assert float(err) <= 1e-4, name
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("dims", [(1, 2), (1, 4), (2, 2)], ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch", ["qwen3-8b", "internvl2-1b", "granite-moe-1b-a400m",
                                  "deepseek-v2-236b"])
def test_tensor_parallel_float32_matches_unsharded(dev, arch, dims):
    """Phases 18(a) and 19(a) at ``.reduced()``: float32, TF32 off, shards
    simulated on the card against the unsharded port on the same weights: the
    last logits within 1e-4, ``train_loss`` within 1e-5 and every gradient
    leaf, gathered, within 1e-4 (max-normalised); one forward
    ``flash_attention`` launch a layer a shard, deepseek's dense layer
    included (the query heads of (1, 4) read replicated KV heads)."""
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.lm.sharding import (
        ShardingRules,
        gather_params,
        shard_params,
        use_rules,
    )
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import synthetic_batch
    from repro_torch.train.step import loss_and_grads

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        lm = LM(cfg, remat=False, loss_chunk=32)
        params = lm.init(torch.Generator(device=dev).manual_seed(5))
        b = synthetic_batch(lm, 2, 64, 5, 0, device=dev)
        prompt = b["tokens"][:, :-1]
        fe = b.get("frontend")
        with torch.no_grad():
            want_logits = lm.prefill_logits(params, prompt, fe)[:, :cfg.vocab]
        want_loss, _, want_g = loss_and_grads(lm, params, b)
        n = dims[0] * dims[1]
        rules = ShardingRules(make_lm_mesh(dims, devices=simulated_devices(n, dev)), cfg)
        placed = shard_params(rules, params)
        with use_rules(rules):
            build.reset_launch_counts()
            with torch.no_grad():
                logits = lm.prefill_logits(placed, prompt, fe)[:, :cfg.vocab]
            assert build.LAUNCHES["flash_attention"] == cfg.n_layers * n
            loss, _, grads = loss_and_grads(lm, placed, b)
        err = float((logits - want_logits).abs().max() / want_logits.abs().max())
        assert err <= 1e-4
        assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
        for g, w in zip(tree_leaves(gather_params(grads)), tree_leaves(want_g)):
            assert g.shape == w.shape
            assert float((g - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
