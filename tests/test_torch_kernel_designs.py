"""The decompositions of the port's ``prefix_power_sums``, ``sampled_moments``,
``masked_select_ranks`` and ``ensemble_sum`` kernels, emulated in PyTorch,
against the plain versions and the JAX reference.

``kernels/sampled_agg/emulation.py`` repeats the chunked prefix-sum kernel's
operations (chunks scanned as compensated pairs, their totals folded in
index order); it must stay within the power-sum tables' tolerance (rtol
3e-5 / atol 1e-3, the reference's own) of both plain versions and within
1e-6 of float64 on a 60k-row heavy-tailed column, at chunk sizes that do
not divide the row.  The same holds for its emulation of the cluster
``sampled_moments`` kernel (blocks of a row folded in rank order).  Its
emulation of the radix ``masked_select_ranks`` kernel (sort keys, stable
digit ranks by warp, block and cluster, the gather past z and of NaNs) must
select the plain version's bits, and the JAX reference's, on rows with ties,
both signed zeros, +inf and NaN in the prefix.  ``kernels/tree_qmc/emulation.py`` walks the trees in
the kernel's groups and folds their leaves in tree order; it must equal
``ensemble_predict_sum`` bit for bit on the two pipelines' models.
``kernels/sobol/emulation.py`` makes Sobol points run by run as the
``sobol_points`` kernel's runs path does (the gray-code recurrence after a
direct start); it must equal ``sobol_uint32`` (and so the reference) bit for
bit for every run length, dimension count and skip, the index wrapping
past 2³² included, and the executor's one-launch grid must hold the
reference's two grids.  The
launch plans are checked at the served shapes.  The kernels themselves are
held to these emulations on the card (``test_torch_cuda.py``).  The slack
that ``kernels/flash_attention/emulation.py`` allows the bf16 attention
kernel for p's rounded to the other side of a bf16 tie must cover another
order of the score sums and exp2 errors of 2 ulps, and no more.
"""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.propagation import qmc_uniforms as ref_qmc_uniforms
from repro.kernels.sampled_agg.prefix_stats import prefix_power_sums_ref as ref_prefix_ref
from repro.kernels.sampled_agg.quantile_select import masked_select_ranks as pallas_select
from repro.kernels.sampled_agg.ref import masked_select_ranks_ref as ref_select_ref
from repro.kernels.sampled_agg.ref import sampled_moments_ref as ref_moments_ref
from repro_torch.core.propagation import qmc_grid, qmc_uniforms
from repro_torch.core.qmc import sobol_uint32
from repro_torch.data.synthetic import make_pipeline
from repro_torch.kernels.flash_attention.emulation import beyond, bf16_path
from repro_torch.kernels.sampled_agg.emulation import (
    COUNT_MAX,
    chunked_prefix_power_sums,
    clustered_sampled_moments,
    radix_select_ranks,
    sort_keys,
)
from repro_torch.kernels.sampled_agg.prefix_stats import (
    chunk_threads,
    prefix_power_sums_ref,
)
from repro_torch.kernels.sampled_agg.quantile_select import Plan
from repro_torch.kernels.sampled_agg.quantile_select import candidates as select_candidates
from repro_torch.kernels.sampled_agg.quantile_select import plan as select_plan
from repro_torch.kernels.sampled_agg.ref import masked_select_ranks_ref, sampled_moments_ref
from repro_torch.kernels.sampled_agg.sampled_agg import chunk_cols, moment_blocks
from repro_torch.kernels.tree_qmc.emulation import grouped_ensemble_sum
from repro_torch.kernels.tree_qmc.tree_qmc import (
    MAX_CLUSTER,
    SMEM_LIMIT,
    candidates,
    plan,
    smem_bytes,
)
from repro_torch.models.tabular.trees import ensemble_predict_sum
from repro_torch.kernels.sobol.emulation import run_walk_points
from repro_torch.kernels.sobol.sobol import MAX_RUN, THREADS
from repro_torch.kernels.sobol.sobol import plan as sobol_plan

TABLE_TOL = dict(rtol=3e-5, atol=1e-3)


def _heavy_tailed(n=60000, seed=7):
    rng = np.random.default_rng(seed)
    v = rng.normal(1.25, 0.12, n).astype(np.float32)
    v[0] = 100.0
    return v


# ------------------------------------------------------- prefix_power_sums
@pytest.mark.parametrize("k,cap,threads", [
    (9, 5000, 64),     # chunks of 256, the last one ragged
    (3, 4095, 256),    # the kernel's 1024-column chunks, one column short of 4
    (2, 2049, 512),    # the kernel's 2048-column chunks, one column into the second
    (2, 9000, 32),     # 71 chunks a row: the carry folds three groups of 32
    (5, 129, 32),
    (1, 1, 256),
])
def test_chunked_scan_emulation_matches_plain_and_reference(k, cap, threads):
    rng = np.random.default_rng(k * cap + threads)
    vals = rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)
    shift = vals[:, 0]
    got = chunked_prefix_power_sums(torch.from_numpy(vals), torch.from_numpy(shift),
                                    threads=threads).numpy()
    assert got.shape == (k, cap, 4)
    want = prefix_power_sums_ref(torch.from_numpy(vals), torch.from_numpy(shift)).numpy()
    np.testing.assert_allclose(got, want, **TABLE_TOL)
    ref = jax.jit(ref_prefix_ref)(jnp.asarray(vals), jnp.asarray(shift))
    np.testing.assert_allclose(got, np.asarray(ref), **TABLE_TOL)


@pytest.mark.parametrize("threads", [256, 512])
def test_chunked_scan_emulation_at_60k_within_1e6_of_float64(threads):
    """60000 columns in chunks of 1024 or 2048, neither of which divides it."""
    v = _heavy_tailed()
    got = chunked_prefix_power_sums(torch.from_numpy(v[None]), threads=threads)[0].numpy()
    want = np.stack([(v.astype(np.float64) ** p).cumsum() for p in range(1, 5)], axis=-1)
    assert (np.abs(got - want) / np.abs(want)).max() < 1e-6


def test_chunk_threads_at_the_served_shapes():
    """(9, 32768) turbofan: 288 chunks of 1024, 32 a row; (3, 65536) the LM
    head: 96 chunks of 2048 (64 of 1024 would fold their carry in two warp
    scans); any number of chunks, as the launch state is sized to the launch."""
    assert chunk_threads(9, 32768) == 256
    assert chunk_threads(5, 32768) == 256
    assert chunk_threads(3, 65536) == 512
    assert chunk_threads(1, 60000) == 512
    assert chunk_threads(1, 1) == 256
    assert chunk_threads(264, 4096) == 256
    assert chunk_threads(4097, 1024) == 256
    assert chunk_threads(8, 2048 * 4096 // 8 + 1) == 512


# --------------------------------------------------------- sampled_moments
@pytest.mark.parametrize("k,cap,blocks,threads", [
    (9, 32768, 8, 256),   # turbofan's full-width rows, the plan
    (3, 4095, 2, 64),     # chunks of 2048, the last one ragged
    (9, 5000, 3, 256),    # chunks of 1696, not a multiple of the threads
    (5, 129, 8, 32),      # more blocks than the row needs: empty ones fold zeros
    (2, 1024, 1, 256),    # the reduced-depth rows, one block
    (1, 1, 1, 256),
])
def test_clustered_moments_emulation_matches_plain_and_reference(k, cap, blocks, threads):
    rng = np.random.default_rng(k * cap + blocks)
    vals = rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)
    chunk = chunk_cols(cap, blocks)
    z = np.array([[0, 1, cap // 3, min(chunk, cap), min(chunk + 1, cap), cap][i % 6]
                  for i in range(k)], np.int32)
    if k == 1:
        z[0] = cap
    shift = vals[:, 0]
    got = clustered_sampled_moments(torch.from_numpy(vals), torch.from_numpy(z),
                                    torch.from_numpy(shift), blocks=blocks, threads=threads).numpy()
    assert got.shape == (k, 5)
    np.testing.assert_array_equal(got[:, 0], np.minimum(z, cap).astype(np.float32))
    assert (got[z == 0] == 0).all()
    want = sampled_moments_ref(torch.from_numpy(vals), torch.from_numpy(z),
                               torch.from_numpy(shift)).numpy()
    np.testing.assert_allclose(got, want, **TABLE_TOL)
    ref = jax.jit(ref_moments_ref)(jnp.asarray(vals), jnp.asarray(z), jnp.asarray(shift))
    np.testing.assert_allclose(got, np.asarray(ref), **TABLE_TOL)


@pytest.mark.parametrize("blocks", [1, 3, 8])
def test_clustered_moments_emulation_at_60k_within_1e6_of_float64(blocks):
    v = _heavy_tailed()
    got = clustered_sampled_moments(torch.from_numpy(v[None]), torch.tensor([v.size]),
                                    blocks=blocks)[0].numpy()
    want = np.array([(v.astype(np.float64) ** p).sum() for p in range(1, 5)])
    assert got[0] == v.size
    assert (np.abs(got[1:] - want) / np.abs(want)).max() < 1e-6


def test_moment_blocks_at_the_served_shapes():
    """One block per 4096 columns, up to 8: turbofan's (9, 32768) gets 72
    blocks, the LM head's (3, 65536) 24, and the reduced-depth caps one;
    chunks are whole 128-byte lines."""
    assert [moment_blocks(c) for c in (1, 512, 1024, 4096, 4097, 16384, 32768, 65536, 1 << 20)] \
        == [1, 1, 1, 1, 2, 4, 8, 8, 8]
    assert chunk_cols(32768, 8) == 4096 and chunk_cols(65536, 8) == 8192
    assert chunk_cols(5000, 3) == 1696 and chunk_cols(1, 1) == 32 and chunk_cols(129, 8) == 32


# ----------------------------------------------------- masked_select_ranks
def _selection_rows(h, cap, zs, seed, *, nan=False):
    """Rows with ties and both signed zeros (values rounded to 0.1), +inf in
    row 2's prefix, NaN in some prefixes if asked, targets below 0 and past
    cap."""
    rng = np.random.default_rng(seed)
    vals = np.round(rng.normal(0, 2, (h, cap)), 1).astype(np.float32)
    vals[:, 5::11] = np.where(rng.random((h, len(range(5, cap, 11)))) < 0.5, 0.0, -0.0)
    vals[min(2, h - 1), 3::17] = np.inf
    if nan:
        vals[0, 2::13] = np.nan
        vals[1, [0, 1]] = np.array([0x7FC00000, 0xFFC00001], np.uint32).view(np.float32)
    z = np.array([zs[i % len(zs)] for i in range(h)], np.int32)
    targets = rng.integers(-5, cap + 5, (h, 257)).astype(np.int32)
    targets[:, :4] = [-1, 0, cap - 1, cap]
    return vals, z, targets


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("cap,threads,items,blocks,count_max", [
    (512, 64, 2, 4, 0),      # chunks of 128: prefixes inside block 0 and across 4 blocks
    (300, 32, 1, 10, 0),     # 10 blocks of one warp, the last chunk ragged
    (300, 64, 1, 5, 0),
    (2048, 128, 4, 4, 0),    # four slots a lane
    (1000, 1024, 1, 1, COUNT_MAX),    # the kernel's plan at the reduced-depth caps
    (4096, 1024, 1, 4, COUNT_MAX),    # and at cap 4096: counts, one block, the cluster
])
def test_radix_select_emulation_is_bitwise_plain_and_reference(cap, threads, items, blocks,
                                                               count_max):
    """Bitwise (int32) equal to the plain version and to the JAX reference
    at every target, and to the Pallas kernel (interpret mode) at targets
    clipped into the buffer, but for the sign of a selected zero: the
    Pallas kernel adds the selected value to 0.0, which makes −0.0 +0.0.
    The small shapes rank every prefix by the radix passes (``count_max``
    0), the kernel's count up to ``COUNT_MAX`` values."""
    chunk = threads * items
    zs = [0, 1, cap // 3, min(chunk, cap), min(chunk + 1, cap), cap]
    vals, z, targets = _selection_rows(6, cap, zs, cap + blocks)
    got = radix_select_ranks(torch.from_numpy(vals), torch.from_numpy(z),
                             torch.from_numpy(targets), items=items, blocks=blocks,
                             threads=threads, count_max=count_max).numpy()
    want = masked_select_ranks_ref(torch.from_numpy(vals), torch.from_numpy(z),
                                   torch.from_numpy(targets)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ref = ref_select_ref(jnp.asarray(vals), jnp.asarray(z), jnp.asarray(targets))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert (_bits(got) == np.int32(-2 ** 31)).any() and (got == 0).any()   # −0.0 and +0.0
    assert np.isinf(got[0]).all()
    if cap <= 512:
        inside = np.clip(targets, 0, cap - 1)
        kern = np.asarray(pallas_select(jnp.asarray(vals), jnp.asarray(z), jnp.asarray(inside),
                                        interpret=True))
        mine = radix_select_ranks(torch.from_numpy(vals), torch.from_numpy(z),
                                  torch.from_numpy(inside), items=items, blocks=blocks,
                                  threads=threads, count_max=count_max).numpy()
        zero = mine == 0
        np.testing.assert_array_equal(_bits(mine)[~zero], _bits(kern)[~zero])
        assert (_bits(kern)[zero] == 0).all()


@pytest.mark.parametrize("blocks,count_max", [(1, 0), (4, 0), (1, 1000)])
def test_radix_select_emulation_puts_nan_where_the_plain_sort_does(blocks, count_max):
    """NaN keys sort above +inf, and the gather puts the prefix's NaNs after
    the +inf past z, with their own bits, as the stable sort of the row
    does (the JAX reference too)."""
    cap = 600
    vals, z, targets = _selection_rows(4, cap, [cap, 400, 150, 599], 3, nan=True)
    targets[:, 4:12] = np.arange(cap - 8, cap)
    got = radix_select_ranks(torch.from_numpy(vals), torch.from_numpy(z),
                             torch.from_numpy(targets), items=2, blocks=blocks,
                             threads=-(-cap // (2 * blocks * 32)) * 32,
                             count_max=count_max).numpy()
    want = masked_select_ranks_ref(torch.from_numpy(vals), torch.from_numpy(z),
                                   torch.from_numpy(targets)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ref = ref_select_ref(jnp.asarray(vals), jnp.asarray(z), jnp.asarray(targets))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert np.isnan(got[:2, 11]).all() and _bits(got[1, 11]) == np.int32(-0x3FFFFF)


def test_count_threshold_is_the_kernels():
    """The emulation counts ranks up to the radix kernel's ``kCountMax``."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
           / "quantile_select.cu").read_text()
    assert int(re.search(r"constexpr int kCountMax = (\d+);", src).group(1)) == COUNT_MAX


def test_sort_keys_follow_the_plain_sort_order():
    """Unsigned key order is float order, −0.0 equal to +0.0, every NaN one
    key above +inf."""
    x = np.array([-np.inf, -3.4e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0, 3.4e38, np.inf],
                 np.float32)
    keys = sort_keys(torch.from_numpy(x).view(torch.int32)).tolist()
    assert keys == sorted(keys) and keys[4] == keys[5] == 0x80000000
    assert len(set(keys)) == len(keys) - 1
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF], np.uint32).view(np.float32)
    nan_keys = sort_keys(torch.from_numpy(nans).view(torch.int32))
    assert (nan_keys == 0xFFFFFFFF).all() and keys[-1] < 0xFFFFFFFF


def test_select_plans_at_the_served_shapes():
    """The fewest elements a thread whose 1024-thread chunks a cluster of 8
    covers: one block at the reduced-depth caps, 8 at sensor_health's 16384
    and 32768 and the LM head's 65536; past 65536 the rank path."""
    assert select_plan(512) == Plan(1, 1) and select_plan(1024) == Plan(1, 1)
    assert select_plan(4096) == Plan(1, 4)
    assert select_plan(16384) == Plan(2, 8)
    assert select_plan(32768) == Plan(4, 8)
    assert select_plan(65536) == Plan(8, 8)
    assert select_plan(50000) == Plan(8, 7)
    assert select_plan(65537) == Plan(0, 0)
    assert select_candidates(16384) == [Plan(2, 8), Plan(4, 4), Plan(8, 2)]
    for cap in (1, 1000, 9000, 65536):
        assert all(p.blocks <= 8 and p.blocks * 1024 * p.items >= cap
                   for p in select_candidates(cap))


# ----------------------------------------------------------- ensemble_sum
@pytest.fixture(scope="module")
def ensembles():
    small = dict(rows_per_group=200, n_train_groups=100, n_serve_groups=2, n_requests=2,
                 device="cpu")
    return {name: make_pipeline(name, **small).pipeline.model.ensemble
            for name in ("turbofan", "sensor_health")}


@pytest.mark.parametrize("name,m", [("turbofan", 3817), ("turbofan", 5),
                                    ("sensor_health", 2793), ("sensor_health", 881)])
def test_grouped_tree_emulation_is_bitwise_plain(ensembles, name, m):
    """Groups the planner picks, and groups that do not divide the trees."""
    ens = ensembles[name]
    x = torch.from_numpy(np.random.default_rng(m).normal(0, 1.5, (m, 9)).astype(np.float32))
    want = ensemble_predict_sum(ens, x)
    p = plan(ens.n_trees, ens.feature.shape[1], 9, m)
    assert p.path == "smem"
    for group in {p.group, 7, 3, 1, ens.n_trees}:
        assert torch.equal(grouped_ensemble_sum(ens, x, group=group), want), group


@pytest.mark.parametrize("n_trees,n_nodes,m,want", [
    # turbofan's forest on its z⁰, Saltelli and iteration megabatches:
    # groups of 8 trees, the largest row tile that gives ~0.6 blocks an SM
    (40, 511, 1001, (5, 8, 64, 16)),
    (40, 511, 2816, (5, 8, 128, 22)),
    (40, 511, 3817, (5, 8, 128, 30)),
    (40, 511, 16384, (5, 8, 256, 52)),   # two row tiles a cluster
    # sensor_health's boosted model: all 60 trees in one block
    (60, 63, 1001, (1, 60, 32, 32)),
    (60, 63, 2793, (1, 60, 32, 88)),
    (60, 63, 881, (1, 60, 32, 28)),
    (60, 63, 65536, (1, 60, 256, 256)),
    (13, 127, 1, (1, 13, 32, 1)),
    (8, 8191, 3817, (8, 1, 256, 15)),     # one 160 KB tree a block
])
def test_tree_plans_fit_and_cover(n_trees, n_nodes, m, want):
    p = plan(n_trees, n_nodes, 9, m)
    assert tuple(p) == want and p.path == "smem" and p.cluster <= MAX_CLUSTER
    assert p.cluster == -(-n_trees // p.group) and 256 % p.rows == 0
    assert smem_bytes(n_trees, n_nodes, 9, p.group, p.rows) <= SMEM_LIMIT
    assert 1 <= p.clusters <= -(-m // p.rows)
    assert p in candidates(n_trees, n_nodes, 9, m)


@pytest.mark.parametrize("n_trees,n_nodes,m", [
    (1, 32767, 100),     # one tree past shared memory
    (40, 8191, 3817),    # groups of one tree, but 40 of them: no cluster of 8
    (40, 511, 65536),    # clusters would loop over five row tiles each
])
def test_trees_the_smem_path_does_not_serve_take_the_global_path(n_trees, n_nodes, m):
    assert plan(n_trees, n_nodes, 9, m).path == "global"


# -------------------------------------------------------- flash_attention
def _attention_variant(q, k, v, *, block_k, gen, drop_last_key=False):
    """The bf16 kernel's roundings with the scores summed in another order
    (float64, rounded once) and every exp2 off by up to 2 ulps."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    c = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(math.log2(math.e))
    s = (q.double() @ k.double().transpose(-1, -2)).float()
    keep = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] - int(drop_last_key)
    keep[0, 0] = True
    s = torch.where(keep, s, -torch.inf)

    def ex2(x):
        noise = (torch.rand(x.shape, generator=gen, dtype=torch.float64) * 2 - 1) * 2.0 ** -22
        return (torch.exp2(x).double() * (1 + noise)).float()

    m = torch.full(q.shape[:-1], -torch.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros((*q.shape[:-1], v.shape[-1]))
    for k0 in range(0, sk, block_k):
        st = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, st.amax(dim=-1) * c)
        neg_m = torch.where(m_new == -torch.inf, 0.0, -m_new)
        corr = ex2(m + neg_m)
        p = ex2(st * c + neg_m[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + p.to(torch.bfloat16).float() @ v[..., k0:k0 + block_k, :].float()
        m = m_new
    return (o / l[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("seed,shape", [(0, (64, 4, 16, 64)), (1, (1, 2, 300, 64))])
def test_attention_tie_slack_covers_the_kernels_rounding_freedom(seed, shape):
    """Within one bf16 ulp (the card's ``EMULATION_TOL``) plus the slack, a
    variant that sums the scores in another order and errs by 2 ulps in
    every exp2; the slack is zero on outputs whose p's lie clear of a tie,
    and it does not cover a fault (the last key of each row dropped)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    tol = dict(rtol=2 ** -7, atol=2 ** -8)
    emulated, slack = bf16_path(q, k, v, causal=True, block_k=128, slack=True)
    assert torch.equal(emulated, bf16_path(q, k, v, causal=True, block_k=128))
    assert bool((slack >= 0).all()) and 0 < int((slack > 0).sum()) < slack.numel()
    gen = torch.Generator().manual_seed(seed)
    for _ in range(3):
        got = _attention_variant(q, k, v, block_k=128, gen=gen)
        assert not beyond(got, emulated, slack, **tol).any()
    faulty = _attention_variant(q, k, v, block_k=128, gen=gen, drop_last_key=True)
    assert beyond(faulty, emulated, slack, **tol).any()


# ------------------------------------------------------------ sobol_points
@pytest.mark.parametrize("run", [1, 2, 3, 7, 31, 32, 33, 64])
@pytest.mark.parametrize("dim,skip", [(1, 0), (9, 0), (18, 12345), (42, 2**32 - 70),
                                      (64, 2**32 - 1), (6, 2**31 - 5)])
def test_run_walk_emulation_is_bitwise_the_direct_construction(run, dim, skip):
    """Runs of 1 to 64 points, 1 to 64 dimensions, skips whose runs cross
    2³¹ and wrap past 2³² (``ctz(0)`` read as 31), a ragged last run."""
    m = 200
    got = run_walk_points(m, dim, skip, run=run)
    assert torch.equal(got, sobol_uint32(m, dim, skip))


@pytest.mark.parametrize("m,m_sobol,k", [(1000, 256, 9), (1000, 256, 21), (400, 96, 3),
                                         (192, 48, 5), (48, 192, 2)])
def test_one_grid_holds_the_executors_two(m, m_sobol, k):
    """The (m, k) AMI grid and the (m_sobol, 2k) Saltelli grid are views of
    one (max(m, m_sobol), 2k) grid, bit for bit the reference's two grids."""
    u_ami, u_sob = qmc_grid(m, m_sobol, k, device="cpu")
    assert torch.equal(u_ami, qmc_uniforms(m, k, device="cpu"))
    assert torch.equal(u_sob, qmc_uniforms(m_sobol, 2 * k, device="cpu"))
    assert (u_ami.numpy() == np.asarray(ref_qmc_uniforms(m, k))).all()
    assert (u_sob.numpy() == np.asarray(ref_qmc_uniforms(m_sobol, 2 * k))).all()
    assert u_ami.untyped_storage().data_ptr() == u_sob.untyped_storage().data_ptr()


@pytest.mark.parametrize("m,dim", [(1000, 18), (1000, 42), (400, 6), (1000, 2),
                                   (65536, 64), (1, 1)])
def test_sobol_plan_covers_the_grid_in_a_wave(m, dim):
    """The run length the wrapper picks: within 1..32, the block's tile in
    32 KB of shared memory, and at most about one block an SM unless the
    runs are at their longest."""
    run = sobol_plan(m, dim)
    runs = THREADS // dim
    blocks = -(-m // (runs * run))
    assert 1 <= run <= MAX_RUN
    assert runs * run * dim * 4 <= 32 * 1024
    assert blocks <= 132 or run == MAX_RUN
