"""The decompositions of the port's ``prefix_power_sums`` and ``ensemble_sum``
kernels, emulated in PyTorch, against the plain versions and the JAX reference.

``kernels/sampled_agg/emulation.py`` repeats the chunked prefix-sum kernel's
operations (chunks scanned as compensated pairs, their totals folded in
index order); it must stay within the power-sum tables' tolerance (rtol
3e-5 / atol 1e-3, the reference's own) of both plain versions and within
1e-6 of float64 on a 60k-row heavy-tailed column, at chunk sizes that do
not divide the row.  ``kernels/tree_qmc/emulation.py`` walks the trees in
the kernel's groups and folds their leaves in tree order; it must equal
``ensemble_predict_sum`` bit for bit on the two pipelines' models.  The
launch plans are checked at the served shapes.  The kernels themselves are
held to these emulations on the card (``test_torch_cuda.py``).  The slack
that ``kernels/flash_attention/emulation.py`` allows the bf16 attention
kernel for p's rounded to the other side of a bf16 tie must cover another
order of the score sums and exp2 errors of 2 ulps, and no more.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sampled_agg.prefix_stats import prefix_power_sums_ref as ref_prefix_ref
from repro_torch.data.synthetic import make_pipeline
from repro_torch.kernels.flash_attention.emulation import beyond, bf16_path
from repro_torch.kernels.sampled_agg.emulation import chunked_prefix_power_sums
from repro_torch.kernels.sampled_agg.prefix_stats import (
    chunk_threads,
    prefix_power_sums_ref,
)
from repro_torch.kernels.tree_qmc.emulation import grouped_ensemble_sum
from repro_torch.kernels.tree_qmc.tree_qmc import (
    MAX_CLUSTER,
    SMEM_LIMIT,
    candidates,
    plan,
    smem_bytes,
)
from repro_torch.models.tabular.trees import ensemble_predict_sum

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
