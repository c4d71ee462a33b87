"""PyTorch port vs the JAX reference: AFC power sums, prefix tables, estimators, store.

The port's plain versions are held against the reference's jnp oracles and
its Pallas kernels in interpret mode, with the tolerances the reference's
own kernel tests use (rtol 3e-5 / atol 1e-3 on the power-sum tables).
The CUDA kernels are held against these plain versions in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.aggregates import estimates_from_power_sums as ref_estimates
from repro.data.store import ColumnStore as RefColumnStore
from repro.data.store import build_table as ref_build_table
from repro.kernels.sampled_agg.ops import masked_estimates as ref_masked_estimates
from repro.kernels.sampled_agg.prefix_stats import prefix_moments_at as ref_prefix_moments_at
from repro.kernels.sampled_agg.prefix_stats import prefix_power_sums as ref_prefix_kernel
from repro.kernels.sampled_agg.prefix_stats import prefix_power_sums_ref as ref_prefix_ref
from repro.kernels.sampled_agg.ref import sampled_moments_ref as ref_moments_ref
from repro.kernels.sampled_agg.sampled_agg import sampled_moments as ref_moments_kernel
from repro_torch.data.aggregates import AGG_IDS_FULL, estimates_from_power_sums
from repro_torch.data.store import ColumnStore, bucket_size, build_table
from repro_torch.kernels.sampled_agg import ops
from repro_torch.kernels.sampled_agg.prefix_stats import prefix_moments_at, prefix_power_sums_ref
from repro_torch.kernels.sampled_agg.ref import sampled_moments_ref

TABLE_TOL = dict(rtol=3e-5, atol=1e-3)



def _heavy_tailed(n=60000, seed=7):
    rng = np.random.default_rng(seed)
    v = rng.normal(1.25, 0.12, n).astype(np.float32)
    v[0] = 100.0
    return v


def _case(k, cap, seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(1.0, 3.0, (k, cap)).astype(np.float32)
    z = rng.integers(0, cap + 1, k).astype(np.int32)
    z[0] = 0  # an empty prefix in every case
    return vals, z


SHAPES = [(4, 512), (5, 129), (9, 1000), (2, 64)]


# ------------------------------------------------------- sampled_moments
@pytest.mark.parametrize("k,cap", SHAPES)
def test_sampled_moments_ref_matches_reference(k, cap):
    vals, z = _case(k, cap, k * cap)
    shift = vals[:, 0]
    got = sampled_moments_ref(torch.from_numpy(vals), torch.from_numpy(z),
                              torch.from_numpy(shift)).numpy()
    j = (jnp.asarray(vals), jnp.asarray(z), jnp.asarray(shift))
    np.testing.assert_allclose(got, np.asarray(jax.jit(ref_moments_ref)(*j)), **TABLE_TOL)
    assert (got[0] == 0).all()
    np.testing.assert_array_equal(got[:, 0], np.minimum(z, cap))


def test_sampled_moments_ref_at_60k_within_1e6_of_float64():
    v = _heavy_tailed()
    got = sampled_moments_ref(torch.from_numpy(v[None]), torch.tensor([v.size]))[0].numpy()
    want = np.array([v.size] + [float((v.astype(np.float64) ** p).sum()) for p in range(1, 5)])
    assert (np.abs(got - want) / np.abs(want)).max() < 1e-6


# ----------------------------------------------------- prefix power sums
@pytest.mark.parametrize("k,cap", SHAPES)
def test_prefix_power_sums_ref_matches_reference(k, cap):
    vals, _ = _case(k, cap, k + cap)
    shift = vals[:, 0]
    got = prefix_power_sums_ref(torch.from_numpy(vals), torch.from_numpy(shift)).numpy()
    j = (jnp.asarray(vals), jnp.asarray(shift))
    np.testing.assert_allclose(got, np.asarray(jax.jit(ref_prefix_ref)(*j)), **TABLE_TOL)


def test_plain_versions_match_interpret_mode_pallas_kernels():
    """Ragged tiles on both axes: k=5 over blocks of 2, cap=129 over 64."""
    vals, z = _case(5, 129, 42)
    shift = vals[:, 0]
    t = [torch.from_numpy(a) for a in (vals, z, shift)]
    j = [jnp.asarray(a) for a in (vals, z, shift)]
    got = sampled_moments_ref(*t).numpy()
    want = ref_moments_kernel(*j, block_k=2, block_c=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TABLE_TOL)
    got = prefix_power_sums_ref(t[0], t[2]).numpy()
    want = ref_prefix_kernel(j[0], j[2], block_k=2, block_c=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TABLE_TOL)


def test_prefix_power_sums_ref_at_60k_within_1e6_of_float64():
    v = _heavy_tailed()
    got = prefix_power_sums_ref(torch.from_numpy(v[None]))[0].numpy()
    want = np.stack([(v.astype(np.float64) ** p).cumsum() for p in range(1, 5)], axis=-1)
    assert (np.abs(got - want) / np.abs(want)).max() < 1e-6


def test_prefix_moments_at_matches_reference_gather():
    vals, _ = _case(4, 300, 1)
    tab = prefix_power_sums_ref(torch.from_numpy(vals))
    z = np.array([0, 1, 150, 300], np.int32)
    got = prefix_moments_at(tab, torch.from_numpy(z)).numpy()
    want = np.asarray(ref_prefix_moments_at(jnp.asarray(tab.numpy()), jnp.asarray(z)))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ estimators
def test_estimates_from_power_sums_matches_reference():
    """The same power sums give the reference's (value, σ) for every
    parametric operator, at the empty / single / partial / exact prefixes."""
    rng = np.random.default_rng(5)
    k = 400
    vals = rng.normal(20.0, 4.0, (k, 256)).astype(np.float32)
    z = rng.integers(0, 257, k).astype(np.int32)
    z[:4] = [0, 1, 2, 256]
    n = np.maximum(z, rng.integers(1, 400, k)).astype(np.int32)
    agg = rng.integers(0, 5, k).astype(np.int32)
    shift = vals[:, 0]
    mom = np.array(ref_moments_ref(jnp.asarray(vals), jnp.asarray(z), jnp.asarray(shift)))
    want = ref_estimates(jnp.asarray(mom), jnp.asarray(z), jnp.asarray(n), jnp.asarray(agg),
                         jnp.asarray(shift))
    got = estimates_from_power_sums(*(torch.from_numpy(a) for a in (mom, z, n, agg, shift)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("z_list", [[0, 1, 7, 300], [300, 299, 2, 1]])
def test_masked_estimates_and_prefix_query_match_reference(z_list):
    k, cap = 4, 300
    vals = np.random.default_rng(3).normal(50.0, 4.0, (k, cap)).astype(np.float32)
    z = np.asarray(z_list, np.int32)
    n = np.full(k, 300, np.int32)
    agg = np.array([0, 3, 4, 1], np.int32)
    want_v, want_s = ref_masked_estimates(jnp.asarray(vals), jnp.asarray(z), jnp.asarray(n),
                                          jnp.asarray(agg), use_kernel=False)
    t = [torch.from_numpy(a) for a in (vals, z, n, agg)]
    got_v, got_s = ops.masked_estimates(*t)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4, atol=1e-5)
    shift = t[0][:, 0].contiguous()
    tab = ops.prefix_power_sums(t[0], shift)
    inc_v, inc_s = estimates_from_power_sums(prefix_moments_at(tab, t[1]), t[1], t[2], t[3], shift)
    np.testing.assert_allclose(inc_v.numpy(), np.asarray(want_v), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(inc_s.numpy(), np.asarray(want_s), rtol=2e-2, atol=5e-3)


def test_agg_ids_match_reference():
    from repro.data.aggregates import AGG_IDS_FULL as REF_IDS

    assert AGG_IDS_FULL == REF_IDS


# -------------------------------------------------------- routing policy
def test_resolve_afc_plan():
    assert ops.resolve_afc_plan("auto", 1024) is False
    assert ops.resolve_afc_plan("auto", 2048) is True
    assert ops.resolve_afc_plan("auto") is True
    assert ops.resolve_afc_plan("ref", 1 << 20) is False
    assert ops.resolve_afc_plan("incremental", 64) is True
    with pytest.raises(ValueError, match="unknown afc_backend"):
        ops.resolve_afc_plan("kernel")


# ------------------------------------------------------------ the store
def test_request_buffers_bit_equal_with_reference():
    rng = np.random.default_rng(11)
    sizes = [40, 130, 7, 300]
    gid = np.concatenate([np.full(s, 100 + g) for g, s in enumerate(sizes)])
    cols = {"a": rng.normal(0, 1, gid.size).astype(np.float32),
            "b": rng.normal(5, 2, gid.size).astype(np.float32)}
    ref_store = RefColumnStore().add("t", ref_build_table(cols, gid, seed=3))
    store = ColumnStore().add("t", build_table(cols, gid, seed=3))
    specs = [("t", "a", 100), ("t", "b", 101), ("t", "a", 102), ("t", "b", 103)]
    cap = bucket_size(300)
    assert cap == 512
    for c in (cap, 64):
        rv, rn = ref_store.request_buffers(specs, c)
        tv, tn = store.request_buffers(specs, c, "cpu")
        assert tv.dtype == torch.float32 and tn.dtype == torch.int32
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(rn))
