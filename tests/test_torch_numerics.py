"""PyTorch port vs the JAX reference: Sobol points, compensated sums, Φ⁻¹ and Eq. 1.

Inputs are made with numpy from fixed seeds and handed to both packages.
Pallas kernels run in interpret mode, as ``tests/test_kernels.py`` runs them.
The CUDA kernels are held against these plain versions in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qmc import sobol_uint32 as ref_sobol_uint32
from repro.core.qmc import uniform_to_normal as ref_uniform_to_normal
from repro.core.propagation import qmc_uniforms as ref_qmc_uniforms
from repro.kernels.sampled_agg.compensated import comp_cumsum as ref_comp_cumsum
from repro.kernels.sobol.sobol import sobol_points as ref_sobol_points
from repro_torch.core.guarantee import guarantee_prob
from repro_torch.core.propagation import qmc_uniforms
from repro_torch.core.qmc import sobol_uint32, uniform_to_normal
from repro_torch.kernels.sampled_agg.compensated import comp_cumsum, comp_sum, kahan_step, two_sum
from repro_torch.kernels.sobol.ops import points



def _heavy_tailed(n=60000, seed=7):
    """One dominant burst + a dense small tail (tests/test_incremental_afc.py)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(1.25, 0.12, n).astype(np.float32)
    v[0] = 100.0
    return v


# ------------------------------------------------------------------ Sobol
@pytest.mark.parametrize("m,d,skip", [(1000, 9, 0), (256, 18, 0), (192, 9, 0), (128, 6, 64)])
def test_sobol_uint32_bit_exact_with_reference(m, d, skip):
    got = sobol_uint32(m, d, skip).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**32
    assert (got == np.asarray(ref_sobol_uint32(m, d, skip)).astype(np.int64)).all()


@pytest.mark.parametrize("m,d,skip,block_m", [(256, 18, 0, 64), (512, 9, 0, 256), (128, 6, 64, 128)])
def test_sobol_uint32_bit_exact_with_pallas_kernel(m, d, skip, block_m):
    want = np.asarray(ref_sobol_points(m, d, skip, block_m=block_m, interpret=True))
    assert (sobol_uint32(m, d, skip).numpy() == want.astype(np.int64)).all()


def test_qmc_uniforms_match_reference():
    got = qmc_uniforms(1000, 9, device="cpu").numpy()
    assert (got == np.asarray(ref_qmc_uniforms(1000, 9))).all()


def test_sobol_index_wraps_at_32_bits():
    """The gray-code index is uint32 arithmetic: skip near 2³² wraps."""
    got = sobol_uint32(4, 3, 2**32 - 2).numpy()
    want = np.concatenate([sobol_uint32(2, 3, 2**32 - 2).numpy(), sobol_uint32(2, 3, 0).numpy()])
    assert (got == want).all()


# ------------------------------------------------------------ compensated
def test_compensated_sums_at_60k_within_1e6_of_float64():
    v = _heavy_tailed()
    x = torch.from_numpy(np.stack([v.astype(np.float64) ** p for p in range(1, 5)]).astype(np.float32))
    x64 = np.stack([v.astype(np.float64) ** p for p in range(1, 5)])
    want_total = x64.sum(axis=1)
    got_total = comp_sum(x, 1).numpy()
    assert (np.abs(got_total - want_total) / np.abs(want_total)).max() < 1e-6
    want_scan = np.cumsum(x64, axis=1)
    got_scan = comp_cumsum(x, 1).numpy()
    assert (np.abs(got_scan - want_scan) / np.abs(want_scan)).max() < 1e-6
    # the sequential float32 running sum is what these guard against
    naive = np.cumsum(x.numpy(), axis=1, dtype=np.float32)
    assert (np.abs(naive - want_scan) / np.abs(want_scan)).max() > 1e-6


def test_comp_cumsum_matches_reference_scan():
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 5.0, (3, 1537)).astype(np.float32)
    got = comp_cumsum(torch.from_numpy(x), 1).numpy()
    want = np.asarray(ref_comp_cumsum(jnp.asarray(x), axis=1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_two_sum_and_kahan_step_are_error_free():
    a = torch.tensor([1e8, 1.0, -3.5], dtype=torch.float32)
    b = torch.tensor([1.0, 1e-8, 3.5], dtype=torch.float32)
    s, e = two_sum(a, b)
    exact = a.double() + b.double()
    assert ((s.double() + e.double()) == exact).all()
    hi, lo = kahan_step(torch.zeros(3), torch.zeros(3), a)
    hi, lo = kahan_step(hi, lo, b)
    assert ((hi.double() + lo.double()) == exact).all()


# ---------------------------------------------------------------- Φ⁻¹
def test_uniform_to_normal_matches_reference():
    rng = np.random.default_rng(0)
    u = np.concatenate([
        np.asarray(ref_qmc_uniforms(1000, 9)).ravel(),
        rng.uniform(0, 1, 20000),
        [0.0, 1.0, 1e-9, 1 - 1e-9, 0.5, np.exp(-2.0), 1 - np.exp(-2.0), 1e-30],
    ]).astype(np.float32)
    got = uniform_to_normal(torch.from_numpy(u)).numpy()
    want = np.asarray(ref_uniform_to_normal(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert np.isfinite(got).all()


def test_ndtri_log_is_correctly_rounded():
    """Φ⁻¹'s log is rounded once from float64 on every element, so it does
    not depend on how the CPU math library splits a large tensor."""
    from repro_torch.core.qmc import _log

    u = np.random.default_rng(1).uniform(1e-7, 1.0, 40000).astype(np.float32)
    got = _log(torch.from_numpy(u)).numpy()
    assert (got == np.log(u.astype(np.float64)).astype(np.float32)).all()


# ----------------------------------------------------- Eq. 1, degenerate σ
def test_guarantee_prob_degenerate_sigma_keeps_subnormal_bias():
    """ŷ = 0, mean = 1e-38 (a float32 subnormal), sd = 0, δ = 0: the bias is
    not within δ, so the probability is 0 — the exact-arithmetic answer."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    assert float(guarantee_prob(f(0.0), f(1e-38), f(0.0), f(0.0))) == 0.0
    assert float(guarantee_prob(f(0.0), f(1e-38), f(0.0), f(1e-37))) == 1.0
    assert float(guarantee_prob(f(0.0), f(0.0), f(0.0), f(0.0))) == 1.0
    p = float(guarantee_prob(f(1.0), f(1.0), f(2.0), f(1.0)))
    assert abs(p - 0.38292492254802624) < 1e-6  # 2Φ(0.5) − 1
