"""The fused executor's step on a leading lanes axis, on the CPU.

The batched executor holds each lane to what the same function gives that
lane alone: the planner (one lane's exhausted plan must not zero another's
direction), the sampler, the AMI moments and the Sobol indices, the AFC
entry points (one call over ``(L·k, cap)`` rows) and the bootstrap, whose
keys the step gathers from a device table derived once on the host.  The
key table and the lanes' draws are bitwise; float reductions over a lanes
axis may round differently from the one-lane call, so moments and indices
are held to 1e-6 relative, and the executor's plans to equality.  The host
loop's keyed QMC shift, now hashed on the host, is bitwise the reference's
and the earlier device-side draw's at every host grid.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.core import threefry
from repro_torch.core.executor_fused import build_fused_executor
from repro_torch.core.planner import direction, gamma_abs, next_plan
from repro_torch.core.propagation import output_moments
from repro_torch.core.qmc import digital_shift
from repro_torch.core.sobol_indices import indices_from_outputs
from repro_torch.core.uncertainty import sample_features_fused
from repro_torch.kernels.sampled_agg import ops

MAX_ITERS = 12


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_boot_key_table_is_the_host_key_chain():
    """Row ``it`` of the table is mt_keys(fold_in(base, it)), which is the
    split chain the reference's Beta draw walks, at every it."""
    base = threefry.PRNGKey(7)
    table = ops.boot_key_table(base, MAX_ITERS)
    assert table.shape == (MAX_ITERS + 1, 2, 4, 2, 2) and table.dtype == np.uint32
    for it in range(MAX_ITERS + 1):
        key = threefry.fold_in(base, it)
        ka, kb = threefry.split(key)
        for g, kg in enumerate((ka, kb)):
            for r, kr in enumerate(threefry.split(kg, 4)):
                kn, ku = threefry.split(kr)
                np.testing.assert_array_equal(table[it, 0, r, g], kn)
                np.testing.assert_array_equal(table[it, 1, r, g], ku)
        np.testing.assert_array_equal(table[it], ops.mt_keys(key))
        np.testing.assert_array_equal(
            np.stack([ops._mt_keys(ka, 4), ops._mt_keys(kb, 4)], axis=2), table[it])


def test_random_bits_take_device_keys():
    keys = np.stack([threefry.fold_in(threefry.PRNGKey(3), i) for i in range(5)])
    host = threefry.random_bits(keys, (7, 9), device="cpu")
    dev = threefry.random_bits(torch.from_numpy(keys.astype(np.int64)), (7, 9), device="cpu")
    assert torch.equal(host, dev)
    for i in range(5):
        np.testing.assert_array_equal(threefry.host_bits(keys[i], (7, 9)), host[i].numpy())


@pytest.mark.parametrize("seed", [0, 5])
def test_lane_bootstrap_draws_are_each_lanes_own(seed):
    """(L, h) plans under L gathered keys draw, lane for lane, the rank
    targets of the lane's own host key: bitwise."""
    rng = np.random.default_rng(seed)
    lanes, h = 4, 3
    z = rng.integers(0, 900, (lanes, h)).astype(np.int32)
    qs = torch.tensor([0.5, 0.9, 0.25])
    its = rng.integers(0, MAX_ITERS + 1, lanes)
    base = threefry.PRNGKey(seed)
    table = torch.from_numpy(ops.boot_key_table(base, MAX_ITERS).astype(np.int64))
    got = ops.bootstrap_rank_targets(_t(z), qs, table.index_select(0, _t(its)), 64)
    assert got.shape == (lanes, h, 65)
    for i in range(lanes):
        want = ops.bootstrap_rank_targets(_t(z[i]), qs, threefry.fold_in(base, int(its[i])), 64)
        assert torch.equal(got[i], want), i


def test_rescan_afc_on_lanes_is_one_call_of_each_lanes_rows():
    rng = np.random.default_rng(1)
    lanes, k, cap = 3, 4, 300
    vals = _t(rng.normal(2.0, 3.0, (lanes, k, cap)).astype(np.float32))
    n = _t(rng.integers(150, cap + 1, (lanes, k)).astype(np.int32))
    z = torch.minimum(_t(rng.integers(0, cap, (lanes, k)).astype(np.int32)), n)
    agg = torch.tensor([0, 1, 3, 4], dtype=torch.int32)
    value, sigma = ops.masked_estimates(vals, z, n, agg)
    ptab = ops.prefix_power_sums(vals, vals[..., 0])
    qs = torch.tensor([0.5, 0.75])
    keys = torch.from_numpy(np.stack([ops.mt_keys(threefry.PRNGKey(i))
                                      for i in range(lanes)]).astype(np.int64))
    q_val, reps = ops.masked_quantile_estimates(vals[:, :2], z[:, :2], n[:, :2], qs, keys, 32)
    for i in range(lanes):
        v, s = ops.masked_estimates(vals[i], z[i], n[i], agg)
        assert torch.equal(value[i], v) and torch.equal(sigma[i], s)
        assert torch.equal(ptab[i], ops.prefix_power_sums(vals[i], vals[i, :, 0]))
        qv, qr = ops.masked_quantile_estimates(vals[i, :2], z[i, :2], n[i, :2], qs,
                                               threefry.PRNGKey(i), 32)
        assert torch.equal(q_val[i], qv) and torch.equal(reps[i], qr)


def test_planner_plans_each_lane_on_its_own():
    """An exhausted lane gets direction 0 without zeroing the others'; γ
    and the next plan are per lane."""
    n = torch.tensor([[100, 80, 60], [50, 50, 50], [10, 20, 30]], dtype=torch.int32)
    z = torch.tensor([[5, 80, 3], [50, 50, 50], [10, 2, 7]], dtype=torch.int32)
    idx = torch.tensor([[0.1, 0.9, 0.1], [0.3, 0.3, 0.3], [0.5, 0.2, 0.2]])
    d = direction(idx, z, n)
    step = gamma_abs(n, 0.05)
    nxt = next_plan(z, d, step, n)
    assert d[1].sum() == 0 and d[0].sum() == 1 and d[2].sum() == 1
    for i in range(3):
        assert torch.equal(d[i], direction(idx[i], z[i], n[i]))
        assert torch.equal(step[i], gamma_abs(n[i], 0.05))
        assert torch.equal(nxt[i], next_plan(z[i], d[i], step[i], n[i]))


def test_sampler_moments_and_indices_on_lanes():
    rng = np.random.default_rng(2)
    lanes, k, m, h, b = 3, 4, 16, 2, 8
    value = _t(rng.normal(size=(lanes, k)).astype(np.float32))
    sigma = _t(rng.uniform(0, 1, (lanes, k)).astype(np.float32))
    normals = _t(rng.normal(size=(m, k)).astype(np.float32))
    reps = torch.sort(_t(rng.normal(size=(lanes, h, b)).astype(np.float32)), dim=-1).values
    rep_idx = _t(rng.integers(0, b, (m, h)))
    hol = torch.tensor([1, 3])
    rows = sample_features_fused(value, sigma, normals, reps, rep_idx, hol)
    y = _t(rng.normal(size=(lanes, 40)).astype(np.float32))
    mean, sd = output_moments(y)
    f_all = _t(rng.normal(size=(lanes, (k + 2) * 6)).astype(np.float32))
    ind, var = indices_from_outputs(f_all, 6, k)
    cls = _t(rng.integers(0, 2, (lanes, (k + 2) * 6)).astype(np.int32))
    y_hat = torch.tensor([0.0, 1.0, 1.0])
    cind, _ = indices_from_outputs(cls, 6, k, task="classification", y_hat=y_hat)
    for i in range(lanes):
        assert torch.equal(rows[i], sample_features_fused(value[i], sigma[i], normals, reps[i],
                                                          rep_idx, hol))
        m1, s1 = output_moments(y[i])
        torch.testing.assert_close(mean[i], m1, rtol=1e-6, atol=0)
        torch.testing.assert_close(sd[i], s1, rtol=1e-6, atol=0)
        i1, v1 = indices_from_outputs(f_all[i], 6, k)
        torch.testing.assert_close(ind[i], i1, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(var[i], v1, rtol=1e-6, atol=0)
        c1, _ = indices_from_outputs(cls[i], 6, k, task="classification", y_hat=y_hat[i])
        torch.testing.assert_close(cind[i], c1, rtol=1e-6, atol=1e-7)


def _toy_executor(**kw):
    return build_fused_executor(lambda rows, exact: torch.sin(rows.sum(1)) + exact[:, 0],
                                k=3, task="regression", m=48, m_sobol=16, max_iters=6,
                                device="cpu", **kw)


def _toy_batch(lanes=4, cap=256, seed=3):
    rng = np.random.default_rng(seed)
    vals = _t(rng.normal(0.0, 1.0, (lanes, 3, cap)).astype(np.float32))
    n = _t(rng.integers(cap // 2, cap + 1, (lanes, 3)).astype(np.int32))
    exact = _t(rng.normal(size=(lanes, 1)).astype(np.float32))
    return vals, n, torch.zeros(3, dtype=torch.int32), exact


@pytest.mark.parametrize("holistic", [(), (0, 2)])
def test_lanes_equal_one_lane_runs_and_inactive_lanes_never_iterate(holistic):
    """Each active lane's plan and iterations equal a one-lane run of its
    inputs (ŷ and prob within 1e-5); an inactive lane reports 0 iterations
    and 0 samples; per-lane δ, τ and iteration caps are each lane's own."""
    run = _toy_executor(holistic=holistic, afc_backend="incremental", n_boot=16, tau=0.999)
    vals, n, agg, exact = _toy_batch()
    agg = torch.tensor([5, 0, 6] if holistic else [0, 0, 0], dtype=torch.int32)
    delta = torch.tensor([0.05, 0.2, 0.01, 0.05])
    tau = torch.tensor([0.999, 0.9, 0.999, 0.999])
    cap_it = torch.tensor([6, 6, 2, 6], dtype=torch.int32)
    active = torch.tensor([True, True, True, False])
    res = run(vals, n, agg, delta, exact, active, tau, cap_it)
    assert int(res.iters[3]) == 0 and int(res.samples_used[3]) == 0
    assert int(res.iters[2]) <= 2 and int(res.iters.max()) > 0
    for i in range(3):
        one = run(vals[i], n[i], agg, delta[i], exact[i], tau=tau[i], iter_cap=cap_it[i])
        assert one.iters == int(res.iters[i])
        assert torch.equal(one.z, res.z[i])
        assert abs(float(one.y_hat) - float(res.y_hat[i])) <= 1e-5 * max(1.0, abs(float(one.y_hat)))
        assert abs(float(one.prob) - float(res.prob[i])) <= 1e-5
    assert run.slots_built == 2          # (4, 256) and (1, 256)


def test_capture_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        _toy_executor(capture=True)


# the host loop's 14 QMC grids: (m, k) and (m_sobol, 2k) for every k of the
# eight pipelines, at BiathlonConfig()'s m = 1000, m_sobol = 256
HOST_GRIDS = [(m, d) for k in (1, 3, 5, 8, 9, 10, 21) for m, d in ((1000, k), (256, 2 * k))]


@pytest.mark.parametrize("m,d", HOST_GRIDS)
def test_host_drawn_qmc_shift_is_the_device_draw(m, d):
    """``digital_shift`` hashes its (d,) shift on the host: bitwise the
    earlier draw on the points' device and ``jax.random.bits``, and the
    shifted grid is the earlier one."""
    pts = torch.arange(m * d, dtype=torch.int64).reshape(m, d) * 2654435761 & 0xFFFFFFFF
    for seed in (0, 1, 12345):
        for sub in range(3):
            key = threefry.fold_in(threefry.PRNGKey(seed), sub)
            host = threefry.host_bits(key, (d,))
            earlier = threefry.random_bits(key, (d,), device="cpu").numpy()
            want = np.asarray(jax.random.bits(jax.random.fold_in(jax.random.PRNGKey(seed), sub),
                                              (d,), jax.numpy.uint32)).astype(np.int64)
            np.testing.assert_array_equal(host, earlier)
            np.testing.assert_array_equal(host, want)
            assert torch.equal(digital_shift(key, pts), pts ^ torch.from_numpy(earlier)[None])
