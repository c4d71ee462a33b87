"""The port's host-loop executor, exact baseline and ServerStats vs the JAX reference.

On the CPU, the same numpy inputs go through the reference and the port, at
the sizes of ``torch_pipeline_parity`` (1200-row groups, ``m=192``,
``m_sobol=48``).  Tolerances, each stated where it is asserted:

* bitwise: ``digital_shift`` and the keyed ``qmc_uniforms``; MEDIAN and
  QUANTILE estimates, values and bootstrap replicates; ``ServerStats.summary``;
* 1e-5 relative: the parametric estimates (``estimate``, ``exact_value``,
  ``masked_estimates_batch``), whose float32 sums XLA and PyTorch order
  differently;
* Φ⁻¹'s ulp (ROADMAP Queue 3: XLA's float32 ``log`` is not correctly
  rounded): ``sample_features`` and ``propagate_regression``; class
  probabilities equal;
* 1e-5 absolute: ``main_effect_indices``;
* served requests: plans and iterations equal, y_hat within
  1e-4·max(1, |y|) or the same class, prob within 1e-4 (here on the toy
  store of ``tests/test_executor.py``; the paper pipelines are in
  ``test_torch_host_pipelines.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)

from repro.core import guarantee as ref_guarantee
from repro.core.executor import BiathlonConfig as RefConfig
from repro.core.executor import HostLoopExecutor as RefExecutor
from repro.core.executor import run_exact as ref_run_exact
from repro.core.pipeline import AggFeature as RefAggFeature
from repro.core.pipeline import Pipeline as RefPipeline
from repro.core.propagation import InferenceUncertainty as RefInfU
from repro.core.propagation import propagate_classification as ref_prop_cls
from repro.core.propagation import propagate_regression as ref_prop_reg
from repro.core.propagation import qmc_uniforms as ref_qmc_uniforms
from repro.core.qmc import digital_shift as ref_digital_shift
from repro.core.qmc import sobol_uint32 as ref_sobol_uint32
from repro.core.sobol_indices import main_effect_indices as ref_main_effect_indices
from repro.core.uncertainty import FeatureUncertainty as RefFU
from repro.core.uncertainty import exact_uncertainty as ref_exact_uncertainty
from repro.core.uncertainty import sample_features as ref_sample_features
from repro.data import aggregates as ref_agg
from repro.data.store import ColumnStore as RefStore
from repro.data.store import build_table as ref_build_table
from repro.models.tabular import LinearRegression as RefLinear
from repro.serving.server import ServerStats as RefStats
from repro_torch.core import guarantee, threefry
from repro_torch.core.executor import BiathlonConfig, HostLoopExecutor, run_exact
from repro_torch.core.pipeline import AggFeature, Pipeline
from repro_torch.core.propagation import (
    InferenceUncertainty,
    propagate_classification,
    propagate_regression,
    qmc_uniforms,
)
from repro_torch.core.qmc import digital_shift, sobol_uint32
from repro_torch.core.sobol_indices import indices_from_outputs, main_effect_indices
from repro_torch.core.uncertainty import FeatureUncertainty, exact_uncertainty, sample_features
from repro_torch.data import aggregates
from repro_torch.data.store import ColumnStore, build_table
from repro_torch.models.tabular.linear import LinearRegression
from repro_torch.serving import ServerStats

AGGS = ("sum", "count", "avg", "var", "std", "median", "quantile")
N_GROUP, CAP = 1500, 2048
REL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# ----------------------------------------------------------------- QMC
@pytest.mark.parametrize("m,dim,seed", [(192, 3, 0), (48, 10, 1), (1000, 9, 7), (64, 42, 3)])
def test_digital_shift_and_keyed_uniforms_match_reference(m, dim, seed):
    key = threefry.split(threefry.PRNGKey(seed), 3)[1]
    rkey = jax.random.split(jax.random.PRNGKey(seed), 3)[1]
    assert (np.asarray(rkey) == key).all()
    want = np.asarray(ref_digital_shift(rkey, ref_sobol_uint32(m, dim, 0))).astype(np.int64)
    assert (digital_shift(key, sobol_uint32(m, dim)).numpy() == want).all()
    got = qmc_uniforms(m, dim, key, device="cpu")
    assert (_bits(got.numpy()) == _bits(ref_qmc_uniforms(m, dim, rkey))).all()


# ---------------------------------------------------------------- AFC
def _buffer(n: int, cap: int, seed: int = 5) -> np.ndarray:
    """A zero-padded prefix buffer: n values (ties, and a 0/1-like column
    would do for COUNT; the estimators do not care) in ``cap`` slots."""
    rng = np.random.default_rng(seed)
    v = np.zeros(cap, np.float32)
    v[: min(n, cap)] = np.round(rng.gamma(2.0, 3.0, min(n, cap)), 2).astype(np.float32)
    return v


# z = 0, 1, 17, n − 1 and n of a 1500-row group in a 2048 buffer, then
# z = cap: a full buffer of a larger group (the bootstrap's largest index)
Z_CASES = [(0, N_GROUP), (1, N_GROUP), (17, N_GROUP), (N_GROUP - 1, N_GROUP),
           (N_GROUP, N_GROUP), (CAP, 5000)]


@pytest.mark.parametrize("z,n", Z_CASES, ids=["z0", "z1", "z17", "n-1", "n", "cap"])
@pytest.mark.parametrize("agg", AGGS)
def test_estimate_matches_reference(agg, z, n):
    vals = _buffer(n, CAP)
    key = jax.random.PRNGKey(3)
    want = ref_agg.estimate(agg, jnp.asarray(vals), jnp.int32(z), jnp.int32(n), key,
                            n_boot=256, quantile=0.9)
    got = aggregates.estimate(agg, _t(vals), z, n, threefry.PRNGKey(3), n_boot=256,
                              quantile=0.9)
    assert got.is_empirical == bool(want.is_empirical)
    assert got.replicates.shape == (256,)
    if agg in aggregates.HOLISTIC_AGGS:
        # selections compute nothing: value and every replicate bit for bit
        assert (_bits(got.value) == _bits(want.value)).all()
        assert (_bits(got.replicates) == _bits(want.replicates)).all()
        assert float(got.sigma) == 0.0
    else:
        np.testing.assert_allclose(float(got.value), float(want.value), rtol=REL, atol=1e-6)
        np.testing.assert_allclose(float(got.sigma), float(want.sigma), rtol=REL, atol=1e-6)
        assert (got.replicates == got.value).all()
    if z >= n:
        assert float(got.sigma) == 0.0 and (got.replicates == got.value).all()


@pytest.mark.parametrize("agg", AGGS)
def test_exact_value_matches_reference(agg):
    """At z = n the port skips the reference's thrown-away bootstrap draw;
    the exact value is the same."""
    vals = _buffer(N_GROUP, CAP, seed=11)
    want = float(ref_agg.exact_value(agg, jnp.asarray(vals), jnp.int32(N_GROUP), quantile=0.9))
    got = float(aggregates.exact_value(agg, _t(vals), N_GROUP, quantile=0.9))
    if agg in aggregates.HOLISTIC_AGGS:
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=REL)


def test_estimate_refuses_a_prefix_past_the_buffer():
    with pytest.raises(ValueError, match="exceeds the buffer"):
        aggregates.estimate("median", _t(_buffer(100, 64)), 65, 100, threefry.PRNGKey(0))


def test_masked_estimates_batch_matches_reference():
    rng = np.random.default_rng(2)
    k, cap = 7, 1024
    vals = rng.normal(4.0, 2.0, (k, cap)).astype(np.float32)
    z = np.array([0, 1, 2, 51, 700, 1024, 1024], np.int32)
    n = np.array([900, 900, 5, 900, 900, 1024, 3000], np.int32)
    ids = np.array([0, 1, 2, 3, 4, 3, 4], np.int32)
    v_ref, s_ref = ref_agg.masked_estimates_batch(jnp.asarray(vals), jnp.asarray(z),
                                                  jnp.asarray(n), jnp.asarray(ids))
    v, s = aggregates.masked_estimates_batch(_t(vals), _t(z), _t(n), _t(ids))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=REL, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=REL, atol=1e-6)


# ----------------------------------------------------------- AMI, indices
def _uncertainty(k: int = 5, b: int = 32, seed: int = 4):
    """Equal reference and port FeatureUncertainty: two holistic rows."""
    rng = np.random.default_rng(seed)
    value = rng.normal(3.0, 2.0, k).astype(np.float32)
    sigma = np.abs(rng.normal(0.3, 0.2, k)).astype(np.float32)
    sigma[1] = 0.0
    emp = np.array([False, False, True, False, True][:k])
    reps = np.sort(value[:, None] + rng.normal(0, 0.5, (k, b)).astype(np.float32), axis=1)
    reps[~emp] = value[~emp, None]
    sigma[emp] = 0.0
    ref = RefFU(value=jnp.asarray(value), sigma=jnp.asarray(sigma), replicates=jnp.asarray(reps),
                is_empirical=jnp.asarray(emp))
    port = FeatureUncertainty(value=_t(value), sigma=_t(sigma), replicates=_t(reps),
                              is_empirical=_t(emp))
    return ref, port, emp


def _normals_ulp_bound(u: np.ndarray, sigma: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The parametric columns' tolerance: Φ⁻¹ may differ by one ulp of its
    value, scaled by σ, plus one ulp of the sample (its own rounding)."""
    z = np.abs(np.asarray(torch.special.ndtri(torch.from_numpy(u).double())))
    return sigma[None, :] * np.spacing(z.astype(np.float32)) + np.spacing(np.abs(x))


def test_sample_features_match_reference():
    ref, port, emp = _uncertainty()
    key = threefry.PRNGKey(9)
    u = qmc_uniforms(192, 5, key, device="cpu")
    want = np.asarray(ref_sample_features(ref, jnp.asarray(u.numpy())))
    got = sample_features(port, u).numpy()
    # the empirical family selects replicates: bit for bit
    assert (_bits(got[:, emp]) == _bits(want[:, emp])).all()
    tol = _normals_ulp_bound(u.numpy(), port.sigma.numpy(), want)
    assert (np.abs(got - want) <= tol)[:, ~emp].all()
    # population std of 32 replicates, summed in another order
    np.testing.assert_allclose(port.effective_std().numpy(), np.asarray(ref.effective_std()),
                               rtol=1e-6)


def test_exact_uncertainty_samples_constant_rows():
    """Exact features: σ = 0 and value-filled replicates, as the reference's,
    so every QMC row is the point estimate."""
    values = np.array([1.5, -2.0, 7.25], np.float32)
    ref = ref_exact_uncertainty(jnp.asarray(values), 4)
    port = exact_uncertainty(_t(values), 4)
    for f in ("value", "sigma", "replicates", "is_empirical"):
        assert (getattr(port, f).numpy() == np.asarray(getattr(ref, f))).all(), f
    rows = sample_features(port, qmc_uniforms(64, 3, threefry.PRNGKey(1), device="cpu"))
    assert (rows == _t(values)[None, :]).all()


def _linear_model(k: int):
    w = np.linspace(-1.0, 2.0, k).astype(np.float32)
    return (lambda x: jnp.asarray(x) @ jnp.asarray(w) + 0.5,
            lambda x: x @ torch.from_numpy(w) + 0.5,
            lambda x: (jnp.asarray(x) @ jnp.asarray(w) > 8.0).astype(jnp.int32),
            lambda x: (x @ torch.from_numpy(w) > 8.0).to(torch.int32))


def test_propagation_matches_reference():
    ref, port, _ = _uncertainty()
    reg_ref, reg, cls_ref, cls = _linear_model(5)
    rkey, key = jax.random.PRNGKey(12), threefry.PRNGKey(12)
    a, b = ref_prop_reg(reg_ref, ref, 192, rkey), propagate_regression(reg, port, 192, key)
    # float32 means of 192 outputs, each within Φ⁻¹'s ulp (see above)
    for f in ("y_hat", "mean", "std"):
        np.testing.assert_allclose(float(getattr(b, f)), float(getattr(a, f)), rtol=1e-5)
    a, b = (ref_prop_cls(cls_ref, ref, 192, 2, rkey),
            propagate_classification(cls, port, 192, 2, key))
    assert (b.probs.numpy() == np.asarray(a.probs)).all()
    assert float(b.mean) == float(a.mean) and float(b.y_hat) == float(a.y_hat)


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_main_effect_indices_match_reference(task):
    ref, port, _ = _uncertainty()
    reg_ref, reg, cls_ref, cls = _linear_model(5)
    fr, fp = (reg_ref, reg) if task == "regression" else (cls_ref, cls)
    y_hat = 1.0 if task == "classification" else None
    a = ref_main_effect_indices(fr, ref, 48, jax.random.PRNGKey(5), task=task,
                                y_hat=None if y_hat is None else jnp.float32(y_hat))
    b = main_effect_indices(fp, port, 48, threefry.PRNGKey(5), task=task,
                            y_hat=None if y_hat is None else torch.tensor(y_hat))
    np.testing.assert_allclose(b.indices.numpy(), np.asarray(a.indices), atol=1e-5)
    assert b.n_evals == a.n_evals == 7 * 48


@pytest.mark.parametrize("case", ["constant", "nan", "all_agree"])
def test_indices_from_outputs_degenerate_variance_gives_zeros(case):
    """The one reduction both executors use: zero indices when Var(f) is
    ≈ 0 or NaN (the port's convention, where the two references differ on
    NaN), and the reference's estimate elsewhere."""
    m, k = 16, 3
    f = {"constant": np.full((k + 2) * m, 2.5, np.float32),
         "nan": np.full((k + 2) * m, np.nan, np.float32),
         "all_agree": np.ones((k + 2) * m, np.float32)}[case]
    task = "classification" if case == "all_agree" else "regression"
    idx, var_y = indices_from_outputs(torch.from_numpy(f), m, k, task=task,
                                      y_hat=torch.tensor(1.0))
    assert idx.shape == (k,) and (idx == 0).all()
    assert float(var_y) == 0.0 or np.isnan(float(var_y))


def test_guarantee_at_degenerate_sigma():
    """σ = 0: the indicator, decided in float64 (the port's convention, ROADMAP
    Queue 3): a float32-subnormal bias is not within δ = 0."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731

    def infu(y_hat, mean):
        return InferenceUncertainty(y_hat=f(y_hat), mean=f(mean), std=f(0.0),
                                    probs=torch.zeros(0), samples=torch.zeros(1))

    prob, ok = guarantee.satisfied(infu(0.0, 1e-38), 0.0, 0.95, "regression")
    assert float(prob) == 0.0 and not bool(ok)
    prob, ok = guarantee.satisfied(infu(0.0, 1e-38), 1e-37, 0.95, "regression")
    assert float(prob) == 1.0 and bool(ok)
    prob, ok = guarantee.satisfied(infu(2.0, 2.5), 0.4, 0.95, "regression")
    assert float(prob) == 0.0
    # away from the degenerate case the probability is the reference's
    u = InferenceUncertainty(y_hat=f(1.0), mean=f(1.2), std=f(0.3), probs=torch.zeros(0),
                             samples=torch.zeros(1))
    r = RefInfU(y_hat=jnp.float32(1.0), mean=jnp.float32(1.2), std=jnp.float32(0.3),
                probs=jnp.zeros(0), samples=jnp.zeros(1))
    np.testing.assert_allclose(float(guarantee.satisfied(u, 0.25, 0.95, "regression")[0]),
                               float(ref_guarantee.satisfied(r, 0.25, 0.95, "regression")[0]),
                               rtol=1e-6)
    assert float(guarantee.satisfied(u, 0.0, 0.95, "classification")[0]) == np.float32(1.2)


# ------------------------------------------------------------ executors
@pytest.fixture(scope="module")
def toy():
    """``tests/test_executor.py``'s toy store and linear model, built by the
    reference and by the port from the same arrays (same permutations,
    same float64 closed-form coefficients)."""
    rng = np.random.default_rng(0)
    G, R = 30, 3000
    gid = np.repeat(np.arange(G), R)
    mu = rng.normal(0, 5, G)
    vals = mu[gid] + rng.normal(0, 2.0, G * R)
    aux = 0.5 * mu[gid] + rng.normal(0, 1.0, G * R)
    X = np.stack([mu, 0.5 * mu], axis=1)
    y = 3 * X[:, 0] + 1.0 * X[:, 1] + rng.normal(0, 0.01, G)
    ref_store = RefStore().add("t", ref_build_table({"v": vals, "a": aux}, gid, seed=1))
    store = ColumnStore().add("t", build_table({"v": vals, "a": aux}, gid, seed=1))
    ref_lr, lr = RefLinear().fit(X, y), LinearRegression().fit(X, y)
    assert (np.asarray(ref_lr.coef) == lr.coef).all() and ref_lr.intercept == lr.intercept
    common = dict(name="toy", exact_features=[], task="regression",
                  scaler_mean=np.zeros(2, np.float32), scaler_scale=np.ones(2, np.float32),
                  delta_default=0.5)
    ref_pipe = RefPipeline(agg_features=[RefAggFeature("avg_v", "t", "v", "avg", "g"),
                                         RefAggFeature("avg_a", "t", "a", "avg", "g")],
                           model=ref_lr, **common)
    pipe = Pipeline(agg_features=[AggFeature("avg_v", "t", "v", "avg", "g"),
                                  AggFeature("avg_a", "t", "a", "avg", "g")],
                    model=lr, **common)
    return ref_store, ref_pipe, store, pipe


def _assert_same_result(a, b, classify=False):
    assert a.iters == b.iters
    np.testing.assert_array_equal(np.asarray(a.z), b.z)
    np.testing.assert_array_equal(np.asarray(a.n), b.n)
    assert a.samples_used == b.samples_used and a.samples_total == b.samples_total
    if classify:
        assert a.y_hat == b.y_hat
    else:
        assert abs(a.y_hat - b.y_hat) <= 1e-4 * max(1.0, abs(a.y_hat))
    assert abs(a.prob - b.prob) <= 1e-4
    assert a.satisfied == b.satisfied


KNOBS = {"batched": {}, "naive": dict(batch_afc=False), "adaptive": dict(adaptive_ami=True)}


@pytest.mark.parametrize("knobs", list(KNOBS), ids=list(KNOBS))
def test_host_loop_matches_reference_on_toy_store(toy, knobs):
    """Default δ and a tight δ, where the loop iterates."""
    ref_store, ref_pipe, store, pipe = toy
    iters = []
    for delta in (None, 0.08):
        kw = dict(delta=delta, m=400, m_sobol=96, **KNOBS[knobs])
        rex = RefExecutor(ref_store, RefConfig(**kw))
        ex = HostLoopExecutor(store, BiathlonConfig(**kw), device="cpu")
        for g in (1, 5):
            a = rex.run(ref_pipe, {"g": g}, jax.random.PRNGKey(g))
            b = ex.run(pipe, {"g": g}, threefry.PRNGKey(g))
            _assert_same_result(a, b)
            iters.append(b.iters)
    assert max(iters) > 2


def test_host_loop_runs_to_the_exact_plan_at_zero_delta(toy):
    """δ = 0: the plan grows to z = n (97 iterations), as the reference's.
    Its last probability is the degenerate-σ case, decided by the float32
    mean of m identical outputs: PyTorch's sum of them is exact here, so
    the port's σ is 0 and Pr = 1 (the answer of exact arithmetic), while
    XLA's sum rounds, leaves σ ≈ 1e-7 and a bias, and answers 0.  Both
    are satisfied by the exhausted plan."""
    ref_store, ref_pipe, store, pipe = toy
    kw = dict(delta=0.0, m=128, m_sobol=64, max_iters=200)
    a = RefExecutor(ref_store, RefConfig(**kw)).run(ref_pipe, {"g": 1}, jax.random.PRNGKey(0))
    b = HostLoopExecutor(store, BiathlonConfig(**kw), device="cpu").run(
        pipe, {"g": 1}, threefry.PRNGKey(0))
    assert a.iters == b.iters > 50
    np.testing.assert_array_equal(np.asarray(a.z), b.z)
    assert (b.z == b.n).all() and b.satisfied and a.satisfied
    assert abs(a.y_hat - b.y_hat) <= 1e-4 * max(1.0, abs(a.y_hat))
    assert b.prob == 1.0


def test_run_exact_matches_reference_on_toy_store(toy):
    ref_store, ref_pipe, store, pipe = toy
    for g in (0, 7):
        a, b = ref_run_exact(ref_store, ref_pipe, {"g": g})[0], run_exact(store, pipe, {"g": g},
                                                                          device="cpu")[0]
        assert abs(a - b) <= 1e-5 * max(1.0, abs(a))


@pytest.mark.parametrize("task", ["regression", "classification"])
@pytest.mark.parametrize("n_req", [0, 5])
def test_server_stats_summary_matches_reference(task, n_req):
    rng = np.random.default_rng(n_req)
    lists = dict(
        latencies=list(rng.uniform(1e-3, 5e-3, n_req)),
        exact_latencies=list(rng.uniform(1e-2, 3e-2, n_req)),
        errors_vs_exact=list(rng.choice([0.0, 0.1, 0.7], n_req)),
        sample_fracs=list(rng.uniform(0.05, 1.0, n_req)),
        iters=list(rng.integers(0, 9, n_req)),
    )
    want = RefStats(**lists).summary(0.5, task)
    got = ServerStats(**lists).summary(0.5, task)
    assert got.keys() == want.keys()
    for key in want:
        assert (got[key] == want[key]) or (np.isnan(got[key]) and np.isnan(want[key])), key
