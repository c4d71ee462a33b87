"""PyTorch port vs the JAX reference: tree-ensemble inference and CART training.

The port's plain ``ensemble_predict_sum`` is held against the reference's
jnp oracle and its Pallas ``ensemble_sum`` in interpret mode (atol 1e-5:
the summation order over trees differs).  Training is numpy in both, so the
tree arrays must be bit-equal.  The CUDA kernel is held against this plain
version in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tree_qmc.tree_qmc import ensemble_sum as ref_ensemble_sum
from repro.models.tabular.trees import GradientBoosting as RefGBM
from repro.models.tabular.trees import RandomForest as RefRF
from repro.models.tabular.trees import ensemble_predict_sum as ref_predict_sum
from repro_torch.kernels.tree_qmc.ops import predict_sum
from repro_torch.models.tabular.trees import GradientBoosting, RandomForest, ensemble_predict_sum

ARRAYS = ("feature", "threshold", "left", "right", "value")



def _data(n=600, f=9, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    y = X[:, 0] * 2 + np.sin(X[:, 1] * 3) + 0.1 * rng.normal(size=n)
    return X, y


@pytest.fixture(scope="module")
def forests():
    """(port, reference) pairs: RF 12×(depth 6), GBM 10×(depth 4), and
    both as binary classifiers."""
    X, y = _data()
    yc = (y > np.median(y)).astype(np.float64)
    return {
        "rf": (RandomForest(n_trees=12, max_depth=6, seed=1).fit(X, y),
               RefRF(n_trees=12, max_depth=6, seed=1).fit(X, y)),
        "gbm": (GradientBoosting(n_trees=10, max_depth=4, seed=2).fit(X, y),
                RefGBM(n_trees=10, max_depth=4, seed=2).fit(X, y)),
        "rf_cls": (RandomForest(n_trees=8, max_depth=5, task="classification").fit(X, yc),
                   RefRF(n_trees=8, max_depth=5, task="classification").fit(X, yc)),
        "gbm_cls": (GradientBoosting(n_trees=8, max_depth=4, task="classification").fit(X, yc),
                    RefGBM(n_trees=8, max_depth=4, task="classification").fit(X, yc)),
    }


@pytest.mark.parametrize("kind", ["rf", "gbm", "rf_cls", "gbm_cls"])
def test_cart_training_is_bit_equal(forests, kind):
    port, ref = forests[kind]
    for a in ARRAYS:
        got = getattr(port.ensemble, a).numpy()
        want = np.asarray(getattr(ref.ensemble, a))
        assert got.dtype == want.dtype and (got == want).all(), a
    assert port.ensemble.depth == ref.ensemble.depth
    assert port.base == ref.base


@pytest.mark.parametrize("kind", ["rf", "gbm"])
@pytest.mark.parametrize("m", [1, 257, 1001])
def test_ensemble_predict_sum_matches_reference(forests, kind, m):
    port, ref = forests[kind]
    x = np.random.default_rng(m).normal(0, 1.2, (m, 9)).astype(np.float32)
    got = ensemble_predict_sum(port.ensemble, torch.from_numpy(x)).numpy()
    want = np.asarray(ref_predict_sum(ref.ensemble, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    e = ref.ensemble
    kern = ref_ensemble_sum(e.feature, e.threshold, e.left, e.right, e.value, jnp.asarray(x),
                            depth=e.depth, block_m=m, block_t=e.n_trees, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["rf", "gbm", "rf_cls", "gbm_cls"])
def test_predict_matches_reference(forests, kind):
    port, ref = forests[kind]
    x = np.random.default_rng(9).normal(0, 1, (300, 9)).astype(np.float32)
    got = port.predict(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.predict(jnp.asarray(x)))
    if kind.endswith("_cls"):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_thresholds_route_exactly_at_the_split(forests):
    """x equal to a threshold goes left (``x <= thr``), as in the reference."""
    port, ref = forests["rf"]
    e = port.ensemble
    t, node = 0, 0
    f, thr = int(e.feature[t, node]), float(e.threshold[t, node])
    x = np.zeros((2, 9), np.float32)
    x[0, f] = thr
    x[1, f] = np.nextafter(np.float32(thr), np.float32(np.inf))
    got = ensemble_predict_sum(port.ensemble, torch.from_numpy(x)).numpy()
    want = np.asarray(ref_predict_sum(ref.ensemble, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
