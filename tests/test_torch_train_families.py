"""``LM.train_loss`` and its gradients against the JAX reference, on the CPU:
the SSM (xlstm-1.3b), hybrid (zamba2-2.7b) and audio (seamless-m4t-large-v2)
families, and one bf16 case.

As ``test_torch_train_grads.py``: ``.reduced()`` configs in float32, the
same weights (gate and decay leaves, norms and biases noisy) and
``synthetic_batch`` (the audio family's frontend frames included); the loss
within 1e-5 relative and every gradient leaf within 1e-4 · max |g_ref|.
The xLSTM's stabilisers (running maxima, ``torch.maximum`` against
``jnp.maximum``: both split a tie's gradient evenly) and the sLSTM's
step-by-step loop are where a difference would show first.  The hybrid runs
S = 96 and 128 too, with ``attn_block=32``, so the reference takes its
blockwise attention with the window (the port's CPU route follows it).

The reference's Mamba2 gradient is NaN where a chunk's decay overflows
(``exp(cum_i − cum_j)`` is inf on the masked upper triangle, and the mask's
``where`` sends back 0 · inf); the port computes the same and gives NaN at
the same elements, which ``test_hybrid_overflowing_decay_nans_are_the_
references`` pins with the serving tests' wider noise on ``dt_bias`` and
``a_log``.  The other tests keep those two leaves' noise narrow enough
that no decay overflows (ROADMAP Queue 3).

bf16: qwen1.5-0.5b in the model's type, the reference compiled without
excess precision: loss within 3e-2 relative and each gradient leaf within
3e-2 · max |g_ref| (bf16 keeps 8 bits; the two packages round the same
values in the same places but sum in different orders, which moves a
rounding by one ulp here and there, 2^-8 relative, and that drifts through
the backward pass's chain of bf16 products).
"""
import numpy as np
import pytest

from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_train_parity import (
    batch,
    grad_errors,
    models,
    port_loss_and_grads,
    ref_loss_and_grads,
    to_numpy,
)

ARCHS = ("xlstm-1.3b", "zamba2-2.7b", "seamless-m4t-large-v2")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 3e-2


def _check(arch, dtype, loss_rtol, grad_tol, s=32, **kw):
    ref_lm, ref_params, lm, params = models(arch, dtype, **kw)
    b = batch(lm, seed=4, step=2, s=s)
    want_loss, want_m, want_g = ref_loss_and_grads(ref_lm, ref_params, b)
    loss, m, got_g = port_loss_and_grads(lm, params, b)
    assert abs(float(loss) - float(want_loss)) <= loss_rtol * abs(float(want_loss))
    assert float(m["tokens"]) == float(want_m["tokens"])
    errs = grad_errors(got_g, want_g)
    bad = {p: e for p, e in errs.items() if not e <= grad_tol}
    assert not bad, bad
    assert all(np.isfinite(e) for e in errs.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_reference(arch):
    _check(arch, "float32", LOSS_RTOL, GRAD_TOL)


@pytest.mark.parametrize("s", [96, 128])
def test_hybrid_windowed_blockwise_gradients_match_reference(s):
    _check("zamba2-2.7b", "float32", LOSS_RTOL, GRAD_TOL, s=s, attn_block=32)


def test_hybrid_overflowing_decay_nans_are_the_references():
    ref_lm, ref_params, lm, params = models("zamba2-2.7b", wide=True)
    b = batch(lm, seed=4, step=2)
    want_loss, _, want_g = ref_loss_and_grads(ref_lm, ref_params, b)
    loss, _, got_g = port_loss_and_grads(lm, params, b)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    n_nan = 0
    for path, g in got_g.items():
        got, want = to_numpy(g), want_g[path]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=str(path))
        n_nan += int(np.isnan(want).sum())
    assert n_nan > 0


def test_bf16_train_loss_and_gradients_match_reference():
    _check("qwen1.5-0.5b", "bfloat16", BF16_TOL, BF16_TOL)
