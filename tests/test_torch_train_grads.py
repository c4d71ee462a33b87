"""``LM.train_loss`` and its gradients against the JAX reference, on the CPU:
the dense, VLM and MoE families (seven configs, MLA included).

At each config's ``.reduced()`` size in float32, on the same weights (norms,
biases and gate leaves overwritten by noise, ``torch_train_parity``) and the
same ``synthetic_batch`` with one label masked: the loss within 1e-5
relative, ``acc`` and ``tokens`` equal, and every gradient leaf within
1e-4 · max |g_ref| of the reference's (``jax.value_and_grad`` of its
``train_loss``; the port's autograd through the plain attention, the route
the CPU takes).  The MoE configs route each token to the same experts in
both packages (a top-k near-tie would send it elsewhere and change the
loss by far more than these bounds; none occurs on these inputs).
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
)

ARCHS = ("deepseek-v2-236b", "granite-moe-1b-a400m", "qwen3-14b", "qwen1.5-0.5b", "gemma-7b",
         "qwen3-8b", "internvl2-1b")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_reference(arch):
    ref_lm, ref_params, lm, params = models(arch)
    b = batch(lm, seed=3, step=1)
    want_loss, want_m, want_g = ref_loss_and_grads(ref_lm, ref_params, b)
    loss, m, got_g = port_loss_and_grads(lm, params, b)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    assert float(m["tokens"]) == float(want_m["tokens"]) == b["tokens"][:, 1:].size - 1
    assert float(m["acc"]) == float(want_m["acc"])
    errs = grad_errors(got_g, want_g)
    bad = {p: e for p, e in errs.items() if not e <= GRAD_TOL}
    assert not bad, bad
    assert all(np.isfinite(e) for e in errs.values())
