"""The train step, remat and ``synthetic_batch`` against the reference, on the CPU.

* ``build_train_step``: three steps from the same weights and batches as
  the reference's (jitted) step, with ``grad_accum`` 1 and 2: each step's
  loss within 1e-5 relative, its grad norm within 1e-4 (each gradient leaf
  is within 1e-4 · its max, ``test_torch_train_grads.py``), its learning
  rate within 2 float32 ulps; the parameters after three steps within
  2 · Σ lr of the reference's (AdamW normalises each element's update to
  about lr, so an element whose gradient is float32 noise in both runs can
  move up to 2 · lr a step apart; the largest gap seen is 7e-5 at lr 1e-3).
* ``remat=True`` against ``remat=False``: the loss and every gradient
  bitwise (the recomputation repeats the same operations).
* ``synthetic_batch``: the reference's tokens and frontends bit for bit, for
  all ten configs (and the full qwen vocab of 151936, whose randint
  multiplier wraps to 0 in uint32).

The trainer, the launcher and the example: ``test_torch_train_loop.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.lm import LM as RefLM
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import linear_warmup_cosine as ref_warmup_cosine
from repro.train.step import build_train_step as ref_build_train_step
from repro.train.trainer import synthetic_batch as ref_synthetic_batch
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.lm import LM
from repro_torch.optim.adamw import adamw_init, linear_warmup_cosine
from repro_torch.train import build_train_step, synthetic_batch
from repro_torch.train.step import loss_and_grads
from torch_pipeline_parity import one_torch_thread  # noqa: F401  (autouse)
from torch_train_parity import batch, models, to_numpy, walk

ULP2 = 2 * 2.0 ** -23


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-236b", "xlstm-1.3b"])
def test_three_train_steps_match_reference(arch, grad_accum):
    ref_lm, ref_p, lm, p = models(arch)
    ref_step = jax.jit(ref_build_train_step(ref_lm, lr_schedule=ref_warmup_cosine(1e-3, 1, 10),
                                            grad_accum=grad_accum))
    step_fn = build_train_step(lm, lr_schedule=linear_warmup_cosine(1e-3, 1, 10),
                               grad_accum=grad_accum)
    ref_opt, opt = ref_adamw_init(ref_p), adamw_init(p)
    lr_sum = 0.0
    for step in range(3):
        b = batch(lm, seed=5, step=step, b=4)
        ref_p, ref_opt, want = ref_step(ref_p, ref_opt, {k: jnp.asarray(v) for k, v in b.items()},
                                        jnp.asarray(step, jnp.int32))
        p, opt, got = step_fn(p, opt, {k: torch.from_numpy(v) for k, v in b.items()},
                              torch.tensor(step, dtype=torch.int32))
        assert set(got) == set(want)
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
        assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= 1e-4 * float(
            want["grad_norm"])
        assert abs(float(got["lr"]) - float(want["lr"])) <= ULP2 * float(want["lr"])
        lr_sum += float(want["lr"])
    assert int(opt.step) == int(ref_opt.step) == 3
    want_p = dict(walk(jax.tree.map(to_numpy, ref_p)))
    for path, t in walk(p):
        assert str(t.dtype).removeprefix("torch.") == str(want_p[path].dtype), path
        assert np.abs(to_numpy(t) - want_p[path]).max() <= 2 * lr_sum, path


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v2-236b", "internvl2-1b",
                                  "xlstm-1.3b", "zamba2-2.7b", "seamless-m4t-large-v2"])
def test_remat_changes_no_bit(arch):
    _, _, lm, params = models(arch)
    b = {k: torch.from_numpy(v) for k, v in batch(lm, seed=6).items()}
    lm.remat = False
    loss, _, grads = loss_and_grads(lm, params, b)
    lm.remat = True
    loss_r, _, grads_r = loss_and_grads(lm, params, b)
    assert torch.equal(loss, loss_r)
    for (path, g), (_, g_r) in zip(walk(grads), walk(grads_r)):
        assert torch.equal(g, g_r), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_synthetic_batch_is_the_references_bitwise(arch):
    ref_lm, lm = RefLM(ref_get_config(arch).reduced()), LM(get_config(arch).reduced())
    for seed, step in ((0, 0), (3, 17)):
        want = ref_synthetic_batch(ref_lm, 3, 40, seed, step)
        got = synthetic_batch(lm, 3, 40, seed, step)
        assert set(got) == set(want)
        for name, w in want.items():
            w = np.asarray(w)
            g = got[name].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def test_synthetic_batch_full_vocab_is_the_references_bitwise():
    ref_lm, lm = RefLM(ref_get_config("qwen1.5-0.5b")), LM(get_config("qwen1.5-0.5b"))
    want = np.asarray(ref_synthetic_batch(ref_lm, 2, 64, 0, 3)["tokens"])
    np.testing.assert_array_equal(synthetic_batch(lm, 2, 64, 0, 3)["tokens"].numpy(), want)
