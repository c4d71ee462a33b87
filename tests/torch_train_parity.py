"""Shared set-up of the LM training parity tests (``tests/test_torch_train*.py``).

The parameters come from the port's ``LM.init`` in float32 with the leaves
that ``init`` leaves at 0 or 1 (norms, biases, the SSM cells' gate and
decay leaves) overwritten by seeded numpy noise, so that every leaf's
gradient is exercised; they are handed to the reference as arrays of the
types its ``init`` gives and to the port by ``bridge.lm_params_from_numpy``.
Mamba2's ``dt_bias`` and ``a_log`` get narrow noise: with the serving
tests' wider noise a chunk's decay ``exp(cum_i − cum_j)`` overflows to inf
on the masked upper triangle, and both packages' gradients turn NaN there
(0 · inf through the mask's ``where``; ``WIDE``, and
``test_torch_train_families.py`` pins that the NaNs coincide).
Batches are ``synthetic_batch``'s (bitwise the reference's) with one label
masked out (-1).  The reference's loss and gradients are jitted and
compiled without XLA's excess precision, so that a bf16 value is rounded
where the program rounds it, as in the port.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models.lm import LM as RefLM
from repro_torch.bridge import lm_params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models.lm import LM
from repro_torch.train.trainer import synthetic_batch

STRICT = {"xla_allow_excess_precision": False}
# leaf -> (centre, spread) of the noise that replaces it (0 or 1 at init)
NOISY = {"dt_bias": (0.0, 0.3), "a_log": (0.0, 0.2), "d_skip": (1.0, 0.5), "conv_b": (0.0, 0.3),
         "b_i": (0.0, 0.5), "b_f": (3.0, 0.5), "out_norm": (1.0, 0.3), "ln": (1.0, 0.3),
         "ln1": (1.0, 0.3), "ln2": (1.0, 0.3), "ln_x": (1.0, 0.3), "final_norm": (1.0, 0.3),
         "enc_norm": (1.0, 0.3), "q_norm": (1.0, 0.3), "k_norm": (1.0, 0.3),
         "kv_norm": (1.0, 0.3), "bq": (0.0, 0.3), "bk": (0.0, 0.3), "bv": (0.0, 0.3)}
# the serving tests' noise of the two Mamba2 leaves (test_torch_lm_families.py)
WIDE = {"dt_bias": (0.5, 0.5), "a_log": (0.0, 0.5)}
B, S = 2, 32
LOSS_CHUNK = 16  # two chunks of the 32 positions (the VLM's 24 text positions: 2 of 12)


def walk(tree, path=()):
    """(path, leaf) pairs of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, (*path, i))
    else:
        yield path, tree


def _set(out, path, val):
    node = out
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, dict):
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
        else:
            while len(node) <= k:
                node.append([] if isinstance(nxt, int) else {})
            node = node[k]
    if isinstance(node, dict):
        node[path[-1]] = val
    else:
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = val


def noisy_numpy(tree, rng, noise=None):
    """The tree as float32 numpy, the ``noise`` leaves (default ``NOISY``;
    and sLSTM's ``b``) replaced by noise."""
    noise = NOISY if noise is None else noise
    out: dict = {}
    for path, t in walk(tree):
        a = t.float().numpy()
        name = path[-1]
        if name in noise or path[-3:] == ("slstm", "cell", "b"):
            centre, spread = noise.get(name, (0.0, 0.5))
            a = (a if name == "b" else centre) + rng.normal(0, spread, a.shape)
        _set(out, path, a.astype(np.float32))
    return out


def to_ref(tree, shapes):
    """Numpy tree -> the reference's arrays, in the types its ``init`` gives."""
    if isinstance(tree, dict):
        return {k: to_ref(v, shapes[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_ref(v, s) for v, s in zip(tree, shapes)]
    return jnp.asarray(tree).astype(shapes.dtype)


def cfgs(arch, dtype="float32"):
    return (dataclasses.replace(ref_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


@functools.cache
def float32_params(arch, wide=False):
    _, cfg = cfgs(arch)
    return noisy_numpy(LM(cfg).init(torch.Generator().manual_seed(0)), np.random.default_rng(1),
                       dict(NOISY, **WIDE) if wide else NOISY)


def models(arch, dtype="float32", wide=False, **kw):
    """(reference LM, its params, port LM, its params) on the same weights."""
    ref_cfg, cfg = cfgs(arch, dtype)
    kw = {"attn_block": 64, "loss_chunk": LOSS_CHUNK, **kw}
    ref_lm = RefLM(ref_cfg, remat=False, **kw)
    lm = LM(cfg, remat=False, **kw)
    params = float32_params(arch, wide)
    shapes = jax.eval_shape(ref_lm.init, jax.random.PRNGKey(0))
    return ref_lm, to_ref(params, shapes), lm, lm_params_from_numpy(params, lm.dtype)


def batch(lm, seed=0, step=0, b=B, s=S):
    """``synthetic_batch`` (numpy) with the label of one position masked."""
    out = {k: v.numpy().copy() for k, v in synthetic_batch(lm, b, s, seed, step).items()}
    out["tokens"][0, 5] = -1
    return out


@functools.cache
def _compiled(fn, treedef, avals):
    return jax.jit(fn).lower(*jax.tree.unflatten(treedef, avals)).compile(STRICT)


def strict(fn, *args):
    """``fn(*args)`` jitted and compiled without excess precision (once per
    function and argument shapes)."""
    leaves, treedef = jax.tree.flatten(args)
    avals = tuple(jax.ShapeDtypeStruct(a.shape, a.dtype) for a in leaves)
    return _compiled(fn, treedef, avals)(*args)


def to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def port_loss_and_grads(lm, params, batch_np):
    """(loss, metrics, grads by leaf path) of the port's ``train_loss``."""
    from repro_torch.train.step import loss_and_grads

    tb = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    loss, metrics, grads = loss_and_grads(lm, params, tb)
    return loss, metrics, dict(walk(grads))


@functools.cache
def _ref_grad_fn(ref_lm):
    return jax.value_and_grad(ref_lm.train_loss, has_aux=True)


def ref_loss_and_grads(ref_lm, ref_params, batch_np):
    (loss, metrics), grads = strict(_ref_grad_fn(ref_lm), ref_params,
                                    {k: jnp.asarray(v) for k, v in batch_np.items()})
    return loss, metrics, dict(walk(jax.tree.map(to_numpy, grads)))


def grad_errors(got: dict, want: dict) -> dict:
    """max |Δ| / max |g_ref| of each leaf (paths equal)."""
    assert set(got) == set(want)
    out = {}
    for path, g in got.items():
        w = want[path]
        assert tuple(g.shape) == w.shape, path
        out[path] = float(np.abs(to_numpy(g) - w).max() / max(np.abs(w).max(), 1e-30))
    return out
