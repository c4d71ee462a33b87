"""Clipping, LR schedules and gradient compression against the JAX reference, on the CPU.

``clip_by_global_norm`` (below, at and above the norm; bf16 and float32
leaves), ``cosine_schedule`` and ``linear_warmup_cosine`` (steps as ints
and as 0-d tensors, through warmup, decay and past the end) and
``optim/compress.py`` (int8 quantization and its inverse on ragged and
exact block counts, round-half-to-even ties included; error feedback over
three steps).  The norm and the schedules within 2 float32 ulps
(``jnp.cos`` and ``torch.cos`` may differ by one ulp; XLA and PyTorch sum
the squares in another order); the clipped leaves within 1e-6 relative;
quantization bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.optim import adamw, compress

ULP2 = 2 * 2.0 ** -23


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (13, 7)).astype(np.float32),
            "blocks": {"a": rng.normal(0, 3, (4, 33)).astype(np.float32),
                       "b": rng.normal(0, 0.1, (5,)).astype(np.float32)}}


def _sorted_leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def _torch(tree, dtype=torch.float32):
    return adamw.tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm, dtype):
    g = _grads(0)
    want, want_norm = ref_adamw.clip_by_global_norm(
        jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), g), max_norm)
    got, norm = adamw.clip_by_global_norm(_torch(g, getattr(torch, dtype)), max_norm)
    assert norm.dtype == torch.float32
    assert abs(float(norm) - float(want_norm)) <= ULP2 * float(want_norm)
    for (a, b) in zip(_sorted_leaves(got), jax.tree.leaves(want)):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        tol = 1e-6 if dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(a, b, rtol=tol, atol=0)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("kind", ["cosine", "warmup_cosine"])
def test_schedules_match_reference(kind, as_tensor):
    if kind == "cosine":
        want_fn, got_fn = ref_adamw.cosine_schedule(3e-4, 50), adamw.cosine_schedule(3e-4, 50)
    else:
        want_fn = ref_adamw.linear_warmup_cosine(1e-3, 10, 60)
        got_fn = adamw.linear_warmup_cosine(1e-3, 10, 60)
    for step in (0, 1, 5, 9, 10, 11, 30, 59, 60, 75):
        want = float(want_fn(jnp.asarray(step, jnp.int32)))
        got = got_fn(torch.tensor(step, dtype=torch.int32) if as_tensor else step)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= ULP2 * abs(want) + 1e-12, step


@pytest.mark.parametrize("block", [4, 16, 256])
@pytest.mark.parametrize("shape", [(7, 5), (64,), (3, 4, 8)])
def test_quantize_and_dequantize_match_reference_bitwise(shape, block):
    rng = np.random.default_rng(sum(shape) + block)
    x = rng.normal(0, 2, shape).astype(np.float32)
    x.flat[0] = 127.0 * 0.5          # ties of the scale's multiples
    x.flat[-1] = -2.5
    q, s, shp, pad = compress.quantize_int8(torch.from_numpy(x), block)
    rq, rs, rshp, rpad = ref_compress.quantize_int8(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and shp == tuple(rshp) and pad == rpad
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    back = compress.dequantize_int8(q, s, shp, pad)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(ref_compress.dequantize_int8(rq, rs, rshp, rpad)))


def test_round_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 127.0], dtype=torch.float32)
    q, s, *_ = compress.quantize_int8(x, block=6)
    assert float(s[0, 0]) == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]


def test_error_feedback_matches_reference_over_steps():
    ef = ref_ef = None
    for step in range(3):
        g = _grads(10 + step)
        got, ef, rel = compress.compress_with_error_feedback(_torch(g), ef, block=16)
        want, ref_ef, ref_rel = ref_compress.compress_with_error_feedback(
            jax.tree.map(jnp.asarray, g), ref_ef, block=16)
        for a, b in zip(_sorted_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(_sorted_leaves(ef), jax.tree.leaves(ref_ef)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert abs(float(rel) - float(ref_rel)) <= 1e-6 * float(ref_rel)
        assert 0 < float(rel) < 0.05
