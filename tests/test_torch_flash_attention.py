"""The port's plain flash attention against the JAX Pallas kernel.

The JAX side runs the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it on the CPU; the port's side is its plain
version (``kernels/flash_attention/ref.py``), which a CPU tensor always
reaches.  The roundings of the card's bf16 tensor-core kernel are emulated
by ``kernels/flash_attention/emulation.py`` and held to the card's
tolerance.  Inputs are made from a seed with numpy.  Tolerances: float32
within 1e-5 (both compute in float32 and differ only in summation order);
bf16 at the reference's own 3e-2 (one bf16 rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.flash_attention import flash_attention as ref_flash
from repro.models.lm.layers import attention_full as ref_attention_full
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.emulation import bf16_path
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# the card tests' bf16 tolerance (ATTN_TOL in tests/test_torch_cuda.py, chip_smoke.py)
CARD_BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _qkv(seed, q_shape, k_shape, v_shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, s).astype(np.float32) for s in (q_shape, k_shape, v_shape))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,s,d,bq,bk", [
    (1, 2, 128, 64, 64, 64),
    (2, 1, 256, 32, 128, 128),
    (1, 2, 256, 64, 128, 64),
])
def test_plain_matches_pallas_kernel_f32(causal, b, h, s, d, bq, bk):
    q, k, v = _qkv(s + d, *(3 * [(b, h, s, d)]))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     block_q=bq, block_k=bk, interpret=True)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_plain_matches_pallas_kernel_bf16():
    q, k, v = _qkv(9, *(3 * [(1, 2, 128, 64)]))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = ref_flash(jq, jk, jv, causal=True, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention_ref(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def test_plain_aligns_the_causal_mask_at_the_top_left():
    """Sq != Sk: query row i sees keys 0..i, as the reference's attention_full
    with no q offset (the Pallas kernel only takes tile multiples)."""
    q, k, v = _qkv(3, (1, 48, 2, 32), (1, 80, 2, 32), (1, 80, 2, 16))
    want = ref_attention_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = flash_attention_ref(*(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)),
                              causal=True).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ops_attention_matches_reference_with_gqa(causal):
    """H = 4 query heads on Hkv = 2 KV heads, model layout (B, S, H, D); a CPU
    tensor takes the plain version whatever ``use_kernel`` says."""
    q, k, v = _qkv(11, (2, 128, 4, 32), (2, 128, 2, 32), (2, 128, 2, 32))
    want = ref_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    build.reset_launch_counts()
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.attention(tq, tk, tv, causal=causal)
    assert got.shape == (2, 128, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert torch.equal(got, ops.attention(tq, tk, tv, causal=causal, use_kernel=False))
    assert not build.LAUNCHES


@pytest.mark.parametrize("b,h,s,d,block_k,pallas_block", [
    (1, 4, 1024, 64, 128, 256),   # the model's head dim: 128-key tiles
    (1, 2, 300, 128, 128, 100),   # ragged against the 128-key tiles
])
def test_bf16_kernel_roundings_stay_within_the_card_tolerance(b, h, s, d, block_k, pallas_block):
    """The bf16 tensor-core kernel's roundings (scale on the float32 scores,
    exp2, online rescale, P rounded to bf16 per key tile), emulated by
    ``kernels/flash_attention/emulation.py``, stay within the card tests' bf16
    tolerance (rtol = atol = 1e-2) of the float32 plain version and of the
    Pallas kernel in interpret mode, at causal bf16 shapes."""
    q, k, v = _qkv(s + d, *(3 * [(b, h, s, d)]))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = bf16_path(tq, tk, tv, causal=True, block_k=block_k)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, s, d)
    plain = flash_attention_ref(tq.float(), tk.float(), tv.float(), causal=True)
    torch.testing.assert_close(got.float(), plain, **CARD_BF16_TOL)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = ref_flash(jq, jk, jv, causal=True, block_q=pallas_block, block_k=pallas_block,
                     interpret=True)
    torch.testing.assert_close(got.float(), torch.from_numpy(np.asarray(want, np.float32)),
                               **CARD_BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,window", [
    (96, 96, 1),      # each row sees itself only
    (96, 96, 17),     # a window within one tile
    (300, 300, 130),  # across 128-key tiles
    (48, 80, 20),     # Sq < Sk, top-left alignment
    (80, 48, 40),     # Sq > Sk: Sq - window < Sk, every row keeps a key
    (64, 64, 64),     # the window covers every earlier key
])
def test_plain_window_matches_attention_full(causal, sq, sk, window):
    """``flash_attention_ref(window=)``, and ``ops.attention(window=)`` on a
    CPU tensor, against the reference's ``attention_full(window=)`` (no q
    offset): keys at or below q − window masked, causal or not, GQA."""
    q, k, v = _qkv(sq * 7 + window, (1, sq, 4, 32), (1, sk, 2, 32), (1, sk, 2, 16))
    want = ref_attention_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                              window=window)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    expand = lambda t: t.transpose(1, 2).repeat_interleave(2, dim=1)  # noqa: E731
    plain = flash_attention_ref(tq.transpose(1, 2), expand(tk), expand(tv), causal=causal,
                                window=window)
    assert torch.equal(plain.transpose(1, 2), got)


@pytest.mark.parametrize("causal,window,sq,sk", [
    (True, 100, 300, 300),
    (True, 64, 512, 512),
    (False, 100, 384, 512),
])
def test_bf16_kernel_roundings_with_a_window(causal, window, sq, sk):
    """The emulated bf16 kernel with a window stays within the card tests'
    bf16 tolerance of the float32 plain version, and the last query tile's
    output does not depend on the key tiles wholly below its window (which
    the kernel skips): other keys and values there change no bit."""
    q, k, v = _qkv(window + sk, (1, 2, sq, 64), (1, 2, sk, 64), (1, 2, sk, 64))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = bf16_path(tq, tk, tv, causal=causal, block_k=128, window=window)
    plain = flash_attention_ref(tq.float(), tk.float(), tv.float(), causal=causal, window=window)
    torch.testing.assert_close(got.float(), plain, **CARD_BF16_TOL)
    q0 = (sq - 1) // 128 * 128
    first = max(0, q0 - window + 1) // 128 * 128
    assert first > 0
    other_k, other_v = tk.clone(), tv.clone()
    other_k[:, :, :first] = -tk[:, :, :first] * 3
    other_v[:, :, :first] = 1e3
    other = bf16_path(tq, other_k, other_v, causal=causal, block_k=128, window=window)
    assert torch.equal(other[:, :, q0:], got[:, :, q0:])
