"""The parts of ``jax.random`` that the holistic bootstrap draws from.

The reference draws its bootstrap replicate ranks from JAX's counter-based
threefry2x32 generator (``kernels/sampled_agg/ops.py::bootstrap_rank_targets``).
Without the same bits the port's z-plans could not be held to the
reference's, so this module reproduces them: the Threefry-2x32 hash (20
rounds, Salmon et al. 2011) and JAX's key derivation in its *partitionable*
layout, where element ``i`` of a draw hashes the 64-bit counter ``i`` split
into ``(hi, lo)`` 32-bit halves.

Keys are host values, as in JAX a key is a ``(2,)`` uint32 array:
``PRNGKey``, ``split`` and ``fold_in`` return numpy uint32 arrays and hash
on Python integers (a handful per draw, so no device work).  The bulk bits
are torch int64 tensors holding uint32 values (every intermediate masked to
32 bits, as ``core/qmc.sobol_uint32`` holds its points) on the device the
caller names.  ``random_bits``, ``uniform`` and ``normal`` accept one key
``(2,)`` or a stack of keys ``(K, 2)``; a stack draws each key's array in
one batched hash, ``(K, *shape)``, element for element what K separate
draws give.  :func:`random_bits` also takes its keys as an int64 tensor on
the draw's device: a step captured in a CUDA graph cannot copy a host key
in, so the fused executor derives its keys once on the host and gathers
them on the card (``kernels/sampled_agg/ops.boot_key_table``).
:func:`host_bits` hashes a small draw in numpy, for a caller that wants one
copy to the card instead of a few hundred operators there.

Floats follow ``jax._src.random``: ``uniform`` sets the top 23 random bits
as the mantissa of a float in [1, 2), subtracts 1, scales with one rounding
(XLA contracts the multiply-add into an FMA) and clamps at ``minval``;
``normal`` is ``√2 · erf_inv(uniform(nextafter(−1, 0), 1))`` with XLA's
float32 ``erf_inv`` (Giles' single-precision polynomial, Horner steps as
FMAs) on XLA's own float32 ``log1p`` (``numerics.log1p``).  Against the
reference on the CPU, bits, uniforms and normals are all bit-exact
(``tests/test_torch_holistic.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.numerics import fma, log1p, sqrt

__all__ = [
    "PRNGKey",
    "bits_to_normal",
    "bits_to_uniform",
    "fold_in",
    "host_bits",
    "normal",
    "random_bits",
    "split",
    "threefry2x32",
    "uniform",
]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds: ``(x1, x2) -> (y1, y2)`` under key ``(k1, k2)``.

    Works on anything with ``+ ^ << >> &``: Python ints, or int64 tensors
    holding uint32 values (all four broadcast together).
    """
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _key(key) -> tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32)
    if k.shape != (2,):
        raise ValueError(f"expected one key of shape (2,), got shape {k.shape}")
    return int(k[0]), int(k[1])


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (JAX's name)
    """The key of an integer seed: ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
    return np.array([seed >> 32, seed & _M32], dtype=np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``(num, 2)`` new keys: key ``i`` is the hash of the counter ``(0, i)``."""
    k1, k2 = _key(key)
    return np.array([threefry2x32(k1, k2, 0, i) for i in range(num)], dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """A new key from ``key`` and a 32-bit integer: the hash of ``(0, data)``."""
    k1, k2 = _key(key)
    return np.array(threefry2x32(k1, k2, 0, int(data) & _M32), dtype=np.uint32)


def _hash_counts(k1, k2, idx):
    """Bits of the element indices ``idx`` under ``(k1, k2)``: the XOR of the
    two words of the hash of ``(idx >> 32, idx & 0xFFFFFFFF)``."""
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return y1 ^ y2


def random_bits(key, shape, *, device) -> torch.Tensor:
    """uint32 random bits (in int64) of ``shape``, per key: ``lead + shape``.

    Partitionable layout: element ``i`` (row-major) hashes ``(i >> 32, i &
    0xFFFFFFFF)``, and its bits are the XOR of the hash's two words.
    ``key`` is a numpy key ``(2,)`` or stack ``(K, 2)``, or the same as an
    int64 tensor (uint32 values), which is used where it lies.
    """
    if torch.is_tensor(key):
        kt = key.to(device=device, dtype=torch.int64)
    else:
        kt = torch.from_numpy(np.asarray(key, dtype=np.uint32).astype(np.int64)).to(device)
    if kt.dim() not in (1, 2) or kt.shape[-1] != 2:
        raise ValueError(f"expected a key (2,) or keys (K, 2), got shape {tuple(kt.shape)}")
    shape = tuple(int(s) for s in shape)
    lead = tuple(kt.shape[:-1])
    kt = kt.reshape(-1, 1, 2)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return _hash_counts(kt[..., 0], kt[..., 1], idx[None]).reshape(lead + shape)


def host_bits(key, shape) -> np.ndarray:
    """:func:`random_bits` of one key hashed in numpy on the host: an int64
    array of uint32 values, bit for bit the tensor's."""
    k1, k2 = _key(key)
    idx = np.arange(math.prod(int(s) for s in shape), dtype=np.int64)
    return _hash_counts(k1, k2, idx).reshape(tuple(int(s) for s in shape))


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0, *, device) -> torch.Tensor:
    """float32 uniforms on ``[minval, maxval)``, as ``jax.random.uniform`` draws them."""
    return bits_to_uniform(random_bits(key, shape, device=device), minval, maxval)


def bits_to_uniform(bits: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """The uniforms of :func:`uniform` from its :func:`random_bits`."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)  # top 23 bits, exponent of 1.0
    floats = mant.view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)  # float32 subtraction, as in JAX
    return torch.clamp(fma(floats, span, float(lo)), min=float(lo))


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function", 2010)
_ERFINV_LT5 = [float(np.float32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)]
_ERFINV_GE5 = [float(np.float32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)]


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's polynomial on ``w = −log1p(−x²)``.

    ``log1p`` is XLA's own (``numerics.log1p``), ``sqrt`` correctly
    rounded, and each Horner step ``c + p·w`` rounds once, as XLA's FMA does.
    """
    x = x.to(torch.float32)
    w = -log1p(x * -x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, torch.where(small, a, b))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(math.sqrt(2.0)))


def normal(key, shape, *, device) -> torch.Tensor:
    """float32 standard normals, as ``jax.random.normal`` draws them."""
    return bits_to_normal(random_bits(key, shape, device=device))


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """The normals of :func:`normal` from its :func:`random_bits`."""
    return erf_inv(bits_to_uniform(bits, _NORMAL_LO, 1.0)) * _SQRT2
