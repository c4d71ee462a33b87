"""Quasi-Monte-Carlo primitives: Sobol points and the inverse normal CDF.

Port of ``repro/core/qmc.py``.  PyTorch's unsigned 32-bit support is thin,
so Sobol points are int64 tensors holding the uint32 values (every
intermediate masked to 32 bits); they are bit-exact with the reference's
``sobol_uint32`` (and so with ``scipy.stats.qmc.Sobol(scramble=False)``).
On a CUDA device the grid comes from the ``sobol_points`` kernel
(``kernels/sobol``); :func:`sobol_uint32` here is its plain version.

:func:`digital_shift` XORs a threefry draw into the points (the
randomized QMC of the host-loop executor).  :func:`uniform_to_normal` is
the reference's float32 ``ndtri`` (the Cephes
piece-wise rational approximation JAX implements), written out so that the
port and the reference agree bit for bit on the QMC grid wherever both
backends round the same way: XLA's float32 ``log`` is not correctly
rounded, so about one point in a hundred still differs in its last bit.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.sobol_tables import BITS, DIRECTION_NUMBERS, MAX_DIM
from repro_torch.numerics import fma

__all__ = ["digital_shift", "direction_numbers", "sobol_uint32", "ndtri", "uniform_to_normal"]

_MASK32 = 0xFFFFFFFF


def direction_numbers(dim: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(dim, 32) int64 direction numbers (uint32 values) on ``device``.

    Copied to each device once and shared; callers must not write to it.
    """
    if dim > MAX_DIM:
        raise ValueError(
            f"sobol_uint32 supports up to {MAX_DIM} dimensions, got {dim}"
        )
    return _direction_table(torch.device(device))[:dim]


@functools.cache
def _direction_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(DIRECTION_NUMBERS.astype(np.int64)).to(device)


def sobol_uint32(
    n: int, dim: int, skip: int = 0, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """(n, dim) int64 Sobol points (uint32 values), gray-code construction.

    Point ``i`` is the XOR over set bits ``b`` of ``gray(i) = i ^ (i >> 1)``
    of the direction numbers ``v[:, b]``.
    """
    sv = direction_numbers(dim, device)
    idx = torch.arange(skip, skip + n, dtype=torch.int64, device=device) & _MASK32
    gray = idx ^ (idx >> 1)
    out = torch.zeros((n, dim), dtype=torch.int64, device=device)
    for b in range(BITS):
        bit = ((gray >> b) & 1).bool()
        out = torch.where(bit[:, None], out ^ sv[None, :, b], out)
    return out


def digital_shift(key, points: torch.Tensor) -> torch.Tensor:
    """Random digital (XOR) shift of raw Sobol points (int64 holding uint32).

    The shift is ``jax.random.bits(key, (dim,), uint32)``, hashed on the
    host (:func:`threefry.host_bits`, a few hundred numpy operations on d
    values) and copied to the points' device as one (d,) tensor; XOR keeps
    every value within 32 bits.
    """
    shift = torch.from_numpy(threefry.host_bits(key, (points.shape[-1],))).to(points.device)
    return points ^ shift[None, :]


def _polyval(coeffs, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation, highest power first (``jnp.polyval`` order)."""
    y = torch.zeros_like(x)
    for c in coeffs:
        y = fma(y, x, c)
    return y


def _f32(xs):
    return [float(np.float32(c)) for c in xs]


# Cephes ndtri coefficients, rounded to float32 as the reference rounds them.
_P0 = _f32([-5.99633501014107895267E1, 9.80010754185999661536E1,
            -5.66762857469070293439E1, 1.39312609387279679503E1,
            -1.23916583867381258016E0])
_Q0 = _f32([1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
            8.63602421390890590575E1, -2.25462687854119370527E2,
            2.00260212380060660359E2, -8.20372256168333339912E1,
            1.59056225126211695515E1, -1.18331621121330003142E0])
_P1 = _f32([4.05544892305962419923E0, 3.15251094599893866154E1,
            5.71628192246421288162E1, 4.40805073893200834700E1,
            1.46849561928858024014E1, 2.18663306850790267539E0,
            -1.40256079171354495875E-1, -3.50424626827848203418E-2,
            -8.57456785154685413611E-4])
_Q1 = _f32([1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
            4.13172038254672030440E1, 1.50425385692907503408E1,
            2.50464946208309415979E0, -1.42182922854787788574E-1,
            -3.80806407691578277194E-2, -9.33259480895457427372E-4])
_P2 = _f32([3.23774891776946035970E0, 6.91522889068984211695E0,
            3.93881025292474443415E0, 1.33303460815807542389E0,
            2.01485389549179081538E-1, 1.23716634817820021358E-2,
            3.01581553508235416007E-4, 2.65806974686737550832E-6,
            6.23974539184983293730E-9])
_Q2 = _f32([1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
            1.37702099489081330271E0, 2.16236993594496635890E-1,
            1.34204006088543189037E-2, 3.28014464682127739104E-4,
            2.89247864745380683936E-6, 6.79019408009981274425E-9])
_EXP_M2 = float(np.float32(math.exp(-2.0)))
_ONE_M_EXP_M2 = float(np.float32(-math.expm1(-2.0)))
_SQRT_2PI = float(np.float32(math.sqrt(2.0 * math.pi)))


def _log(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``log`` rounded once from float64, so correctly rounded.

    PyTorch's CPU float32 ``log`` runs through the math library in chunks
    across worker threads, and its accuracy is not pinned there: in a
    process that also runs XLA, whole chunks came back ~1e-4 off.  A
    float64 log rounded to float32 does not depend on that path.
    """
    return torch.log(x.to(torch.float64)).to(torch.float32)


def ndtri(p: torch.Tensor) -> torch.Tensor:
    """Float32 inverse of the standard normal CDF (Cephes, as in JAX)."""
    p = p.to(torch.float32)
    mcp = torch.where(p > _ONE_M_EXP_M2, 1.0 - p, p)
    mcp = torch.where(mcp == 0.0, torch.full_like(mcp, 0.5), mcp)
    w = mcp - 0.5
    ww = w * w
    x_big = w + w * ww * (_polyval(_P0, ww) / _polyval(_Q0, ww))
    x_big = x_big * -_SQRT_2PI
    z = torch.sqrt(-2.0 * _log(mcp).to(torch.float64)).to(torch.float32)
    first = z - _log(z) / z
    rz = 1.0 / z
    x_small = first - _polyval(_P2, rz) / _polyval(_Q2, rz) / z
    x_other = first - _polyval(_P1, rz) / _polyval(_Q1, rz) / z
    x = torch.where(mcp > _EXP_M2, x_big, torch.where(z >= 8.0, x_small, x_other))
    x = torch.where(p > _ONE_M_EXP_M2, x, -x)
    inf = torch.full_like(x, math.inf)
    return torch.where(p == 0.0, -inf, torch.where(p == 1.0, inf, x))


def uniform_to_normal(u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF transform of uniforms in (0, 1) to standard normals."""
    eps = np.float32(1e-7)
    return ndtri(torch.clamp(u.to(torch.float32), float(eps), float(1 - eps)))
