"""Wrapper of the CUDA ``sobol_points`` kernel (``csrc/sobol.cu``).

Replaces ``repro/kernels/sobol/sobol.py::sobol_points``, for any ``m`` (no
``m % block_m`` restriction).  The plain version is
``core/qmc.sobol_uint32`` (int64 tensors holding uint32 values); the runs
path's order of work is ``emulation.run_walk_points``.

:func:`plan` picks the run length: each thread makes ``run`` consecutive
points of one dimension, the first by the direct construction and the rest
by the gray-code recurrence, ``256 // dim`` runs a block.  ``run=0`` takes
the direct path (the earlier design, one thread an element, int64
holders), which ``chip_smoke.py`` and ``kernel_ab.py`` time beside it.
Each launch's path is counted in ``build.PATHS`` as ``sobol_points.runs``
or ``sobol_points.direct``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.qmc import direction_numbers
from repro_torch.core.sobol_tables import DIRECTION_NUMBERS, MAX_DIM
from repro_torch.kernels import build

__all__ = ["MAX_RUN", "THREADS", "bind", "launch_with", "plan", "sobol_points"]

NAME = "sobol_points"
THREADS = 256       # threads a block
MAX_RUN = 32        # points a thread, so that a block's tile fits 32 KB
N_SM = 132          # SMs of an H100 SXM, the planning default


def bind(lib: ctypes.CDLL):
    """The typed entry points ``(runs, direct)`` of a loaded library."""
    runs = lib.sobol_points_launch
    runs.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    runs.restype = ctypes.c_int
    direct = lib.sobol_points_direct_launch
    direct.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    direct.restype = ctypes.c_int
    return runs, direct


@functools.cache
def _fn():
    return bind(build.library("sobol"))


@functools.cache
def _directions32(device: torch.device) -> torch.Tensor:
    """(64, 32) direction numbers as int32 tensors holding their uint32 bits."""
    return torch.from_numpy(DIRECTION_NUMBERS.view(np.int32).copy()).to(device)


def plan(m: int, dim: int, n_sm: int = N_SM) -> int:
    """Points a thread: enough that the ``256 // dim`` runs of a block cover
    ``m`` rows in about one block an SM, at most :data:`MAX_RUN`."""
    runs = THREADS // dim
    return max(1, min(MAX_RUN, -(-m // (runs * n_sm))))


def sobol_points(m: int, dim: int, skip: int = 0, *, device, uniforms: bool = False,
                 run: int | None = None) -> torch.Tensor:
    """(m, dim) Sobol points computed on the card.

    The runs path returns an int32 tensor holding the points' uint32 bits,
    or with ``uniforms=True`` the float32 QMC uniforms ``(x + 0.5)·2⁻³²``.
    ``run`` overrides :func:`plan` (1..32); ``run=0`` takes the direct path
    (the earlier design), which returns int64 points only.
    """
    return launch_with(_fn, m, dim, skip, device=device, uniforms=uniforms, run=run)


def launch_with(entry, m: int, dim: int, skip: int = 0, *, device, uniforms: bool = False,
                run: int | None = None) -> torch.Tensor:
    """:func:`sobol_points` through the entry points that ``entry()`` gives
    (see :func:`bind`), asked for once the arguments have passed their checks."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"sobol_points: expected a CUDA device, got {device}")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"sobol_points supports 1 to {MAX_DIM} dimensions, got {dim}")
    if run is None:
        run = plan(m, dim)
    if not 0 <= run <= MAX_RUN:
        raise ValueError(f"sobol_points: run must be 0..{MAX_RUN}, got {run}")
    if run == 0:
        if uniforms:
            raise ValueError("sobol_points: the direct path writes points only")
        out = torch.empty((m, dim), dtype=torch.int64, device=device)
    else:
        out = torch.empty((m, dim), dtype=torch.float32 if uniforms else torch.int32,
                          device=device)
    if m == 0:
        return out
    dev, stream = build.stream_of(out)
    if run == 0:
        sv = direction_numbers(dim, device)
        err = entry()[1](sv.data_ptr(), out.data_ptr(), m, dim, skip, dev, stream)
    else:
        sv = _directions32(device)
        bits, unif = (None, out.data_ptr()) if uniforms else (out.data_ptr(), None)
        err = entry()[0](sv.data_ptr(), bits, unif, m, dim, skip & 0xFFFFFFFF, run, dev,
                         stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    build.PATHS[f"{NAME}.{'runs' if run else 'direct'}"] += 1
    return out
