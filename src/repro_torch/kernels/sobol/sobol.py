"""Wrapper of the CUDA ``sobol_points`` kernel (``csrc/sobol.cu``).

Replaces ``repro/kernels/sobol/sobol.py::sobol_points``, for any ``m`` (no
``m % block_m`` restriction).  The plain version is
``core/qmc.sobol_uint32``; both return int64 tensors holding uint32 values.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.qmc import direction_numbers
from repro_torch.kernels import build

__all__ = ["sobol_points"]

NAME = "sobol_points"


@functools.cache
def _fn():
    fn = build.library("sobol").sobol_points_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sobol_points(m: int, dim: int, skip: int = 0, *, device) -> torch.Tensor:
    """(m, dim) int64 Sobol points (uint32 values) computed on the card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"sobol_points: expected a CUDA device, got {device}")
    sv = direction_numbers(dim, device)
    out = torch.empty((m, dim), dtype=torch.int64, device=device)
    if m * dim == 0:
        return out
    dev, stream = build.stream_of(out)
    err = _fn()(sv.data_ptr(), out.data_ptr(), m, dim, skip, dev, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return out
