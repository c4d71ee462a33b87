"""Wrapper of the CUDA ``sampled_moments`` kernel (``csrc/sampled_agg.cu``).

Replaces ``repro/kernels/sampled_agg/sampled_agg.py::sampled_moments``.
Takes any ``(k, cap)``: no block-multiple shapes and no padding visible to
the caller.  The plain version is ``ref.sampled_moments_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["sampled_moments"]

NAME = "sampled_moments"


@functools.cache
def _fn():
    fn = build.library("sampled_agg").sampled_moments_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sampled_moments(
    vals: torch.Tensor, z: torch.Tensor, shift: torch.Tensor | None = None
) -> torch.Tensor:
    """(k, 5) ``[count, Σu, Σu², Σu³, Σu⁴]`` over each z-prefix, on the card."""
    build.check_tensor(vals, "sampled_moments vals", torch.float32, 2)
    k, cap = vals.shape
    if shift is None:
        shift = torch.zeros((k,), dtype=torch.float32, device=vals.device)
    z = z.to(torch.int32).contiguous()
    shift = shift.to(torch.float32).contiguous()
    build.check_tensor(z, "sampled_moments z", torch.int32, 1)
    build.check_tensor(shift, "sampled_moments shift", torch.float32, 1)
    if z.shape[0] != k or shift.shape[0] != k:
        raise ValueError(f"sampled_moments: z/shift must have {k} rows")
    out = torch.empty((k, 5), dtype=torch.float32, device=vals.device)
    if k == 0:
        return out
    if cap == 0:
        return out.zero_()
    device, stream = build.stream_of(vals)
    err = _fn()(vals.data_ptr(), z.data_ptr(), shift.data_ptr(), out.data_ptr(),
                k, cap, device, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return out
