"""Wrapper of the CUDA ``masked_select_ranks`` kernel (``csrc/quantile_select.cu``).

Replaces ``repro/kernels/sampled_agg/quantile_select.py::masked_select_ranks``:
the order statistics of each z-prefix at given target ranks, for the
holistic (MEDIAN/QUANTILE) rescan AFC.  Takes any ``(h, cap)`` and any
number of targets: no block multiples, no padding visible to the caller.
The plain version is ``ref.masked_select_ranks_ref``; the two are bitwise
equal, since the kernel selects values and computes none.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["masked_select_ranks"]

NAME = "masked_select_ranks"


@functools.cache
def _fn():
    fn = build.library("quantile_select").masked_select_ranks_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def masked_select_ranks(
    vals: torch.Tensor, z: torch.Tensor, targets: torch.Tensor
) -> torch.Tensor:
    """(h, R) f32: the ``targets``-th smallest of each z-prefix, on the card.

    Ties order by column; a target clipped to ``[0, cap − 1]`` that lies at
    or past z selects +inf.  The wrapper allocates the ``(h, cap)`` scratch
    row of the kernel's counting sort.
    """
    build.check_tensor(vals, "masked_select_ranks vals", torch.float32, 2)
    h, cap = vals.shape
    z = z.to(torch.int32).contiguous()
    targets = targets.to(torch.int32).contiguous()
    build.check_tensor(z, "masked_select_ranks z", torch.int32, 1)
    build.check_tensor(targets, "masked_select_ranks targets", torch.int32, 2)
    if z.shape[0] != h or targets.shape[0] != h:
        raise ValueError(f"masked_select_ranks: z and targets must have {h} rows")
    r = targets.shape[1]
    if h == 0 or r == 0 or cap == 0:
        return torch.full((h, r), torch.inf, dtype=torch.float32, device=vals.device)
    scratch = torch.empty((h, cap), dtype=torch.float32, device=vals.device)
    out = torch.empty((h, r), dtype=torch.float32, device=vals.device)
    device, stream = build.stream_of(vals)
    err = _fn()(vals.data_ptr(), z.data_ptr(), targets.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), h, cap, r, device, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return out
