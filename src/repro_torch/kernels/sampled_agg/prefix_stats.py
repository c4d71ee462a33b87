"""Per-request prefix statistics: the incremental-AFC precompute.

Port of the parametric half of ``repro/kernels/sampled_agg/prefix_stats.py``.
:func:`prefix_power_sums` wraps the CUDA kernel (``csrc/prefix_stats.cu``)
that builds the inclusive running power sums
``P_p[j, c] = Σ_{i ≤ c} (v_{j,i} − shift_j)^p`` for p = 1..4;
:func:`prefix_power_sums_ref` is its plain version (a compensated scan).
The AFC (value, σ) at any plan z is then one gather of the table row at
``z − 1`` (:func:`prefix_moments_at`) fed through
``aggregates.estimates_from_power_sums``.  The holistic rank index is a
later slice of the port.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sampled_agg.compensated import comp_cumsum

__all__ = [
    "N_POWERS",
    "prefix_moments_at",
    "prefix_power_sums",
    "prefix_power_sums_ref",
]

N_POWERS = 4  # [Σu, Σu², Σu³, Σu⁴] — the count at z is z
NAME = "prefix_power_sums"


def _powers(v: torch.Tensor) -> torch.Tensor:
    """(..., c) -> (..., c, 4) stacked u, u², u³, u⁴."""
    v2 = v * v
    return torch.stack([v, v2, v2 * v, v2 * v2], dim=-1)


def prefix_power_sums_ref(
    vals: torch.Tensor, shift: torch.Tensor | None = None
) -> torch.Tensor:
    """(k, cap) f32 -> (k, cap, 4) inclusive prefix sums of (v − shift)^p."""
    v = vals.to(torch.float32)
    if shift is not None:
        v = v - shift.to(torch.float32)[:, None]
    return comp_cumsum(_powers(v), dim=1)


@functools.cache
def _fn():
    fn = build.library("prefix_stats").prefix_power_sums_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def prefix_power_sums(
    vals: torch.Tensor, shift: torch.Tensor | None = None
) -> torch.Tensor:
    """The CUDA kernel: (k, cap) f32 on the card -> (k, cap, 4) f32 tables."""
    build.check_tensor(vals, "prefix_power_sums vals", torch.float32, 2)
    k, cap = vals.shape
    if shift is None:
        shift = torch.zeros((k,), dtype=torch.float32, device=vals.device)
    shift = shift.to(torch.float32).contiguous()
    build.check_tensor(shift, "prefix_power_sums shift", torch.float32, 1)
    if shift.shape[0] != k:
        raise ValueError(f"prefix_power_sums: shift must have {k} rows")
    out = torch.empty((k, cap, N_POWERS), dtype=torch.float32, device=vals.device)
    if k == 0 or cap == 0:
        return out
    device, stream = build.stream_of(vals)
    err = _fn()(vals.data_ptr(), shift.data_ptr(), out.data_ptr(), k, cap, device, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return out


def prefix_moments_at(ptab: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gather the (k, 5) ``[count, s1..s4]`` row at plan z (z == 0 -> zeros)."""
    cap = ptab.shape[1]
    idx = torch.clamp(z - 1, 0, cap - 1).to(torch.int64)
    row = torch.gather(ptab, 1, idx[:, None, None].expand(-1, 1, N_POWERS))[:, 0]
    row = torch.where(z[:, None] > 0, row, torch.zeros_like(row))
    return torch.cat([z.to(torch.float32)[:, None], row], dim=1)
