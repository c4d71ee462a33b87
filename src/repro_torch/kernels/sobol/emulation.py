"""The ``sobol_points`` runs path's order of work, in PyTorch.

The kernel's runs path (``csrc/sobol.cu``, ``sobol_runs_kernel``) cuts the
rows into runs of ``run`` consecutive points; a thread makes one dimension
of one run, the first point by the direct construction (the XOR of the
direction numbers at the set bits of ``gray(skip + row)``) and each later
one from the point before by the gray-code recurrence ``x(i) = x(i−1) ^
v[ctz(i)]``, with ``ctz(0)`` read as 31 where the index wraps mod 2³².
:func:`run_walk_points` does the same with whole-tensor operations, so the
CPU tests can hold the recurrence to ``core/qmc.sobol_uint32`` (the direct
construction at every point) without a card.
"""
from __future__ import annotations

import torch

from repro_torch.core.qmc import direction_numbers

__all__ = ["run_walk_points"]

_MASK32 = 0xFFFFFFFF


def _direct(idx: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """(n, dim) points at the uint32 indices ``idx`` (int64 holders)."""
    gray = idx ^ (idx >> 1)
    out = torch.zeros((idx.shape[0], sv.shape[0]), dtype=torch.int64, device=idx.device)
    for b in range(32):
        out = torch.where(((gray >> b) & 1).bool()[:, None], out ^ sv[None, :, b], out)
    return out


def _ctz_or_31(idx: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of each uint32 index, 31 for index 0."""
    low = idx & -idx
    bit = torch.log2(low.clamp(min=1).to(torch.float64)).round().to(torch.int64)
    return torch.where(idx == 0, torch.full_like(bit, 31), bit)


def run_walk_points(m: int, dim: int, skip: int = 0, *, run: int,
                    device="cpu") -> torch.Tensor:
    """(m, dim) int64 Sobol points (uint32 values) made run by run as the
    kernel's runs path makes them: the direct construction at each run's
    first row, one XOR a point after it."""
    sv = direction_numbers(dim, device)
    starts = torch.arange(0, m, run, dtype=torch.int64, device=device)
    idx = (starts + skip) & _MASK32
    x = _direct(idx, sv)                                    # (runs, dim)
    cols = torch.arange(dim, device=device)[None, :]
    out = torch.empty((starts.shape[0], run, dim), dtype=torch.int64, device=device)
    out[:, 0] = x
    for i in range(1, run):
        idx = (idx + 1) & _MASK32
        x = x ^ sv[cols, _ctz_or_31(idx)[:, None]]
        out[:, i] = x
    return out.reshape(-1, dim)[:m]
