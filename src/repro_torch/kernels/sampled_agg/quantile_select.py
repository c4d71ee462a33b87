"""Wrapper of the CUDA ``masked_select_ranks`` kernel (``csrc/quantile_select.cu``).

Replaces ``repro/kernels/sampled_agg/quantile_select.py::masked_select_ranks``:
the order statistics of each z-prefix at given target ranks, for the
holistic (MEDIAN/QUANTILE) rescan AFC.  Takes any ``(h, cap)`` and any
number of targets: no block multiples, no padding visible to the caller.
The plain version is ``ref.masked_select_ranks_ref``; the two are bitwise
equal, since the kernel selects values and computes none.  The radix
path (which ranks a prefix of at most 352 values by counting instead of
its four passes) is emulated by ``emulation.radix_select_ranks``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

__all__ = ["ITEMS", "MAX_CLUSTER", "Plan", "RADIX_THREADS", "candidates", "masked_select_ranks",
           "plan"]

NAME = "masked_select_ranks"
RADIX_THREADS = 1024            # threads a block of the radix kernel
ITEMS = (1, 2, 4, 8)            # elements a thread: chunks of 1024·items columns
MAX_CLUSTER = 8                 # blocks a row: the portable cluster size


class Plan(NamedTuple):
    """A launch: ``items`` elements a thread and ``blocks`` blocks (one
    cluster) a row on the radix path; ``items = 0`` is the rank path."""

    items: int
    blocks: int


def candidates(cap: int) -> list[Plan]:
    """Every radix plan that covers a row of ``cap`` columns."""
    out = []
    for items in ITEMS:
        blocks = max(1, -(-cap // (RADIX_THREADS * items)))
        if blocks <= MAX_CLUSTER:
            out.append(Plan(items, blocks))
    return out


def plan(cap: int) -> Plan:
    """The launch for rows of ``cap`` columns, from the cap alone (z stays
    on the card): the fewest elements a thread whose chunks a cluster of 8
    covers, so that a warp's chain of ranks is short and a long row spreads
    over 8 SMs.  Past 65536 columns no cluster covers a row, and the rank
    path (h·z² compares) takes it."""
    c = candidates(cap)
    return c[0] if c else Plan(0, 0)


def bind(lib: ctypes.CDLL):
    """The typed entry point ``masked_select_ranks_launch`` of a loaded library."""
    fn = lib.masked_select_ranks_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return bind(build.library("quantile_select"))


def masked_select_ranks(
    vals: torch.Tensor, z: torch.Tensor, targets: torch.Tensor, *, launch: Plan | None = None
) -> torch.Tensor:
    """(h, R) f32: the ``targets``-th smallest of each z-prefix, on the card.

    Ties order by column; a target clipped to ``[0, cap − 1]`` that lies at
    or past z selects +inf.  ``launch`` overrides :func:`plan`;
    ``Plan(0, 0)`` takes the rank path (the earlier design), which the card
    tests and ``chip_smoke.py`` hold and time beside the radix path.  Each
    launch's path is counted in ``build.PATHS`` as
    ``masked_select_ranks.radix`` or ``masked_select_ranks.rank``.
    """
    return launch_with(_fn, vals, z, targets, launch=launch)


def launch_with(entry, vals: torch.Tensor, z: torch.Tensor, targets: torch.Tensor, *,
                launch: Plan | None = None) -> torch.Tensor:
    """:func:`masked_select_ranks` through the entry point that ``entry()``
    gives (see :func:`bind`), asked for once the inputs have passed their
    checks.  The wrapper allocates the rank path's ``(h, cap)`` scratch."""
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
    p = plan(cap) if launch is None else Plan(*launch)
    if p.items and (p.items not in ITEMS or not 1 <= p.blocks <= MAX_CLUSTER
                    or p.blocks * RADIX_THREADS * p.items < cap):
        raise ValueError(f"masked_select_ranks: {p} does not cover rows of {cap} columns")
    scratch = None if p.items else torch.empty((h, cap), dtype=torch.float32, device=vals.device)
    out = torch.empty((h, r), dtype=torch.float32, device=vals.device)
    device, stream = build.stream_of(vals)
    err = entry()(vals.data_ptr(), z.data_ptr(), targets.data_ptr(),
                  None if scratch is None else scratch.data_ptr(), out.data_ptr(),
                  h, cap, r, p.items, p.blocks, device, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    build.PATHS[f"{NAME}.{'radix' if p.items else 'rank'}"] += 1
    return out
