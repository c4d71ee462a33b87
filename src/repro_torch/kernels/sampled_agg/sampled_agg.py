"""Wrapper of the CUDA ``sampled_moments`` kernel (``csrc/sampled_agg.cu``).

Replaces ``repro/kernels/sampled_agg/sampled_agg.py::sampled_moments``.
Takes any ``(k, cap)``: no block-multiple shapes and no padding visible to
the caller.  The plain version is ``ref.sampled_moments_ref``; the kernel's
summation order is ``emulation.clustered_sampled_moments``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["MAX_BLOCKS", "THREADS", "chunk_cols", "moment_blocks", "sampled_moments"]

NAME = "sampled_moments"
THREADS = 256       # threads a block of the cluster kernel
MAX_BLOCKS = 8      # blocks a row: the portable cluster size


def bind(lib: ctypes.CDLL):
    """The typed entry point ``sampled_moments_launch`` of a loaded library."""
    fn = lib.sampled_moments_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return bind(build.library("sampled_agg"))


def moment_blocks(cap: int) -> int:
    """Blocks a row of the cluster kernel: one for every 4096 columns (16
    a thread), at most 8."""
    return min(MAX_BLOCKS, max(1, -(-cap // (16 * THREADS))))


def chunk_cols(cap: int, blocks: int) -> int:
    """Columns of each block's chunk when ``blocks`` cover a row: a multiple
    of 32, so that each warp's loads start on a 128-byte line of the row."""
    return max(32, -(-cap // (32 * blocks)) * 32)


def sampled_moments(
    vals: torch.Tensor, z: torch.Tensor, shift: torch.Tensor | None = None, *,
    blocks: int | None = None,
) -> torch.Tensor:
    """(k, 5) ``[count, Σu, Σu², Σu³, Σu⁴]`` over each z-prefix, on the card.

    ``blocks`` overrides :func:`moment_blocks` (1..8 blocks a row); 0 takes
    the rows kernel (the earlier design), which the card tests and
    ``chip_smoke.py`` hold and time beside the cluster kernel.  Each launch's
    path is counted in ``build.PATHS`` as ``sampled_moments.cluster`` or
    ``sampled_moments.rows``.
    """
    return launch_with(_fn, vals, z, shift, blocks=blocks)


def launch_with(entry, vals: torch.Tensor, z: torch.Tensor,
                shift: torch.Tensor | None = None, *, blocks: int | None = None) -> torch.Tensor:
    """:func:`sampled_moments` through the entry point that ``entry()`` gives
    (see :func:`bind`), asked for once the inputs have passed their checks."""
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
    if blocks is None:
        blocks = moment_blocks(cap)
    if not 0 <= blocks <= MAX_BLOCKS:
        raise ValueError(f"sampled_moments: blocks must be 0..{MAX_BLOCKS}, got {blocks}")
    out = torch.empty((k, 5), dtype=torch.float32, device=vals.device)
    if k == 0:
        return out
    if cap == 0:
        return out.zero_()
    device, stream = build.stream_of(vals)
    chunk = chunk_cols(cap, blocks) if blocks else 0
    err = entry()(vals.data_ptr(), z.data_ptr(), shift.data_ptr(), out.data_ptr(),
                  k, cap, blocks, chunk, device, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    build.PATHS[f"{NAME}.{'cluster' if blocks else 'rows'}"] += 1
    return out
