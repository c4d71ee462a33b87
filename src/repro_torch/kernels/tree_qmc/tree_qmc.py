"""Wrapper of the CUDA ``ensemble_sum`` kernel (``csrc/tree_qmc.cu``).

Replaces ``repro/kernels/tree_qmc/tree_qmc.py::ensemble_sum`` for any row
and tree count (no block-multiple asserts, no padding visible to callers).
The plain version is ``models/tabular/trees.ensemble_predict_sum``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["ensemble_sum"]

NAME = "ensemble_sum"


@functools.cache
def _fn():
    fn = build.library("tree_qmc").ensemble_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ensemble_sum(
    feature: torch.Tensor,    # (T, M) int32
    threshold: torch.Tensor,  # (T, M) f32
    left: torch.Tensor,       # (T, M) int32
    right: torch.Tensor,      # (T, M) int32
    value: torch.Tensor,      # (T, M) f32
    x: torch.Tensor,          # (m, F) f32
    *,
    depth: int,
) -> torch.Tensor:
    """(m,) sum of per-tree leaf values, trees added in order 0..T-1."""
    for t, what, dtype in (
        (feature, "feature", torch.int32), (threshold, "threshold", torch.float32),
        (left, "left", torch.int32), (right, "right", torch.int32),
        (value, "value", torch.float32),
    ):
        build.check_tensor(t, f"ensemble_sum {what}", dtype, 2)
        if t.shape != feature.shape:
            raise ValueError(f"ensemble_sum: {what} has shape {tuple(t.shape)}, "
                             f"feature {tuple(feature.shape)}")
    build.check_tensor(x, "ensemble_sum x", torch.float32, 2)
    n_trees, n_nodes = feature.shape
    m, n_feat = x.shape
    out = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    device, stream = build.stream_of(x)
    err = _fn()(feature.data_ptr(), threshold.data_ptr(), left.data_ptr(),
                right.data_ptr(), value.data_ptr(), x.data_ptr(), out.data_ptr(),
                m, n_trees, n_nodes, n_feat, depth, device, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    return out
