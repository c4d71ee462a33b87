"""Plain PyTorch version of the ``ensemble_sum`` kernel.

The tensorized level-wise traversal of ``repro/models/tabular/trees.py``
(``ensemble_predict_sum``), vectorized over trees, with the per-row sum
taken in tree order 0..T-1 as the kernel takes it.
"""
from __future__ import annotations

import torch

__all__ = ["ensemble_predict_sum"]


def ensemble_predict_sum(ens, x: torch.Tensor) -> torch.Tensor:
    """Sum of per-tree leaf values; x (n, F) -> (n,)."""
    n = x.shape[0]
    feature, left, right = ens.feature.long(), ens.left.long(), ens.right.long()
    idx = torch.zeros((feature.shape[0], n), dtype=torch.int64, device=x.device)
    rows = torch.arange(n, device=x.device)[None, :]
    for _ in range(ens.depth):
        f = torch.gather(feature, 1, idx)
        go_left = x[rows, f] <= torch.gather(ens.threshold, 1, idx)
        idx = torch.where(go_left, torch.gather(left, 1, idx), torch.gather(right, 1, idx))
    leaves = torch.gather(ens.value, 1, idx)            # (T, n)
    acc = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for t in range(leaves.shape[0]):
        acc = acc + leaves[t]
    return acc
