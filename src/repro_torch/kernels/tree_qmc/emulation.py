"""The ``ensemble_sum`` kernel's shared-memory decomposition, in PyTorch.

The kernel's smem path (``csrc/tree_qmc.cu``, ``smem_kernel``) cuts the
trees into groups of ``group`` consecutive trees, one block of a cluster
each.  A block walks its group's trees for every row of a tile from its own
copy of the group's tables and keeps the leaf values; then each row's
leaves of all groups are read back, group by group and tree by tree, and
added to a sum that starts at zero.  :func:`grouped_ensemble_sum` does the
same with plain gathers: the walk of a group sees only that group's tables,
and the fold visits the groups in cluster-rank order.  The order of the
sum is the tree order, so the result is ``ensemble_predict_sum``'s bit for
bit whatever the grouping, which the CPU tests check for the groupings the
kernel's planner picks and for groups that do not divide the trees.
"""
from __future__ import annotations

import torch

__all__ = ["grouped_ensemble_sum"]


def _group_leaves(feature, threshold, left, right, value, x, depth: int) -> torch.Tensor:
    """(G, n) leaf values of the group's trees, from the group's tables alone."""
    n = x.shape[0]
    feature, left, right = feature.long(), left.long(), right.long()
    idx = torch.zeros((feature.shape[0], n), dtype=torch.int64, device=x.device)
    rows = torch.arange(n, device=x.device)[None, :]
    for _ in range(depth):
        go_left = x[rows, torch.gather(feature, 1, idx)] <= torch.gather(threshold, 1, idx)
        idx = torch.where(go_left, torch.gather(left, 1, idx), torch.gather(right, 1, idx))
    return torch.gather(value, 1, idx)


def grouped_ensemble_sum(ens, x: torch.Tensor, *, group: int) -> torch.Tensor:
    """(n,) sums of an ensemble (``TreeEnsemble``) over x (n, F), its trees
    walked in groups of ``group`` and their leaves folded in tree order."""
    if group < 1:
        raise ValueError(f"group must be positive, got {group}")
    tables = (ens.feature, ens.threshold, ens.left, ens.right, ens.value)
    leaves = [_group_leaves(*(t[t0:t0 + group] for t in tables), x, ens.depth)
              for t0 in range(0, ens.n_trees, group)]
    acc = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    for group_leaves in leaves:            # cluster rank order
        for leaf in group_leaves:          # tree order inside the group
            acc = acc + leaf
    return acc
