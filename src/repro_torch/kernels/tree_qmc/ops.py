"""Ensemble prediction for QMC megabatches, routed by device.

A CUDA tensor goes to the ``ensemble_sum`` kernel, a CPU tensor to the
plain ``ensemble_predict_sum``; both add the trees in the same fixed order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tree_qmc.ref import ensemble_predict_sum
from repro_torch.kernels.tree_qmc.tree_qmc import ensemble_sum

__all__ = ["predict_sum"]


def predict_sum(ens, x: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """(m, F) -> (m,) sum of leaf values across the ensemble."""
    x = x.to(torch.float32).contiguous()
    if use_kernel and x.is_cuda:
        return ensemble_sum(ens.feature, ens.threshold, ens.left, ens.right,
                            ens.value, x, depth=ens.depth)
    return ensemble_predict_sum(ens, x)
