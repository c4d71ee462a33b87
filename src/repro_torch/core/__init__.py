"""Biathlon core stages in PyTorch: QMC, uncertainty, planner, fused executor.

Exports the QMC grids as the reference's ``repro/core/__init__.py`` does.
"""
from repro_torch.core.qmc import (
    discrepancy_proxy,
    normal_qmc_samples,
    sobol_sequence,
    sobol_uint32,
)

__all__ = ["discrepancy_proxy", "normal_qmc_samples", "sobol_sequence", "sobol_uint32"]
