"""Biathlon configuration (paper §4 defaults).

Port of ``repro/core/executor.py::BiathlonConfig``, the knobs the fused
executor reads.  The host-loop executor and its options are a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["BiathlonConfig"]


@dataclass(frozen=True)
class BiathlonConfig:
    """Default configuration = the paper's §4 defaults."""

    alpha: float = 0.05        # initial sampling ratio
    gamma: float = 0.01        # step size as fraction of Σ N_j
    tau: float = 0.95          # confidence level
    delta: float | None = None  # error bound; None -> pipeline.delta_default
    m: int = 1000              # QMC samples for AMI
    m_sobol: int = 256         # QMC base samples for Saltelli indices
    max_iters: int = 64        # safety cap (the loop terminates at z = N anyway)
    n_bootstrap: int = 256     # bootstrap replicates B for MEDIAN/QUANTILE features
