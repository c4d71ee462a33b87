"""The work a window's requests need, counted from their inputs, and the chip's peaks.

The arithmetic of ``chip_smoke.py``'s kernel bounds: each input byte read
once and each output byte written once, operations by the item's own
formula, and the least time at the published peaks the larger of the two
terms.  Work is counted from what the requests need (lanes refilled, k,
the groups' rows, the lanes that iterate, the lane-steps they take, the
forest's trees and depth), never from what a kernel happens to launch, so
a change that fuses or drops a kernel leaves the count as it is.
"""
from __future__ import annotations

__all__ = ["F32_OPS_PER_S", "HBM_BYTES_PER_S", "bound_s", "counted_work", "prefix_work",
           "sampling_work", "tree_rows", "tree_work"]

#: Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    """Least seconds for the work: bytes at HBM rate or float32 operations at
    peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def tree_work(rows: int, k: int, trees: int, depth: int) -> tuple[float, float]:
    """``(bytes, ops)`` of a forest on ``rows`` rows of ``k`` float32
    features: the rows read, one output written; a compare and a select a
    node visit, ``depth`` visits and one add a tree."""
    return rows * (k * 4 + 4), rows * trees * (2 * depth + 1)


def prefix_work(values: int) -> tuple[float, float]:
    """``(bytes, ops)`` of the prefix power-sum tables over ``values`` rows
    of features: each value read, four float32 sums written; four powers and
    four compensated sums a value."""
    return values * 4 + values * 16, values * 8


def sampling_work(rows: int, k: int) -> tuple[float, float]:
    """``(bytes, ops)`` of drawing ``rows`` feature rows ``value + σ·z``: the
    rows written, one multiply-add a feature."""
    return rows * k * 4, rows * k * 2


def tree_rows(counts: dict, k: int, m: int, m_sobol: int) -> int:
    """Forest rows the requests needed: the ``m + 1`` AMI rows of every z⁰
    evaluation, the Saltelli block of ``(k + 2)·m_sobol`` rows of every
    request that iterates, and both for every lane-step."""
    saltelli = (k + 2) * m_sobol
    return (counts["refills"] * (m + 1) + counts["iterating"] * saltelli
            + counts["lane_steps"] * (m + 1 + saltelli))


def counted_work(counts: dict, config: dict) -> dict[str, tuple[float, float]]:
    """``{item: (bytes, ops)}`` of a count of refills, iterating requests,
    lane-steps and table rows (:class:`spans.Probe`'s ``work``)."""
    b, mdl = config["biathlon"], config["model"]
    k = len(config["aggs"])
    rows = tree_rows(counts, k, int(b["m"]), int(b["m_sobol"]))
    return {
        "tree": tree_work(rows, k, int(mdl["n_trees"]), int(mdl["max_depth"])),
        "prefix": prefix_work(counts["table_rows"] * k),
        "sampling": sampling_work(rows, k),
    }
