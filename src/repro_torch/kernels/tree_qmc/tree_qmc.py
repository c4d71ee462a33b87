"""Wrapper of the CUDA ``ensemble_sum`` kernel (``csrc/tree_qmc.cu``).

Replaces ``repro/kernels/tree_qmc/tree_qmc.py::ensemble_sum`` for any row
and tree count (no block-multiple asserts, no padding visible to callers).
The plain version is ``models/tabular/trees.ensemble_predict_sum``.

:func:`plan` picks the launch: the ``smem`` path (a cluster of up to 8
blocks per row tile, one tree group each, its tables in shared memory) for
every forest whose groups fit, else the ``global`` path (one thread a row,
the tables read through the cache).  Both add the leaves of a row in tree
order, so they give the same bits; each launch's path is counted in
``build.PATHS`` as ``ensemble_sum.smem`` or ``ensemble_sum.global``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

__all__ = ["Plan", "bind", "candidates", "ensemble_sum", "launch_with", "plan", "smem_bytes"]

NAME = "ensemble_sum"
MAX_CLUSTER = 8             # portable cluster size
SMEM_LIMIT = 232448         # bytes of shared memory one block may use (sm_90)
SM_SMEM = 233472            # bytes of shared memory an SM holds for blocks
ROW_TILES = (256, 128, 64, 32)   # divisors of the block's 256 threads
GROUP_BYTES = 96 * 1024     # a group's five tables, so that two blocks fit an SM
N_SM = 132                  # SMs of an H100 SXM, the planning default


class Plan(NamedTuple):
    """One launch: ``cluster`` = 0 for the global path, else the smem path's
    cluster size C (= tree groups), ``group`` trees a group, ``rows`` rows a
    tile, and ``clusters`` clusters looping over the tiles."""

    cluster: int
    group: int
    rows: int
    clusters: int

    @property
    def path(self) -> str:
        return "smem" if self.cluster else "global"


def smem_bytes(n_trees: int, n_nodes: int, n_feat: int, group: int, rows: int) -> int:
    """Shared memory of one smem-path block (``layout`` in ``csrc/tree_qmc.cu``):
    five node tables, the x tile, the leaves and, in a cluster, the fold buffer."""
    round4 = lambda w: (w + 3) // 4 * 4  # noqa: E731
    cluster = -(-n_trees // group)
    fold = -(-rows // cluster) * n_trees if cluster > 1 else 0
    return 16 + 4 * (5 * round4(group * n_nodes + 3) + round4(rows * n_feat + 3)
                     + rows * (group | 1) + fold)


def _clusters(m: int, rows: int, cluster: int, n_sm: int) -> int:
    """Clusters launched: one a row tile, at most about two blocks an SM
    (beyond that a cluster loops over tiles, its tables staged once)."""
    return min(-(-m // rows), max(1, 2 * n_sm // cluster))


def candidates(n_trees: int, n_nodes: int, n_feat: int, m: int,
               n_sm: int = N_SM) -> list[Plan]:
    """Every smem-path launch whose block fits shared memory: row tiles R of
    256 to 32, clusters of C <= 8 groups of G = ceil(T / C) trees."""
    out = []
    for rows in ROW_TILES:
        for cluster in range(1, min(MAX_CLUSTER, n_trees) + 1):
            group = -(-n_trees // cluster)
            if -(-n_trees // group) != cluster:
                continue  # the same groups as a smaller cluster
            if smem_bytes(n_trees, n_nodes, n_feat, group, rows) <= SMEM_LIMIT:
                out.append(Plan(cluster, group, rows, _clusters(m, rows, cluster, n_sm)))
    return out


@functools.lru_cache(maxsize=256)
def plan(n_trees: int, n_nodes: int, n_feat: int, m: int, n_sm: int = N_SM) -> Plan:
    """The launch for a (T, M) forest on (m, F) rows, on a card of ``n_sm`` SMs.

    A rule read off every plan timed at the served megabatches (PERF.md §6):
    the fewest groups whose five tables take at most 96 KB each
    (two blocks an SM; 200 KB if one tree needs more), since a cluster's
    barriers and gathers cost more than the staging they save; then the
    largest row tile that still gives about 0.6 blocks an SM.  The global
    path where no cluster of 8 fits, and where a cluster of several blocks
    would loop over three row tiles or more (there the global kernel,
    throughput-bound, is the faster).
    """
    per_tree = 20 * n_nodes
    fit = GROUP_BYTES // per_tree or SMEM_LIMIT * 7 // 8 // per_tree
    cluster = -(-n_trees // fit) if fit else MAX_CLUSTER + 1
    if cluster > MAX_CLUSTER:
        return Plan(0, 0, 0, 0)
    group = -(-n_trees // cluster)
    fits = [r for r in ROW_TILES if smem_bytes(n_trees, n_nodes, n_feat, group, r) <= SMEM_LIMIT]
    if not fits:
        return Plan(0, 0, 0, 0)
    rows = next((r for r in fits if cluster * -(-m // r) >= n_sm * 3 // 5), fits[-1])
    clusters = _clusters(m, rows, cluster, n_sm)
    if cluster > 1 and -(-m // rows) >= 3 * clusters:
        return Plan(0, 0, 0, 0)
    return Plan(cluster, group, rows, clusters)


def bind(lib: ctypes.CDLL):
    """The typed entry point ``ensemble_sum_launch`` of a loaded library."""
    fn = lib.ensemble_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return bind(build.library("tree_qmc"))


@functools.cache
def _n_sm(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ensemble_sum(
    feature: torch.Tensor,    # (T, M) int32
    threshold: torch.Tensor,  # (T, M) f32
    left: torch.Tensor,       # (T, M) int32
    right: torch.Tensor,      # (T, M) int32
    value: torch.Tensor,      # (T, M) f32
    x: torch.Tensor,          # (m, F) f32
    *,
    depth: int,
    launch: Plan | None = None,
) -> torch.Tensor:
    """(m,) sum of per-tree leaf values, trees added in order 0..T-1.

    ``launch`` overrides :func:`plan` (a smem-path plan must fit, else the
    launch fails): the card tests and ``chip_smoke.py`` take both paths and
    several plans on one input.
    """
    return launch_with(_fn, feature, threshold, left, right, value, x, depth=depth,
                       launch=launch)


def launch_with(entry, feature, threshold, left, right, value, x, *, depth: int,
                launch: Plan | None = None) -> torch.Tensor:
    """:func:`ensemble_sum` through the entry point that ``entry()`` gives
    (see :func:`bind`), asked for once the inputs have passed their checks."""
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
    p = launch or plan(n_trees, n_nodes, n_feat, m, _n_sm(device))
    err = entry()(feature.data_ptr(), threshold.data_ptr(), left.data_ptr(), right.data_ptr(),
                value.data_ptr(), x.data_ptr(), out.data_ptr(), m, n_trees, n_nodes, n_feat,
                depth, *p, device, stream)
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    build.PATHS[f"{NAME}.{p.path}"] += 1
    return out
