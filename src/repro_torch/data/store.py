"""In-memory columnar datastore: the read path of ``repro/data/store.py``.

Each table holds row-aligned numpy columns and a CSR group index over a
permutation that shuffles rows once *within each group* with a fixed seed,
so the prefix of length z of a group is a simple random sample of size z.
The fused executor reads one padded ``(k, cap)`` prefix buffer per request
(:meth:`ColumnStore.request_buffers`), moved to the device in one copy.

Streaming appends, the journal and crash recovery are later slices of the
port; this module keeps the build-time store and its reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

import numpy as np
import torch

__all__ = ["Table", "ColumnStore", "bucket_size", "build_table"]


def bucket_size(z: int, minimum: int = 64) -> int:
    """Round a sample size up to the next power of two."""
    cap = minimum
    while cap < z:
        cap *= 2
    return cap


@dataclass
class Table:
    """Row-aligned columns + CSR-style group index over a permutation."""

    columns: dict[str, np.ndarray]
    group_ptr: np.ndarray          # (G+1,) offsets into perm
    perm: np.ndarray               # (R,) row ids, permuted within each group
    group_ids: dict[int, int]      # external group key -> dense group index
    name: str = ""

    @property
    def n_rows(self) -> int:
        return int(self.perm.shape[0])

    def _group_index(self, gid: int) -> int:
        try:
            return self.group_ids[int(gid)]
        except KeyError:
            raise ValueError(
                f"table {self.name or '<unnamed>'!r}: unknown group key "
                f"{int(gid)} (known groups: {len(self.group_ids)})"
            ) from None

    def _bounds(self, gid: int) -> tuple[int, int]:
        g = self._group_index(gid)
        return int(self.group_ptr[g]), int(self.group_ptr[g + 1])

    def group_size(self, gid: int) -> int:
        start, stop = self._bounds(gid)
        return stop - start

    def sample_prefix(self, column: str, gid: int, cap: int) -> np.ndarray:
        """First ``min(cap, N)`` permuted rows of the group, zero-padded to cap."""
        start, stop = self._bounds(gid)
        take = min(cap, stop - start)
        out = np.zeros((cap,), np.float32)
        out[:take] = self.columns[column][self.perm[start : start + take]]
        return out

    def full_values(self, column: str, gid: int) -> np.ndarray:
        start, stop = self._bounds(gid)
        return self.columns[column][self.perm[start:stop]].astype(np.float32)

    def lookup(self, column: str, gid: int) -> float:
        """Point lookup: the group's first permuted row (0.0 when empty)."""
        start, stop = self._bounds(gid)
        if start == stop:
            return 0.0
        return float(self.columns[column][self.perm[start]])


def build_table(
    columns: Mapping[str, np.ndarray],
    group_key: np.ndarray,
    seed: int = 0,
) -> Table:
    """Index ``columns`` by ``group_key`` and fix the per-group sample order.

    Draws the same permutations from ``np.random.default_rng(seed)`` as the
    reference's ``build_table``, so both stores hold the same arrays.
    """
    group_key = np.asarray(group_key)
    uniq, inverse = np.unique(group_key, return_inverse=True)
    order = np.argsort(inverse, kind="stable")
    counts = np.bincount(inverse, minlength=len(uniq))
    ptr = np.zeros(len(uniq) + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    rng = np.random.default_rng(seed)
    perm = order.copy()
    for g in range(len(uniq)):
        s, e = ptr[g], ptr[g + 1]
        perm[s:e] = rng.permutation(perm[s:e])
    cols = {k: np.asarray(v) for k, v in columns.items()}
    gids = {int(k): i for i, k in enumerate(uniq)}
    return Table(columns=cols, group_ptr=ptr, perm=perm, group_ids=gids)


@dataclass
class ColumnStore:
    """A named collection of tables — the serving datastore."""

    tables: dict[str, Table] = field(default_factory=dict)

    def add(self, name: str, table: Table) -> "ColumnStore":
        table.name = table.name or name
        self.tables[name] = table
        return self

    def __getitem__(self, name: str) -> Table:
        return self.tables[name]

    def request_buffers(
        self,
        specs: list[tuple[str, str, int]],
        cap: int,
        device: torch.device | str,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(k, cap) float32 padded prefix buffers + (k,) int32 sizes on ``device``.

        ``specs`` is ``[(table, column, gid), ...]`` per aggregate feature;
        one host-to-device copy per request.
        """
        bufs = np.stack(
            [self.tables[t].sample_prefix(c, g, cap) for (t, c, g) in specs]
        )
        sizes = np.array(
            [min(self.tables[t].group_size(g), cap) for (t, _c, g) in specs],
            np.int32,
        )
        return (
            torch.from_numpy(bufs).to(device),
            torch.from_numpy(sizes).to(device),
        )
