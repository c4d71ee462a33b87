"""In-memory columnar datastore: port of ``repro/data/store.py``.

Each table holds row-aligned numpy columns and a CSR group index over a
permutation that shuffles rows once *within each group* with a fixed seed,
so the prefix of length z of a group is a simple random sample of size z.
The fused executor reads one padded ``(k, cap)`` prefix buffer per request:
:meth:`ColumnStore.request_buffers`, or a :class:`HostStaging` buffer whose
copy to the card is asynchronous.

**Streaming append**: :meth:`Table.append` inserts each new row at a
position ``j ~ Uniform{0..m}`` of its group's permuted prefix, drawn from
the generator the build drew the permutations from, so every prefix stays
a simple random sample.  Each insertion bumps the group's **version** (the
freshness half of a feature-cache key, ``serving/feature_cache.py``) and is
recorded in a bounded per-group log, from which a cached entry is
delta-refreshed.  Every append is also written to an unbounded **journal**
stamped with a table-wide sequence number; :meth:`Table.recover` rebuilds
the derived index state (``perm``, ``group_ptr``, ``group_ids``,
``versions``, the log) by replaying it over the build-time base with the
original positions ``j`` (nothing is drawn again).  The same seed and the
same appends give the reference's arrays, versions and log bit for bit.

**Input sanitization**: a NaN or Inf poisons every prefix power sum over
it, so ``append`` rejects it (``sanitize="reject"``, naming the table,
column and row) or maps NaN to 0.0 and ±Inf to the column's finite range
(``sanitize="clamp"``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

import numpy as np
import torch

__all__ = ["MAX_APPEND_LOG", "ColumnStore", "HostStaging", "Table", "bucket_size",
           "build_table"]

#: Append-log depth per group: a cached entry older than this many
#: insertions is rebuilt instead of delta-refreshed.
MAX_APPEND_LOG = 64


def bucket_size(z: int, minimum: int = 64) -> int:
    """Round a sample size up to the next power of two."""
    cap = minimum
    while cap < z:
        cap *= 2
    return cap


@dataclass
class Table:
    """Row-aligned columns + CSR-style group index over a permutation.

    ``versions[g]`` counts the insertions into dense group ``g`` since the
    build, so ``(table, group, version)`` is a sound cache key.  ``rng``
    continues the build's seeded stream: (seed, appends) fix the append
    trajectory.
    """

    columns: dict[str, np.ndarray]
    group_ptr: np.ndarray          # (G+1,) offsets into perm
    perm: np.ndarray               # (R,) row ids, permuted within each group
    group_ids: dict[int, int]      # external group key -> dense group index
    name: str = ""
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0), repr=False)
    versions: list[int] = field(default_factory=list, repr=False)
    # dense group -> [(version, j, row_id)] of its last MAX_APPEND_LOG
    # insertions, oldest first (version: the one the insertion produced)
    _log: dict[int, list[tuple[int, int, int]]] = field(default_factory=dict, repr=False)
    #: table-wide monotone sequence number, stamped on every journal entry
    seq: int = field(default=0, repr=False)
    # the whole journal, oldest first: (seq, group key, j, row_id); j = -1
    # marks a group registration
    _journal: list[tuple[int, int, int, int]] = field(default_factory=list, repr=False)

    def __post_init__(self) -> None:
        # the base recover() replays the journal over: index state only, the
        # raw columns are the durable record
        self._base_perm = self.perm.copy()
        self._base_ptr = self.group_ptr.copy()
        self._base_gids = dict(self.group_ids)
        self._base_versions = list(self.versions)

    @property
    def n_rows(self) -> int:
        return int(self.perm.shape[0])

    @property
    def n_groups(self) -> int:
        return int(self.group_ptr.shape[0] - 1)

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

    def version(self, gid: int) -> int:
        """Insertions into the group since the build: the cache-key component."""
        g = self._group_index(gid)
        return self.versions[g] if g < len(self.versions) else 0

    def group_size(self, gid: int) -> int:
        start, stop = self._bounds(gid)
        return stop - start

    def sample_prefix(self, column: str, gid: int, cap: int,
                      out: np.ndarray | None = None) -> np.ndarray:
        """First ``min(cap, N)`` permuted rows of the group, zero-padded to cap.

        ``out``, a (cap,) float32 array (a row of a pinned host buffer), is
        written and returned in place of a new array.
        """
        start, stop = self._bounds(gid)
        take = min(cap, stop - start)
        if out is None:
            out = np.zeros((cap,), np.float32)
        else:
            out[take:] = 0.0
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

    # --- streaming append --------------------------------------------------
    def add_group(self, gid: int) -> int:
        """Register an empty group (idempotent); returns its dense index."""
        key = int(gid)
        if key in self.group_ids:
            return self.group_ids[key]
        g = self._register_group(key)
        self.seq += 1
        self._journal.append((self.seq, key, -1, -1))
        return g

    def _register_group(self, key: int) -> int:
        """Grow the index for a new group without journaling it."""
        g = self.n_groups
        self.group_ptr = np.append(self.group_ptr, self.group_ptr[-1])
        self.group_ids[key] = g
        self._ensure_versions(g)
        return g

    def _ensure_versions(self, g: int) -> None:
        while len(self.versions) <= g:
            self.versions.append(0)

    def _sanitize_columns(self, new_cols: dict[str, np.ndarray],
                          policy: str) -> dict[str, np.ndarray]:
        """NaN/Inf at the ingest edge: ``reject`` raises naming the table,
        column and row of the batch; ``clamp`` maps NaN to 0.0 and ±Inf to
        the column's observed finite range."""
        if policy not in ("reject", "clamp"):
            raise ValueError(
                f"table {self.name or '<unnamed>'!r}: unknown sanitize policy {policy!r} "
                f"(expected 'reject' or 'clamp')")
        for k, v in new_cols.items():
            if not np.issubdtype(v.dtype, np.floating):
                continue
            bad = ~np.isfinite(v)
            if not bad.any():
                continue
            if policy == "reject":
                i = int(np.flatnonzero(bad)[0])
                raise ValueError(
                    f"table {self.name or '<unnamed>'!r}: non-finite value {float(v[i])!r} in "
                    f"append column {k!r} at batch row {i} (sanitize='reject'; pass "
                    f"sanitize='clamp' to coerce)")
            old = self.columns[k]
            pool = np.concatenate([old[np.isfinite(old)], v[~bad]])
            hi = float(pool.max()) if pool.size else 0.0
            lo = float(pool.min()) if pool.size else 0.0
            w = v.copy()
            w[np.isnan(v)] = 0.0
            w[v == np.inf] = hi
            w[v == -np.inf] = lo
            new_cols[k] = w
        return new_cols

    def append(self, rows: Mapping[str, np.ndarray], group_key, *,
               sanitize: str = "reject") -> None:
        """Append rows, each at a position ``j ~ Uniform{0..m}`` of its group.

        ``rows`` maps every column to an (r,) array; ``group_key`` gives each
        row's group (an unknown key registers a new group); m is the group's
        size before the insertion and ``j`` is drawn from :attr:`rng`.  Each
        insertion bumps its group's version, is logged (the last
        :data:`MAX_APPEND_LOG` of a group) and journaled.  A rejected batch
        changes nothing.
        """
        group_key = np.atleast_1d(np.asarray(group_key))
        r = group_key.shape[0]
        missing = sorted(set(self.columns) - set(rows))
        extra = sorted(set(rows) - set(self.columns))
        if missing or extra:
            raise ValueError(
                f"table {self.name or '<unnamed>'!r}: append columns must match the table "
                f"(missing {missing}, unexpected {extra})")
        new_cols = {k: np.atleast_1d(np.asarray(v)).astype(self.columns[k].dtype)
                    for k, v in rows.items()}
        for k, v in new_cols.items():
            if v.shape[0] != r:
                raise ValueError(
                    f"table {self.name or '<unnamed>'!r}: column {k!r} has {v.shape[0]} rows, "
                    f"group_key has {r}")
        new_cols = self._sanitize_columns(new_cols, sanitize)
        base = self.n_rows
        for k in self.columns:
            self.columns[k] = np.concatenate([self.columns[k], new_cols[k]])
        for i in range(r):
            key = int(group_key[i])
            g = self.add_group(key)
            row_id = base + i
            start = int(self.group_ptr[g])
            m = int(self.group_ptr[g + 1]) - start
            j = int(self.rng.integers(0, m + 1))
            self.perm = np.insert(self.perm, start + j, row_id)
            self.group_ptr[g + 1:] += 1
            self._ensure_versions(g)
            self.versions[g] += 1
            log = self._log.setdefault(g, [])
            log.append((self.versions[g], j, row_id))
            del log[:-MAX_APPEND_LOG]
            self.seq += 1
            self._journal.append((self.seq, key, j, row_id))

    def events_since(self, gid: int, version: int) -> list[tuple[int, int]] | None:
        """The ``(j, row_id)`` insertions after ``version``, oldest first;
        ``None`` when the bounded log no longer reaches back that far."""
        g = self._group_index(gid)
        current = self.versions[g] if g < len(self.versions) else 0
        if version == current:
            return []
        log = self._log.get(g, [])
        if not log or log[0][0] > version + 1:
            return None
        return [(j, row_id) for (v, j, row_id) in log if v > version]

    # --- crash recovery ----------------------------------------------------
    def recover(self, caches: tuple = ()) -> dict[str, int]:
        """Rebuild ``perm``, ``group_ptr``, ``group_ids``, ``versions`` and the
        log by replaying the journal over the build-time base.

        Raises on a journal whose sequence numbers have a gap.  ``caches``
        (:class:`~repro_torch.serving.feature_cache.FeatureCache`) are
        revalidated afterwards: entries stale or corrupt are dropped.
        Returns the events replayed, the groups and the entries dropped.
        """
        seqs = [e[0] for e in self._journal]
        if seqs and seqs != list(range(seqs[0], seqs[0] + len(seqs))):
            raise ValueError(
                f"table {self.name or '<unnamed>'!r}: append journal is not a gap-free "
                f"monotone sequence — cannot recover")
        perm = self._base_perm.copy()
        ptr = self._base_ptr.copy()
        gids = dict(self._base_gids)
        versions = list(self._base_versions)
        log: dict[int, list[tuple[int, int, int]]] = {}
        for (_seq, key, j, row_id) in self._journal:
            if j < 0:
                if key not in gids:
                    gids[key] = len(ptr) - 1
                    ptr = np.append(ptr, ptr[-1])
                    while len(versions) < len(ptr) - 1:
                        versions.append(0)
                continue
            g = gids[key]
            perm = np.insert(perm, int(ptr[g]) + j, row_id)
            ptr[g + 1:] += 1
            while len(versions) <= g:
                versions.append(0)
            versions[g] += 1
            glog = log.setdefault(g, [])
            glog.append((versions[g], j, row_id))
            del glog[:-MAX_APPEND_LOG]
        self.perm, self.group_ptr, self.group_ids = perm, ptr, gids
        self.versions, self._log = versions, log
        dropped = sum(int(c.revalidate()) for c in caches)
        return {"replayed": len(self._journal), "groups": len(gids),
                "cache_entries_dropped": dropped}


def build_table(
    columns: Mapping[str, np.ndarray],
    group_key: np.ndarray,
    seed: int = 0,
) -> Table:
    """Index ``columns`` by ``group_key`` and fix the per-group sample order.

    Draws the same permutations from ``np.random.default_rng(seed)`` as the
    reference's ``build_table`` and keeps that generator for the appends,
    so both stores hold the same arrays before and after the same appends.
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
    return Table(columns=cols, group_ptr=ptr, perm=perm, group_ids=gids, rng=rng,
                 versions=[0] * len(uniq))


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

    def request_sizes(self, specs: list[tuple[str, str, int]], cap: int) -> np.ndarray:
        """(k,) int32 group sizes of ``[(table, column, gid), ...]``, clamped to cap."""
        return np.array([min(self.tables[t].group_size(g), cap) for (t, _c, g) in specs],
                        np.int32)

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
        return (
            torch.from_numpy(bufs).to(device),
            torch.from_numpy(self.request_sizes(specs, cap)).to(device),
        )

    def spec_versions(self, specs: list[tuple[str, str, int]]) -> tuple[int, ...]:
        """Per-spec group versions — the freshness half of a cache key."""
        return tuple(self.tables[t].version(g) for (t, _c, g) in specs)


class HostStaging:
    """Reusable host buffers that request gathers write before their copy to ``device``.

    On a CUDA device each ``(k, cap)`` shape has one pinned buffer of
    ``(rows, k, cap)`` float32, grown when a gather needs more rows, so its
    copy to the card can be asynchronous (``non_blocking=True``).  After the
    copies that read a buffer are enqueued, :meth:`release` records an event
    on the current stream; the next :meth:`gather` into that buffer waits
    for it, so a gather never overwrites values a copy has not read yet.
    Pinning that fails raises: nothing carries on with pageable memory.  On
    the CPU the buffers are plain memory and nothing is copied to a device.
    """

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self._bufs: dict[tuple[int, int], torch.Tensor] = {}
        self._events: dict[tuple[int, int], torch.cuda.Event] = {}

    def _buffer(self, rows: int, k: int, cap: int) -> torch.Tensor:
        key = (k, cap)
        ev = self._events.pop(key, None)
        if ev is not None:
            ev.synchronize()
        buf = self._bufs.get(key)
        if buf is None or buf.shape[0] < rows:
            pin = self.device.type == "cuda"
            buf = torch.zeros((rows, k, cap), dtype=torch.float32, pin_memory=pin)
            if pin and not buf.is_pinned():
                raise RuntimeError(f"HostStaging: a ({rows}, {k}, {cap}) buffer was not pinned")
            self._bufs[key] = buf
        return buf[:rows]

    def gather(self, store: ColumnStore, specs_list: list[list[tuple[str, str, int]]],
               cap: int, rows: int | None = None) -> torch.Tensor:
        """A ``(rows, k, cap)`` host buffer: request i's padded prefixes in row
        i (``specs_list[i]`` is its ``[(table, column, gid), ...]``), zeros in
        the rows past ``len(specs_list)`` (``rows`` defaults to that length)."""
        rows = len(specs_list) if rows is None else rows
        buf = self._buffer(rows, len(specs_list[0]), cap)
        arr = buf.numpy()
        for i, specs in enumerate(specs_list):
            for f, (t, c, g) in enumerate(specs):
                store.tables[t].sample_prefix(c, g, cap, out=arr[i, f])
        arr[len(specs_list):] = 0.0
        return buf

    def to_device(self, buf: torch.Tensor) -> torch.Tensor:
        """A copy of a gathered buffer on the device, made asynchronously on
        the card (then :meth:`release`\\ d); on the CPU a copy of its own."""
        if self.device.type != "cuda":
            return buf.clone()
        out = buf.to(self.device, non_blocking=True)
        self.release(buf)
        return out

    def release(self, buf: torch.Tensor) -> None:
        """Mark the copies that read ``buf`` as enqueued on the current stream."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._events[tuple(buf.shape[1:])] = ev
