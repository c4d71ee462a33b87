"""Hot-group precompute cache: (table, group, version)-keyed device residency.

Port of ``repro/serving/feature_cache.py``.  :class:`FeatureCache` keeps a
request's ``(k, cap)`` sample buffers, group sizes and incremental-AFC
tables on the device per *(request spec row, cap)*:

* **key** — ``((table, column, gid), ...) + (cap,)`` names the request
  shape; the tuple of per-spec **group versions** (bumped by every
  ``Table.append``) names its freshness.  An entry of another version is
  never served: it is delta-refreshed to the new version or rebuilt.
* **hit** — the entry as it is: no gather, no copy from the host, no
  precompute, no new slot (the prebuilt executor copies its tensors into
  the slot of its bucket, device to device).
* **stale hit** — the store's bounded append log replayed through
  ``refresh`` (``build_afc_precompute``): the buffer shifts, the power-sum
  tables take two-sum row updates, the holistic index merges its sorted
  runs.  An event at prefix position 0 (a new shift basis) or a log that no
  longer reaches back falls back to a cold rebuild.
* **miss** — the requests' prefixes gathered into a host buffer
  (:class:`~repro_torch.data.store.HostStaging`: pinned on the card, copied
  asynchronously) and ``cold`` run once over all misses of a call of
  :meth:`FeatureCache.get_many`, one ``prefix_power_sums`` launch; each
  entry then copies its rows out of the batch's tensors
  (:func:`entry_rows`), so the LRU of ``maxsize`` entries bounds what the
  device holds.

The cache is host-side bookkeeping (a dict of device-tensor handles); all
numeric work happens in the ``cold`` and ``refresh`` functions its owner
supplies.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.executor_fused import PrebuiltTables, build_afc_precompute
from repro_torch.data.store import ColumnStore, HostStaging
from repro_torch.device import resolve_device

__all__ = ["CacheEntry", "FeatureCache", "entry_checksum", "entry_rows",
           "pipeline_feature_cache"]


@dataclass
class CacheEntry:
    """Device-resident precompute for one (spec row, cap) request shape."""

    vals: torch.Tensor         # (k, cap) padded prefix buffers
    n: torch.Tensor            # (k,) int32 group sizes clamped to cap
    tables: PrebuiltTables
    versions: tuple[int, ...]  # per-spec group versions the entry reflects
    #: :func:`entry_checksum` of (vals, n) when built or refreshed; ``None``
    #: is never checked.
    checksum: tuple[float, float, int] | None = None


def _checksum_terms(vals: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    v = vals.to(torch.float64)
    return torch.stack([v.sum(), (v * v).sum(), n.to(torch.float64).sum()])


def _as_checksum(terms) -> tuple[float, float, int]:
    s1, s2, cnt = terms
    return (float(s1), float(s2), int(cnt))


def entry_checksum(vals: torch.Tensor, n: torch.Tensor) -> tuple[float, float, int]:
    """Order-invariant integrity fingerprint of an entry: float64 Σx and Σx²
    over the values buffer, and the total group size.

    Computed on the entry's own device (one read-back), so a checksum is
    compared only with checksums made the same way on the same tensors; on
    the CPU it agrees with the reference's numpy float64 sums to rounding.
    A corruption detector, not a MAC.
    """
    return _as_checksum(_checksum_terms(vals, n).tolist())


def entry_rows(vals: torch.Tensor, n: torch.Tensor,
               tables: PrebuiltTables) -> list[tuple[torch.Tensor, torch.Tensor, PrebuiltTables]]:
    """Split a miss batch's ``(R, k, cap)`` buffers, ``(R, k)`` sizes and
    ``cold`` tables into R ``(vals, n, tables)`` rows, each a copy with
    storage of its own (device to device): a view would keep the whole
    batch alive as long as any one of its entries."""
    rows = []
    for i in range(vals.shape[0]):
        rows.append((vals[i].clone(), n[i].clone(), PrebuiltTables(
            tables.ptab[i].clone(), tables.shift[i].clone(),
            type(tables.rindex)(*(t[i].clone() for t in tables.rindex)))))
    return rows


class FeatureCache:
    """LRU of :class:`CacheEntry` keyed by ``(specs, cap)`` + group versions.

    ``cold(vals (..., k, cap), n (..., k)) -> PrebuiltTables`` and
    ``refresh(vals, n, tables, j, x, aff) -> (vals, n, tables)`` come from
    ``build_afc_precompute``.  Setting :attr:`verify_hits` recomputes an
    entry's checksum on every hit (a read-back from the device), dropping a
    corrupt entry and rebuilding it.  ``device`` is where the entries live;
    ``staging`` the host buffers a miss gathers into (one is made for
    ``device`` when none is given).
    """

    def __init__(
        self,
        store: ColumnStore,
        cold: Callable[..., PrebuiltTables],
        refresh: Callable[..., Any],
        *,
        maxsize: int = 64,
        device=None,
        staging: HostStaging | None = None,
    ) -> None:
        self.store = store
        self.cold = cold
        self.refresh = refresh
        self.maxsize = int(maxsize)
        self.verify_hits = False
        self.device = resolve_device(device)
        self.staging = staging if staging is not None else HostStaging(self.device)
        self._entries: OrderedDict[tuple, CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.refreshes = 0
        self.corruptions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def stats(self) -> dict[str, int]:
        return dict(hits=self.hits, misses=self.misses, refreshes=self.refreshes,
                    corruptions=self.corruptions, entries=len(self._entries))

    @staticmethod
    def _intact(entry: CacheEntry) -> bool:
        if entry.checksum is None:
            return True
        return entry_checksum(entry.vals, entry.n) == entry.checksum

    def get(self, specs: list[tuple[str, str, int]], cap: int) -> CacheEntry:
        """The entry for this request, built, refreshed or fetched as needed."""
        return self.get_many([specs], cap)[0]

    def get_many(self, specs_list: list[list[tuple[str, str, int]]],
                 cap: int) -> list[CacheEntry]:
        """The entries of several requests at one cap, in order.

        Each request is looked up as :meth:`get` would, in turn (a request
        repeated in the list hits the entry its first occurrence made); the
        misses are then gathered into one host buffer, copied once and built
        by one call of ``cold``.
        """
        out: list[CacheEntry] = []
        pending: list[tuple[CacheEntry, list]] = []
        for specs in specs_list:
            specs = [tuple(s) for s in specs]
            base = (tuple(specs), int(cap))
            want = self.store.spec_versions(specs)
            entry = self._entries.get(base)
            if entry is not None and self.verify_hits and not self._intact(entry):
                # corrupted device-resident state is never served
                self.corruptions += 1
                del self._entries[base]
                entry = None
            if entry is not None:
                if entry.versions == want:
                    self.hits += 1
                    self._entries.move_to_end(base)
                    out.append(entry)
                    continue
                refreshed = self._try_refresh(entry, specs, cap, want)
                if refreshed is not None:
                    self.refreshes += 1
                    self._entries[base] = refreshed
                    self._entries.move_to_end(base)
                    out.append(refreshed)
                    continue
            self.misses += 1
            # filled below, with the other misses of this call
            entry = CacheEntry(vals=None, n=None, tables=None, versions=want)
            pending.append((entry, specs))
            self._entries[base] = entry
            self._entries.move_to_end(base)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
            out.append(entry)
        if pending:
            self._build([specs for _, specs in pending], cap, [e for e, _ in pending])
        return out

    def _build(self, specs_list: list[list], cap: int, entries: list[CacheEntry]) -> None:
        """Gather, copy and ``cold``-build the misses of one call."""
        buf = self.staging.gather(self.store, specs_list, cap)
        vals = self.staging.to_device(buf)
        sizes = torch.from_numpy(np.stack(
            [self.store.request_sizes(specs, cap) for specs in specs_list])).to(self.device)
        rows = entry_rows(vals, sizes, self.cold(vals, sizes))
        for entry, (v, n, tables) in zip(entries, rows):
            entry.vals, entry.n, entry.tables = v, n, tables
        terms = torch.stack([_checksum_terms(e.vals, e.n) for e in entries]).tolist()
        for entry, t in zip(entries, terms):
            entry.checksum = _as_checksum(t)

    def revalidate(self) -> int:
        """Drop entries that are stale or corrupt; returns the count.

        The store-recovery hook (``Table.recover``): every resident entry is
        checked against the store's current versions and its own checksum.
        """
        dead = []
        for base, entry in self._entries.items():
            specs, cap = list(base[0]), base[1]
            want = self.store.spec_versions(specs)
            if entry.versions != want or not self._intact(entry):
                dead.append(base)
        for base in dead:
            if not self._intact(self._entries[base]):
                self.corruptions += 1
            del self._entries[base]
        return len(dead)

    def _try_refresh(self, entry: CacheEntry, specs: list[tuple[str, str, int]], cap: int,
                     want: tuple) -> CacheEntry | None:
        """Delta-update a stale entry from the append logs, or None."""
        # one event stream per distinct (table, gid) the specs reference
        groups: dict[tuple[str, int], list[tuple[int, int]]] = {}
        for si, (t, _c, g) in enumerate(specs):
            if (t, g) in groups:
                continue
            events = self.store[t].events_since(g, entry.versions[si])
            if events is None or any(j == 0 for (j, _r) in events):
                return None  # log aged out / shift-basis change: rebuild
            groups[(t, g)] = events
        vals, n, tables = entry.vals, entry.n, entry.tables
        for (t, g), events in groups.items():
            table = self.store[t]
            aff = np.array([(st == t and sg == g) for (st, _sc, sg) in specs], bool)
            for (j, row_id) in events:
                x = np.array([float(table.columns[sc][row_id]) if aff[si] else 0.0
                              for si, (_st, sc, _sg) in enumerate(specs)], np.float32)
                vals, n, tables = self.refresh(vals, n, tables, int(j), x, aff)
        return CacheEntry(vals=vals, n=n, tables=tables, versions=want,
                          checksum=entry_checksum(vals, n))


def pipeline_feature_cache(store: ColumnStore, k: int, config, feat_kwargs: dict, *,
                           maxsize: int, device, use_kernel: bool,
                           staging: HostStaging) -> FeatureCache:
    """The cache a fused server of a pipeline keeps: ``cold`` and ``refresh``
    built for its ``k`` features, its config's α, γ and ``max_iters`` and its
    executor kwargs (``executor_fused.pipeline_executor_kwargs``)."""
    pre = build_afc_precompute(
        k=k, alpha=config.alpha, gamma=config.gamma, max_iters=config.max_iters,
        holistic=feat_kwargs["holistic"], quantiles=feat_kwargs["quantiles"],
        approximate=feat_kwargs["approximate"], device=device, use_kernel=use_kernel)
    return FeatureCache(store, pre.cold, pre.refresh, maxsize=maxsize, device=device,
                        staging=staging)
