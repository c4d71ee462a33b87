"""Continuous batching: a lane table served by the chunked fused executor.

Port of ``repro/serving/continuous.py``.  The fixed-lane server
(``serving/batched.py``) holds every lane of a batch until its slowest
request is done, the waste ``straggler_report`` measures.  Here the
executor runs at most ``chunk_iters`` planner iterations per dispatch over
a persistent **lane table** (``core/executor_fused.LaneState``, every
lane's state as fixed device tensors), and a lane whose request is done is
refilled from the queue at the next chunk boundary.

Two slots per power-of-two cap bucket, whatever the fill, the chunk count,
the knobs or the lanes refilled (``compile_count``; on the card each is
captured once as CUDA graphs):

* **refill** — a one-lane ``(1, cap)`` slot: admitting a request copies
  its inputs in, runs its z⁰ evaluation (and its Saltelli block, kept if it
  iterates) on that lane alone, then one lane-write program copies the lane
  into row ``lane`` of the table at a device index, so one captured graph
  serves every lane.  A masked full-width re-init was measured by the
  reference at 8-20× the cost of one admission.
* **table** — the ``(lanes, cap)`` slot whose step program a chunk replays,
  at most ``chunk_iters`` times, until no lane wants more.

With a ``mesh`` (``launch/mesh.py``) the table splits over its shards
(``executor_fused.shard_lanes_state_executor``): each shard holds ``L/D``
lanes with its own refill slot, an admission runs on the lane's owner only,
and a chunk replays every shard's step on the shard's own stream.  Each
shard builds two slots a bucket.

The server owns the executor and the buffer assembly; the caller owns the
table and the lane bookkeeping: ``new_table`` → (``admit`` |
``run_chunk``)* → ``readback``.  One table serves one cap bucket (the
trace's largest); the per-request knobs are refill inputs.  The scheduler
is ``serving/runtime.ContinuousServingRuntime``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.contracts import assert_compile_contract
from repro_torch.core.executor_fused import (
    build_chunked_executor,
    pipeline_executor_kwargs,
    shard_lanes_state_executor,
)
from repro_torch.core.pipeline import make_fused_model_fn
from repro_torch.data.store import HostStaging, bucket_size
from repro_torch.serving.batched import (
    lane_request_inputs,
    pipelines_on,
    sanitize_lane_inputs,
    serving_devices,
    validate_serving_mesh,
)
from repro_torch.serving.feature_cache import FeatureCache, pipeline_feature_cache

__all__ = ["ContinuousBatchedServer"]


class ContinuousBatchedServer:
    """Lane-table server over the chunked fused executor, on ``device``.

    ``batch_size`` is the table's lane count, ``chunk_iters`` the planner
    iterations a chunk may advance a lane (how soon a freed lane is refilled
    against how many dispatches a request takes).  ``max_cap``,
    ``afc_backend``, ``sanitize``, ``use_kernel`` and ``capture`` mean what
    they mean on :class:`~repro_torch.serving.batched.BatchedFusedServer`.
    ``cache_size`` serves every admission from the hot-group feature cache:
    the entry's device-resident buffers and AFC tables are copied into the
    refill slot, and a hit gathers nothing from the host and launches no
    ``prefix_power_sums``.  ``mesh`` shards the table's lanes over its
    devices as on ``BatchedFusedServer`` (``device`` left out, ``cache_size``
    raises); ``table`` is then a ``ShardedLaneState`` and every method below
    splits and joins by global lane.  :attr:`contract` names the registered
    contracts ``check_compile_contract`` asserts (refill + chunk).
    """

    def __init__(self, bundle, config, batch_size: int = 8, chunk_iters: int = 4,
                 max_cap: int | None = None, mesh=None, afc_backend: str = "auto",
                 cache_size: int | None = None, sanitize: str = "reject", *, device=None,
                 use_kernel: bool = True, capture: bool | None = None):
        if sanitize not in ("reject", "clamp"):
            raise ValueError(f"sanitize must be 'reject' or 'clamp', got {sanitize!r}")
        self.batch_size = int(batch_size)
        self.n_devices = validate_serving_mesh(mesh, self.batch_size)
        if cache_size is not None and mesh is not None:
            raise ValueError("cache_size and mesh are mutually exclusive: cached admissions "
                             "copy cache entries of one device, a sharded table lives on its "
                             "shards")
        devices = serving_devices(mesh, device)
        self.device = devices[0]
        self.mesh = mesh
        self.bundle = bundle
        self.config = config
        self.chunk_iters = int(chunk_iters)
        self.sanitize = sanitize
        self.contract = ("refill", "chunk", "afc_precompute") if cache_size is not None \
            else ("refill", "chunk")
        p = bundle.pipeline
        on = pipelines_on(p, devices)
        feat_kwargs = pipeline_executor_kwargs(p.agg_features, self.device)
        self._agg_ids = feat_kwargs.pop("agg_ids")

        def build(d):
            return build_chunked_executor(
                make_fused_model_fn(on[d], d, use_kernel=use_kernel),
                chunk_iters=self.chunk_iters, k=p.k, task=p.task,
                n_classes=max(p.n_classes, 2), m=config.m, m_sobol=config.m_sobol,
                alpha=config.alpha, gamma=config.gamma, tau=config.tau,
                max_iters=config.max_iters, n_boot=config.n_bootstrap, afc_backend=afc_backend,
                device=d, use_kernel=use_kernel, capture=capture,
                prebuilt=cache_size is not None, **feat_kwargs,
            )

        self._exe = build(self.device) if mesh is None else shard_lanes_state_executor(
            build, mesh)
        self._staging = HostStaging(self.device)
        self.cache: FeatureCache | None = None
        if cache_size is not None:
            self.cache = pipeline_feature_cache(
                bundle.store, p.k, config, feat_kwargs, maxsize=cache_size, device=self.device,
                use_kernel=use_kernel, staging=self._staging)
        self._caps_seen: set[int] = set()
        max_n = max(
            bundle.store[f.table].group_size(g)
            for f in p.agg_features
            for g in bundle.store[f.table].group_ids
        )
        self._max_cap = bucket_size(max_n)
        if max_cap is not None:
            self._max_cap = min(self._max_cap, bucket_size(max_cap))

    # ------------------------------------------------------------------
    @property
    def compiled_buckets(self) -> list[int]:
        """Cap buckets admitted into so far."""
        return sorted(self._caps_seen)

    @property
    def compile_count(self) -> int:
        """Slots built (on the card: captures): the refill slot and the
        table slot of each cap bucket, 2 per bucket after its first table,
        whatever is admitted, restored or cleared later."""
        return self.refill_compiles + self.chunk_compiles + self.cold_compiles

    @property
    def shard_compile_counts(self) -> list[int]:
        """Each shard's own slots (refill and table; empty without a mesh)."""
        return [] if self.mesh is None else self._exe.shard_slots_built

    def check_compile_contract(self, *, buckets=None) -> None:
        """Assert the slot counts against :attr:`contract`: the refill slot
        and the table slot of each cap bucket, on every shard."""
        assert_compile_contract(self, self.contract, buckets=buckets)

    @property
    def refill_compiles(self) -> int:
        return self._exe.slots_built

    @property
    def chunk_compiles(self) -> int:
        return self._exe.tables_built

    @property
    def cold_compiles(self) -> int:
        """Always 0: the cache's ``cold`` precompute runs eagerly and builds
        no slot (the reference compiles it once per bucket)."""
        return 0

    def request_cap(self, req: dict) -> int:
        """Power-of-two bucket over THIS request's largest group."""
        p = self.bundle.pipeline
        return min(bucket_size(int(p.group_sizes(self.bundle.store, req).max())), self._max_cap)

    def trace_cap(self, requests) -> int:
        """The shared table cap for a trace: max over its requests."""
        return max(self.request_cap(r) for r in requests)

    # ------------------------------------------------------------------
    def new_table(self, cap: int):
        """The lane table of a cap bucket, every lane empty (``active =
        False``: a chunk never moves an empty lane).  The bucket's table and
        refill slot are made (and on the card captured) by its first call; a
        later call resets the same table in place and returns it."""
        p = self.bundle.pipeline
        return self._exe.new_table(self.batch_size, cap, len(p.exact_features))

    def admit(self, table, cap: int, assignments):
        """Refill lanes with fresh requests: one one-lane refill each.

        ``assignments`` is a list of ``(lane, request, knobs_or_None)``;
        each named lane's whole state is overwritten with the request's
        (inputs, z⁰ carry, AFC tables, knobs, ``it = 0``), the other lanes
        are left as they are.  Knobs are objects with ``delta``, ``tau`` and
        ``iter_cap`` (:class:`~repro_torch.serving.degrade.LaneKnobs`), or
        ``None`` for the config's.  Returns ``(table, true_rows)``:
        ``true_rows`` maps each lane to its request's TRUE total group rows
        (the ``sample_frac`` denominator of the paper's §4).
        """
        p, store, cfg = self.bundle.pipeline, self.bundle.store, self.config
        delta_default = cfg.delta if cfg.delta is not None else p.delta_default
        lanes = self.batch_size
        seen: set[int] = set()
        for lane, req, _kn in assignments:
            if not 0 <= lane < lanes:
                raise ValueError(f"lane {lane} outside 0..{lanes - 1}")
            if lane in seen:
                raise ValueError(f"lane {lane} assigned twice in one admit")
            if self.request_cap(req) > cap:
                raise ValueError(f"request needs cap {self.request_cap(req)} > table cap {cap}; "
                                 "size the table with trace_cap")
            seen.add(lane)
        self._caps_seen.add(cap)
        true_rows: dict[int, int] = {}
        for lane, req, kn in assignments:
            delta = delta_default if kn is None else kn.delta
            tau = cfg.tau if kn is None else kn.tau
            iter_cap = cfg.max_iters if kn is None else min(int(kn.iter_cap), cfg.max_iters)
            true_n = np.asarray(p.group_sizes(store, req), np.int64)
            if self.cache is not None:
                # device-resident entry: its buffers are sanitized when the
                # store takes rows and checked by the cache's checksum
                entry = self.cache.get(p.agg_specs(req), cap)
                exact = sanitize_lane_inputs(None, p.exact_feature_values(store, req),
                                             policy=self.sanitize, where=f"admit lane {lane}")[1]
                self._exe.refill(table, lane, entry.vals, entry.n, self._agg_ids, delta, exact,
                                 tau, iter_cap, entry.tables)
            else:
                vals, n, true_n, exact = lane_request_inputs(
                    p, store, req, cap, self._staging, policy=self.sanitize, lane=lane)
                self._exe.refill(table, lane, vals[0], n, self._agg_ids, delta, exact, tau,
                                 iter_cap)
                self._staging.release(vals)
            true_rows[lane] = int(true_n.sum())
        return table, true_rows

    def run_chunk(self, table):
        """Advance every lane at most ``chunk_iters`` planner iterations."""
        return self._exe.chunk(table)

    # ------------------------------------------------------------------
    @staticmethod
    def readback(table) -> dict:
        """Host copies of the small per-lane leaves the scheduler reads
        (``LaneState.readback``: one copy to the host); the big buffers
        stay on the device."""
        return table.readback()

    @staticmethod
    def snapshot(table) -> dict[str, np.ndarray]:
        """Checkpoint of the chunk carry (``CHUNK_CARRY_LEAVES``) on the host."""
        return table.snapshot()

    @staticmethod
    def restore(table, ckpt: dict[str, np.ndarray]):
        """Roll the carry back to a :meth:`snapshot`, in place: no slot."""
        table.restore(ckpt)
        return table

    @staticmethod
    def clear_lanes(table, lanes):
        """Evict lanes (quarantine / failure) in place: they stop moving, and
        their carry is reset so no step reads a wrecked index."""
        table.clear_lanes(lanes)
        return table
