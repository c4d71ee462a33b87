"""Batched Biathlon serving: many concurrent requests in one fused executor run.

Port of ``repro/serving/batched.py``.  A batch's
requests are the lanes of the fused executor (``core/executor_fused.py``):
each lane carries its own sample buffers, group sizes, exact features and
knobs, and stops on its own inside the shared loop, which runs until every
lane satisfies Eq. 1, exhausts its groups or reaches its iteration cap (the
continuous-batching trade: stragglers in a batch pay for each other).

Two mechanisms bound the programs built:

* **Fixed lanes** — every batch is padded to exactly ``batch_size`` lanes;
  pad lanes carry zero buffers and ``active=False``, so they never iterate.
  The shapes are ``(batch_size, k, cap)`` for any fill 1..batch_size.
* **Per-batch cap bucketing** — the (lanes, k, cap) gather pads to the
  power of two above the BATCH's largest group, not the store-wide worst
  case.

So the executor builds one slot per cap bucket: on the card, one capture of
its three CUDA graphs (``compile_count``), whatever the fill or the knobs.
``straggler_report`` makes the batching trade measurable.

With a ``mesh`` (``launch/mesh.py``) the lanes split over its shards
(``executor_fused.shard_lanes_executor``): lane ``i`` runs on shard ``i //
(batch_size / D)``, each shard with its own executor, slot, graphs and
stream, and a lane waits only for the lanes of its own shard.

A batch's prefix buffers are gathered from the store into a pinned host
buffer (one per cap bucket, ``data/store.HostStaging``) and copied to the
card asynchronously.  With ``cache_size`` they come, with their AFC
tables, from the hot-group feature cache instead (``feature_cache.py``):
a batch's misses are gathered and built together, its hits copy nothing
from the host.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.analysis.contracts import assert_compile_contract
from repro_torch.core.executor_fused import (
    build_fused_executor,
    pipeline_executor_kwargs,
    shard_lanes_executor,
)
from repro_torch.core.pipeline import make_fused_model_fn
from repro_torch.data.store import HostStaging, bucket_size
from repro_torch.device import resolve_device
from repro_torch.serving.feature_cache import FeatureCache, pipeline_feature_cache

__all__ = [
    "BatchResult",
    "BatchedFusedServer",
    "chunked_straggler_report",
    "device_fill",
    "gather_lanes",
    "lane_request_inputs",
    "sanitize_lane_inputs",
    "straggler_report",
    "validate_serving_mesh",
]


def sanitize_lane_inputs(vals, exact, *, policy: str, where: str):
    """Police NaN/Inf in a lane's host-side inputs at the serving edge.

    A non-finite feature value entering the executor propagates through
    every power sum and megabatch evaluation of its lane.
    ``policy='reject'`` raises naming the offending buffer, feature row and
    position; ``policy='clamp'`` zeroes non-finite entries (0.0 is the
    store's neutral pad value, masked out by the estimators at the true
    prefix lengths).  ``vals`` may be ``None``.  Returns the (possibly
    rewritten) ``(vals, exact)``.
    """
    if policy not in ("reject", "clamp"):
        raise ValueError(
            f"{where}: unknown sanitize policy {policy!r} (expected 'reject' or 'clamp')"
        )
    out = []
    for name, buf in (("vals", vals), ("exact", exact)):
        if buf is None:
            out.append(None)
            continue
        buf = np.asarray(buf)
        bad = ~np.isfinite(buf)
        if not bad.any():
            out.append(buf)
            continue
        if policy == "reject":
            pos = tuple(int(x) for x in np.argwhere(bad)[0])
            raise ValueError(
                f"{where}: non-finite value {float(buf[pos])!r} in request {name} buffer at "
                f"{pos} (sanitize='reject'; use sanitize='clamp' to coerce, or fix the store "
                f"column)"
            )
        buf = buf.copy()
        buf[bad] = 0.0
        out.append(buf)
    return tuple(out)


def validate_serving_mesh(mesh, lanes: int) -> int:
    """Validate a serving mesh against a fixed lane count; returns its size.

    Shared by the fixed-lane and continuous servers, with the reference's
    rules: the mesh is 1-D, its axis is named ``lanes``, and it divides the
    lane count evenly.  ``None`` means unsharded (returns 1).
    """
    if mesh is None:
        return 1
    if not hasattr(mesh, "devices"):
        raise TypeError(f"a serving mesh has devices and axis_names; got {type(mesh).__name__} "
                        "(build one with launch.mesh.make_serving_mesh)")
    devices = np.asarray(mesh.devices, dtype=object)
    if devices.ndim != 1:
        raise ValueError(f"serving mesh must be 1-D over 'lanes', got shape {devices.shape}")
    names = tuple(getattr(mesh, "axis_names", ()))
    if names and names != ("lanes",):
        raise ValueError(f"serving mesh axis must be named 'lanes', got {names}; build it with "
                         "launch.mesh.make_serving_mesh")
    n_devices = int(devices.size)
    if lanes % n_devices != 0:
        raise ValueError(f"batch_size {lanes} must be divisible by the mesh's {n_devices} devices")
    return n_devices


def serving_devices(mesh, device) -> list[torch.device]:
    """The shards' devices (each resolved, so a card that is missing raises):
    the mesh's, or ``[device]`` without a mesh.  With a mesh ``device`` must
    be left out."""
    if mesh is None:
        return [resolve_device(device)]
    if device is not None:
        raise ValueError("pass the devices in the mesh, not device=, when a mesh is given")
    return [resolve_device(d) for d in mesh.devices]


def pipelines_on(pipeline, devices) -> dict:
    """The pipeline with its model on each distinct device: the pipeline
    itself, its model moved, on the first; a copy with a deep copy of the
    model on every other, made once.  Shards on one device share it (it is
    only read)."""
    out = {}
    for d in devices:
        if d not in out:
            p = pipeline if not out else dataclasses.replace(
                pipeline, model=copy.deepcopy(pipeline.model))
            p.model.to(d)
            out[d] = p
    return out


def gather_lanes(pipeline, store, requests: list[dict], cap: int, lanes: int,
                 staging: HostStaging, *, policy: str, where: str | None = None):
    """The uncached lane inputs of a batch at a cap bucket, on the host.

    The requests' padded prefixes go into ``staging``'s buffer for the
    shape, zeros in the pad lanes, and are sanitized in place with their
    exact features (``sanitize_lane_inputs``).  Returns ``(vals (lanes, k,
    cap) f32 staging buffer, n (lanes, k) i32 clamped, exact (lanes, e)
    f32)``; the caller releases ``vals`` (``HostStaging.release``) once
    the copies that read it are enqueued.  A sanitizer error names
    ``where`` (default: ``serve_batch lane <i>``).
    """
    vals = staging.gather(store, [pipeline.agg_specs(req) for req in requests], cap, rows=lanes)
    arr = vals.numpy()
    ns = np.zeros((lanes, pipeline.k), np.int32)
    exacts = np.zeros((lanes, len(pipeline.exact_features)), np.float32)
    for i, req in enumerate(requests):
        ns[i] = store.request_sizes(pipeline.agg_specs(req), cap)
        lane = arr[i]
        clean, exacts[i] = sanitize_lane_inputs(
            lane, pipeline.exact_feature_values(store, req), policy=policy,
            where=f"serve_batch lane {i}" if where is None else where)
        if clean is not lane:
            lane[...] = clean
    return vals, ns, exacts


class BatchResult(NamedTuple):
    y_hat: np.ndarray
    prob: np.ndarray
    iters: np.ndarray        # (R,) per-request planner iterations (active lanes)
    sample_frac: np.ndarray  # samples touched / TRUE group rows (paper §4)
    batch_iters: int         # the batch's loop trips = max(iters)
    cap: int                 # bucketed buffer cap used for this batch
    lanes: int               # padded lane count
    z: np.ndarray | None = None  # (R, k) final per-request plans (active lanes)
    n_devices: int = 1       # devices the lanes ran on


def device_fill(fill: int, lanes: int, n_devices: int) -> np.ndarray:
    """Active lanes per device for a front-packed fill of a batch whose lanes
    partition contiguously over ``n_devices``: ``clip(fill − d·L/D, 0, L/D)``
    on device ``d``.  Returns the (n_devices,) int array."""
    if lanes % max(n_devices, 1) != 0:
        raise ValueError(f"lanes {lanes} not divisible by n_devices {n_devices}")
    per_dev = lanes // max(n_devices, 1)
    d = np.arange(max(n_devices, 1))
    return np.clip(fill - d * per_dev, 0, per_dev).astype(np.int64)


def straggler_report(res: BatchResult) -> dict:
    """How much the batch paid for its slowest request.

    ``wasted_iters[i]`` counts the loop trips request i sat through after
    its own loop ended (predicated no-ops that still cost an evaluation of
    the shared step); ``wasted_frac`` is their share of the active lanes'
    total.  Pad lanes never iterate and are left out; ``fill`` is the share
    of lanes that were active.  With ``n_devices > 1`` a lane waits only for
    the lanes of its own device.  An empty batch gives zeros and
    ``straggler == -1``.
    """
    iters = np.asarray(res.iters)
    n_dev = max(int(getattr(res, "n_devices", 1)), 1)
    lanes = max(int(res.lanes), 1)
    per_dev_fill = device_fill(iters.size, lanes, n_dev) / (lanes // n_dev)
    if iters.size == 0:
        return {
            "batch_iters": 0, "per_request_iters": iters, "wasted_iters": iters,
            "wasted_frac": 0.0, "straggler": -1, "cap": int(res.cap), "lanes": int(res.lanes),
            "fill": 0.0, "n_devices": n_dev, "per_device_fill": per_dev_fill,
            "lane_imbalance": 0.0,
        }
    dev_of = np.arange(iters.size) // (lanes // n_dev)
    dev_max = np.zeros(n_dev, iters.dtype)
    np.maximum.at(dev_max, dev_of, iters)
    wasted = dev_max[dev_of] - iters
    total = max(int(dev_max[dev_of].sum()), 1)
    return {
        "batch_iters": int(res.batch_iters),
        "per_request_iters": iters,
        "wasted_iters": wasted,
        "wasted_frac": float(wasted.sum()) / total,
        "straggler": int(np.argmax(iters)),
        "cap": int(res.cap),
        "lanes": int(res.lanes),
        "fill": float(len(iters)) / lanes,
        "n_devices": n_dev,
        "per_device_fill": per_dev_fill,
        "lane_imbalance": float(per_dev_fill.max() - per_dev_fill.min()),
    }


def lane_request_inputs(pipeline, store, req: dict, cap: int, staging: HostStaging, *,
                        policy: str = "reject", lane: int = 0):
    """One request's lane inputs at a cap bucket: the one-lane case of
    :func:`gather_lanes`, so the continuous refill and the fixed-lane batch
    feed the executor the same data (a precondition of recycling parity).

    Returns ``(vals (1, k, cap) f32 staging buffer, n (k,) i32 clamped,
    true_n (k,) i64, exact (e,) f32)``; sanitizer errors name ``admit lane
    <lane>``.  The caller releases ``vals`` once its copy is enqueued.
    """
    vals, ns, exacts = gather_lanes(pipeline, store, [req], cap, 1, staging, policy=policy,
                                    where=f"admit lane {lane}")
    return vals, ns[0], np.asarray(pipeline.group_sizes(store, req), np.int64), exacts[0]


def chunked_straggler_report(
    chunk_iters, occupied, *, lanes: int, n_devices: int = 1
) -> dict:
    """Chunk-granularity waste accounting for recycled lanes.

    With continuous batching a lane serves many requests per batch window
    and fills are NOT front-packed (a freed lane is refilled in place), so
    :func:`straggler_report`'s batch-global and :func:`device_fill`'s
    front-packed assumptions both break.  This report charges waste per
    **chunk** against each device block's chunk-boundary maximum: inputs
    are the (n_chunks, lanes) matrices of per-chunk planner-iteration
    counts and lane occupancy the scheduler records at every chunk
    boundary.

    ``wasted_iters[l]`` counts the loop trips lane ``l`` sat through beyond
    its own work while some co-resident lane on its device was still
    iterating — summed over chunks, so a lane recycled mid-window is only
    ever charged against the stragglers it ACTUALLY shared a dispatch with
    (the fixed-lane report would charge the whole batch window).
    ``per_device_fill`` / ``lane_imbalance`` are occupancy-true: mean
    occupied-lane fraction per device block over chunks, well-defined for
    any refill pattern and empty-safe (zero chunks -> zeros).
    """
    lanes = int(lanes)
    n_dev = max(int(n_devices), 1)
    if lanes % n_dev != 0:
        raise ValueError(f"lanes {lanes} not divisible by n_devices {n_dev}")
    per_dev = lanes // n_dev
    it = np.asarray(chunk_iters, np.int64).reshape(-1, lanes)
    occ = np.asarray(occupied, bool).reshape(-1, lanes)
    if it.shape != occ.shape:
        raise ValueError(
            f"chunk_iters {it.shape} and occupied {occ.shape} must align"
        )
    n_chunks = it.shape[0]
    if n_chunks == 0:
        return {
            "n_chunks": 0,
            "lanes": lanes,
            "n_devices": n_dev,
            "lane_occupancy": 0.0,
            "per_device_fill": [0.0] * n_dev,
            "lane_imbalance": 0.0,
            "wasted_iters": np.zeros(lanes, np.int64),
            "wasted_frac": 0.0,
            "total_iters": 0,
        }
    it = np.where(occ, it, 0)
    blk = it.reshape(n_chunks, n_dev, per_dev)
    occ_blk = occ.reshape(n_chunks, n_dev, per_dev)
    # each dispatch, a lane waits for its OWN device block's straggler —
    # the chunk-boundary device-block max, not the batch-window global max
    blk_max = blk.max(axis=2)                                   # (C, D)
    wasted = np.where(occ_blk, blk_max[:, :, None] - blk, 0)    # (C, D, L/D)
    charged = np.where(occ_blk, blk_max[:, :, None], 0)
    occ_frac = occ_blk.mean(axis=2)                             # (C, D)
    return {
        "n_chunks": int(n_chunks),
        "lanes": lanes,
        "n_devices": n_dev,
        "lane_occupancy": float(occ.mean()),
        "per_device_fill": [float(x) for x in occ_frac.mean(axis=0)],
        "lane_imbalance": float((occ_frac.max(1) - occ_frac.min(1)).mean()),
        "wasted_iters": wasted.reshape(n_chunks, lanes).sum(axis=0),
        "wasted_frac": float(wasted.sum()) / max(int(charged.sum()), 1),
        "total_iters": int(it.sum()),
    }


class BatchedFusedServer:
    """The fused executor over fixed-lane batches of requests, on ``device``.

    One slot per power-of-two cap bucket: batches are padded to exactly
    ``batch_size`` lanes (pad lanes never iterate), so the executor builds
    one set of programs per ``(batch_size, cap)``, captured as CUDA graphs
    on the card; ``compile_count`` and ``compiled_buckets`` make that
    observable.  ``max_cap`` lowers the store-wide buffer ceiling; groups
    larger than the cap are served from their first ``cap`` rows and
    ``sample_frac`` keeps the TRUE group size as its denominator.
    ``afc_backend`` goes to the executor; ``use_kernel=False`` runs the
    plain versions on the card and ``capture=False`` the eager programs
    (both for comparison only).

    ``cache_size`` turns on the hot-group feature cache (:attr:`cache`, an
    LRU of that many request shapes): every lane's buffers, sizes and AFC
    tables come from it, the executor runs ``prebuilt=True``, and pad lanes
    reuse the first request's entry.

    ``mesh`` (a 1-D ``("lanes",)`` mesh, ``launch.mesh.make_serving_mesh``)
    shards the lanes over its devices: lane ``i`` runs on shard ``i //
    (batch_size / D)`` with the model copied once onto each distinct
    device, and no program reads another shard's tensors.  A cap bucket is
    still one slot on every shard, whatever the fill or the shard count
    (``compile_count``; ``shard_compile_counts`` per shard).  A shard of L/D
    lanes gives each lane the plan and iterations it gets unsharded (a
    1-shard mesh is the unsharded server, bit for bit); ŷ and prob may round
    apart by lane count.  With a mesh, ``device`` is left out and
    ``cache_size`` raises, as in the reference.  :attr:`contract` names the
    registered contract(s) ``check_compile_contract`` asserts.
    """

    def __init__(self, bundle, config, batch_size: int = 8, max_cap: int | None = None,
                 mesh=None, afc_backend: str = "auto", cache_size: int | None = None,
                 sanitize: str = "reject", *, device=None, use_kernel: bool = True,
                 capture: bool | None = None):
        if sanitize not in ("reject", "clamp"):
            raise ValueError(f"sanitize must be 'reject' or 'clamp', got {sanitize!r}")
        self.batch_size = int(batch_size)
        self.n_devices = validate_serving_mesh(mesh, self.batch_size)
        if cache_size is not None and mesh is not None:
            raise ValueError("cache_size and mesh are mutually exclusive: cached lanes stack "
                             "cache entries of one device, sharded lanes live on their shards")
        devices = serving_devices(mesh, device)
        self.device = devices[0]
        self.mesh = mesh
        self.bundle = bundle
        self.config = config
        self.sanitize = sanitize
        if cache_size is not None:
            self.contract = ("fused_prebuilt", "afc_precompute")
        elif mesh is not None:
            self.contract = ("sharded_lanes",)
        else:
            self.contract = ("fused",)
        p = bundle.pipeline
        on = pipelines_on(p, devices)
        feat_kwargs = pipeline_executor_kwargs(p.agg_features, self.device)
        self._agg_ids = feat_kwargs.pop("agg_ids")

        def build(d):
            return build_fused_executor(
                make_fused_model_fn(on[d], d, use_kernel=use_kernel), k=p.k, task=p.task,
                n_classes=max(p.n_classes, 2), m=config.m, m_sobol=config.m_sobol,
                alpha=config.alpha, gamma=config.gamma, tau=config.tau,
                max_iters=config.max_iters, n_boot=config.n_bootstrap,
                afc_backend=afc_backend, device=d, use_kernel=use_kernel, capture=capture,
                prebuilt=cache_size is not None, **feat_kwargs,
            )

        self._run = build(self.device) if mesh is None else shard_lanes_executor(build, mesh)
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
        self._max_cap = bucket_size(max_n)  # store-wide ceiling
        if max_cap is not None:
            self._max_cap = min(self._max_cap, bucket_size(max_cap))

    @property
    def compiled_buckets(self) -> list[int]:
        """Cap buckets served so far."""
        return sorted(self._caps_seen)

    @property
    def compile_count(self) -> int:
        """Slots the executor built (on the card: captures of its three
        graphs), a bucket built on every shard counted once."""
        return self._run.slots_built

    @property
    def shard_compile_counts(self) -> list[int]:
        """Each shard's own slot count (empty without a mesh)."""
        return [] if self.mesh is None else self._run.shard_slots_built

    def check_compile_contract(self, *, buckets=None) -> None:
        """Assert the slot counts against :attr:`contract` (one slot a cap
        bucket, on every shard)."""
        assert_compile_contract(self, self.contract, buckets=buckets)

    def batch_cap(self, requests: list[dict]) -> int:
        """Power-of-two bucket over THIS batch's largest group."""
        p = self.bundle.pipeline
        max_n = max(int(p.group_sizes(self.bundle.store, req).max()) for req in requests)
        return min(bucket_size(max_n), self._max_cap)

    def serve_batch(self, requests: list[dict], knobs=None) -> BatchResult:
        """Serve a batch of 0..batch_size requests.

        The batch is padded to exactly ``batch_size`` lanes; results are
        sliced back to the real requests.  Oversize lists are rejected
        (callers chunk before dispatch).  ``knobs`` (optional, aligned with
        ``requests``) gives per-lane ``delta``, ``tau`` and ``iter_cap``
        (objects with those fields, such as the reference's ``LaneKnobs``),
        or ``None`` for the config's; ``iter_cap`` is clamped to
        ``max_iters``.  The knobs are data: they never build a slot.
        """
        p = self.bundle.pipeline
        store = self.bundle.store
        delta = self.config.delta if self.config.delta is not None else p.delta_default
        r = len(requests)
        if r > self.batch_size:
            raise ValueError(
                f"admission batch of {r} exceeds the fixed lane count {self.batch_size}; "
                "chunk before dispatch")
        if knobs is not None and len(knobs) != r:
            raise ValueError(f"knobs ({len(knobs)}) must align with requests ({r})")
        if r == 0:
            empty = np.zeros((0,), np.float32)
            return BatchResult(
                y_hat=empty, prob=empty, iters=np.zeros((0,), np.int32), sample_frac=empty,
                batch_iters=0, cap=0, lanes=self.batch_size, z=np.zeros((0, p.k), np.int32),
                n_devices=self.n_devices)
        lanes = self.batch_size
        cap = self.batch_cap(requests)
        true_ns = np.stack([np.asarray(p.group_sizes(store, req), np.int64) for req in requests])
        if self.cache is not None:
            # cached lanes: vals, n and tables stay on the device; pad lanes
            # reuse the first entry (active=False keeps them out)
            entries = self.cache.get_many([p.agg_specs(req) for req in requests], cap)
            entries += [entries[0]] * (lanes - r)
            exacts = np.zeros((lanes, len(p.exact_features)), np.float32)
            for i, req in enumerate(requests):
                exacts[i] = sanitize_lane_inputs(
                    None, p.exact_feature_values(store, req), policy=self.sanitize,
                    where=f"serve_batch lane {i}")[1]
        else:
            vals, ns, exacts = gather_lanes(p, store, requests, cap, lanes, self._staging,
                                            policy=self.sanitize)
        deltas = np.full((lanes,), delta, np.float32)
        taus = np.full((lanes,), self.config.tau, np.float32)
        caps = np.full((lanes,), self.config.max_iters, np.int32)
        for i, kn in enumerate(knobs or ()):
            if kn is not None:
                deltas[i], taus[i] = kn.delta, kn.tau
                caps[i] = min(int(kn.iter_cap), self.config.max_iters)
        self._caps_seen.add(cap)
        knob_args = (torch.from_numpy(np.arange(lanes) < r), torch.from_numpy(taus),
                     torch.from_numpy(caps))
        if self.cache is not None:
            res = self._run([e.vals for e in entries], [e.n for e in entries], self._agg_ids,
                            torch.from_numpy(deltas), torch.from_numpy(exacts),
                            [e.tables for e in entries], *knob_args)
        else:
            res = self._run(vals, torch.from_numpy(ns), self._agg_ids, torch.from_numpy(deltas),
                            torch.from_numpy(exacts), *knob_args)
            self._staging.release(vals)
        iters = res.iters.cpu().numpy()[:r]
        return BatchResult(
            y_hat=res.y_hat.cpu().numpy()[:r],
            prob=res.prob.cpu().numpy()[:r],
            iters=iters,
            # paper §4 sample fraction: touched rows over TRUE group rows
            sample_frac=res.samples_used.cpu().numpy()[:r] / np.maximum(true_ns.sum(1), 1),
            batch_iters=int(iters.max(initial=0)),
            cap=cap,
            lanes=lanes,
            z=res.z.cpu().numpy()[:r],
            n_devices=self.n_devices,
        )
