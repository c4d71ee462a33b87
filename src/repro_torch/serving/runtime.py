"""Arrival-driven serving runtime: queue → admission → fixed-lane or continuous dispatch.

Port of ``repro/serving/runtime.py``.  Real load is a timestamped arrival
process, not a list; this module serves one:

* a FIFO **request queue** fed by timestamped arrivals (Poisson traces from
  ``repro_torch.data.synthetic.poisson_arrivals``);
* an **admission batcher** with the max-wait / max-size policy: a batch
  launches when ``max_batch`` requests wait, the oldest has waited
  ``max_wait_s``, or the trace is drained;
* **fixed-lane dispatch** (:class:`ServingRuntime` over
  :class:`~repro_torch.serving.batched.BatchedFusedServer`): every batch is
  padded to the server's ``batch_size`` lanes, so the executor builds one
  slot (on the card, one capture) per cap bucket whatever the fill;
* **continuous batching** (:class:`ContinuousServingRuntime` over
  :class:`~repro_torch.serving.continuous.ContinuousBatchedServer`): lanes
  freed at a chunk boundary are refilled from the queue;
* per-request **queueing delay vs execution latency** records.

Deadlines (``Arrival.slo_s`` or the runtime's ``slo_s``) and a
:class:`~repro_torch.serving.degrade.DegradationController` map each
admitted request's remaining budget and the queue depth to a knob tier
(δ, τ and the iteration cap are per-lane inputs, so a tier change builds
no slot); requests no tier can serve in time are **shed**; transient
executor failures (:class:`~repro_torch.serving.faults.TransientExecutorError`)
are retried with bounded exponential backoff on the virtual clock.

Time model: arrivals and queueing evolve on a *virtual* clock (a trace
replays identically whatever the host's speed), and each dispatch is
charged its measured wall time.  Every measured dispatch ends in a
read-back to the host (``serve_batch``'s results, or the lane table's
``readback``), so the clock counts the card's time to do the work, not the
time to enqueue it.  Backoff delays are virtual (added, never slept).
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serving.batched import (
    BatchedFusedServer,
    chunked_straggler_report,
    device_fill,
)
from repro_torch.serving.continuous import ContinuousBatchedServer
from repro_torch.serving.degrade import DegradationController
from repro_torch.serving.faults import TransientExecutorError

__all__ = [
    "Arrival",
    "RequestRecord",
    "AdmissionBatcher",
    "RuntimeStats",
    "ServingRuntime",
    "ContinuousServingRuntime",
]


@dataclass(frozen=True)
class Arrival:
    """A timestamped request: ``t`` seconds on the virtual arrival clock.

    ``slo_s`` is the request's latency budget (its deadline is ``t +
    slo_s``); ``None`` defers to the runtime-wide default (which may also
    be ``None`` — no deadline, never shed).
    """

    t: float
    request: dict
    slo_s: float | None = None


@dataclass(frozen=True)
class RequestRecord:
    """Per-request accounting emitted by the runtime.

    ``disposition`` is ``"ok"`` (served), ``"shed"`` (rejected at admission
    because no degradation tier could meet its deadline, or the queue hit
    its bound), ``"failed"`` (its batch exhausted transient-failure
    retries), or ``"poisoned"`` (continuous only: its lane failed the
    post-chunk numerical-health check and exhausted its bounded
    re-admission attempts).  Shed/failed/
    poisoned records carry ``y_hat = nan`` and ``batch_id = -1`` / the
    failed batch id; latency for a shed request is the time it spent queued
    before the runtime gave up on it.  ``tier``/``tau``/
    ``delta`` echo the degradation knobs the request was served under
    (baseline values when no controller is installed) so the summary's
    guarantee rate can be computed against the tau each request was
    actually promised.

    Continuous batching (:class:`ContinuousServingRuntime`) reinterprets
    the batch-granularity fields at chunk granularity: ``admit_t`` is the
    time the request entered a LANE (queue-delay = time-to-first-lane),
    ``exec_s`` the lane-resident wall time (the request spans multiple
    chunk dispatches), ``batch_id`` the admission-event index and
    ``batch_fill`` the occupied-lane count right after it.  ``lane`` /
    ``n_chunks`` record where it ran and how many chunk dispatches it
    spanned (fixed-lane records keep the ``-1`` / ``0`` defaults), and
    ``z`` the final per-feature plan — the recycling-parity tests compare
    it bitwise against a serial replay.
    """

    req_id: int
    arrival_t: float
    admit_t: float          # when its admission batch started executing
    done_t: float
    queue_delay_s: float    # admit_t - arrival_t  (the batching cost)
    exec_s: float           # its batch's wall-clock service time
    latency_s: float        # done_t - arrival_t   (what the user sees)
    batch_id: int
    batch_fill: int         # active lanes in its batch
    y_hat: float
    prob: float
    iters: int
    sample_frac: float
    deadline_t: float = math.inf
    disposition: str = "ok"
    tier: int = 0
    tau: float | None = None     # the confidence target it was served under
    delta: float | None = None   # the error bound it was served under
    deadline_met: bool = True
    lane: int = -1               # lane it ran in (continuous; -1 = fixed-lane)
    n_chunks: int = 0            # chunk dispatches it spanned (continuous)
    z: tuple | None = None       # final per-feature plan (continuous)


class AdmissionBatcher:
    """max-wait / max-size admission policy (pure, for unit testing)."""

    # tolerance for "the wait expired": the runtime advances its clock to
    # ``t_oldest + max_wait_s`` and recomputes ``now - t_oldest``, which can
    # round to just under max_wait_s — without the epsilon that state admits
    # nothing and the virtual clock stops advancing (a livelock).
    _EPS = 1e-9

    def __init__(self, max_size: int, max_wait_s: float):
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        if max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        self.max_size = max_size
        self.max_wait_s = max_wait_s

    def ready(self, queue_len: int, oldest_wait_s: float, more_coming: bool) -> bool:
        """Admit now?  Full batch, expired wait, or a drained trace."""
        if queue_len <= 0:
            return False
        return (
            queue_len >= self.max_size
            or oldest_wait_s >= self.max_wait_s - self._EPS
            or not more_coming
        )


@dataclass
class RuntimeStats:
    """Everything one load run produced; ``summary()`` is the §4-style table.

    ``tau`` is the server's baseline confidence target and is required:
    the summary judges each request against its own tau (the target it was
    served under) and falls back to this one only for records without.
    """

    tau: float
    records: list[RequestRecord] = field(default_factory=list)
    makespan_s: float = 0.0     # first arrival -> last completion (virtual)
    busy_s: float = 0.0         # total wall time spent in measured dispatches
    n_batches: int = 0
    compile_count: int = 0      # slots built DURING the run (post-warmup)
    compiled_buckets: list[int] = field(default_factory=list)
    n_devices: int = 1          # cards the lanes ran on
    lanes: int = 0              # fixed lane count (0 = unknown/legacy)
    n_shed: int = 0             # rejected at admission (deadline/queue bound)
    n_failed: int = 0           # batches' requests that exhausted retries
    n_retries: int = 0          # transient-failure retries (backoff events)
    n_rollbacks: int = 0        # chunk-boundary checkpoint restores (continuous)
    n_poisoned: int = 0         # lanes quarantined past their re-admission bound
    n_chunks: int = 0           # chunk dispatches (continuous; 0 = fixed-lane)
    n_recycles: int = 0         # admissions into a previously-used lane
    lane_occupancy: float = 0.0  # mean occupied-lane fraction over chunks
    chunk_stats: dict = field(default_factory=dict)  # chunked_straggler_report

    def _device_fill_stats(self) -> dict:
        """Per-device fill + lane imbalance, averaged over admission batches.

        Lanes partition contiguously over the 1-D serving mesh and fills are
        front-packed, so a batch's fill determines each device's active-lane
        count (``batched.device_fill``).  Reported only when the mesh has
        more than one device — a single-device run has nothing to split —
        and well-defined (zeros) on an empty record set OR when the lane
        count is unknown (``lanes == 0``: a hand-built stats object) — a
        guessed partition would fabricate balance numbers.  Shed records
        never reached a batch (``batch_id == -1``) and are excluded.

        Continuous runs override the front-packed guess entirely: recycled
        lanes are refilled IN PLACE (any occupancy pattern), so the numbers
        come from the occupancy matrix (``chunked_straggler_report``) — the
        well-defined accounting when a lane serves many requests per
        window.
        """
        if self.chunk_stats:
            return {
                "per_device_fill": [
                    float(x) for x in self.chunk_stats["per_device_fill"]
                ],
                "mean_lane_imbalance": float(
                    self.chunk_stats["lane_imbalance"]
                ),
            }
        fills = {
            r.batch_id: r.batch_fill for r in self.records if r.batch_id >= 0
        }
        if not fills or not self.lanes:
            return {
                "per_device_fill": [0.0] * self.n_devices,
                "mean_lane_imbalance": 0.0,
            }
        lanes = self.lanes
        per_dev = np.stack(
            [
                device_fill(f, lanes, self.n_devices) / (lanes // self.n_devices)
                for f in fills.values()
            ]
        )  # (batches, n_devices) fill fractions
        return {
            "per_device_fill": [float(x) for x in per_dev.mean(0)],
            "mean_lane_imbalance": float(
                (per_dev.max(1) - per_dev.min(1)).mean()
            ),
        }

    def summary(self) -> dict:
        served = [r for r in self.records if r.disposition == "ok"]
        n = len(served)
        n_offered = len(self.records)
        device = (
            {"n_devices": self.n_devices, **self._device_fill_stats()}
            if self.n_devices > 1
            else {"n_devices": self.n_devices}
        )
        degrade = {
            "n_offered": n_offered,
            "n_shed": int(self.n_shed),
            "n_failed": int(self.n_failed),
            "n_retries": int(self.n_retries),
            "n_rollbacks": int(self.n_rollbacks),
            "n_poisoned": int(self.n_poisoned),
            "shed_rate": float(self.n_shed / n_offered) if n_offered else 0.0,
        }
        with_deadline = [r for r in self.records if math.isfinite(r.deadline_t)]
        degrade["deadline_met_rate"] = (
            float(np.mean([r.deadline_met for r in with_deadline]))
            if with_deadline
            else float("nan")
        )
        continuous = (
            {
                "n_chunks": int(self.n_chunks),
                "n_recycles": int(self.n_recycles),
                "lane_occupancy": float(self.lane_occupancy),
                "chunk_wasted_frac": float(
                    self.chunk_stats.get("wasted_frac", 0.0)
                ),
            }
            if self.chunk_stats  # set by every continuous run, even 0-chunk
            else {}
        )
        if n == 0:
            return {
                "n": 0,
                "throughput_rps": 0.0,
                "p50_latency_ms": float("nan"),
                "p99_latency_ms": float("nan"),
                "mean_latency_ms": float("nan"),
                "mean_queue_delay_ms": float("nan"),
                "p99_queue_delay_ms": float("nan"),
                "mean_exec_ms": float("nan"),
                "mean_batch_fill": 0.0,
                "n_batches": 0,
                "utilization": 0.0,
                "mean_sample_frac": float("nan"),
                "guarantee_rate": 0.0,
                "mean_tier": 0.0,
                "max_tier": 0,
                "compile_count": int(self.compile_count),
                "compiled_buckets": list(self.compiled_buckets),
                **degrade,
                **continuous,
                **device,
            }
        lat = np.array([r.latency_s for r in served]) * 1e3
        qd = np.array([r.queue_delay_s for r in served]) * 1e3
        ex = np.array([r.exec_s for r in served]) * 1e3
        fill = np.array([r.batch_fill for r in served], np.float64)
        frac = np.array([r.sample_frac for r in served])
        prob = np.array([r.prob for r in served])
        # the guarantee each request was SERVED under: its own (possibly
        # degraded) tau, falling back to the baseline for legacy records
        taus = np.array(
            [self.tau if r.tau is None else r.tau for r in served]
        )
        tiers = np.array([r.tier for r in served])
        span = max(self.makespan_s, 1e-12)
        return {
            "n": n,
            "throughput_rps": n / span,
            "p50_latency_ms": float(np.percentile(lat, 50)),
            "p99_latency_ms": float(np.percentile(lat, 99)),
            "mean_latency_ms": float(lat.mean()),
            "mean_queue_delay_ms": float(qd.mean()),
            "p99_queue_delay_ms": float(np.percentile(qd, 99)),
            "mean_exec_ms": float(ex.mean()),
            "mean_batch_fill": float(fill.mean()),
            "n_batches": int(self.n_batches),
            "utilization": float(self.busy_s / span),
            # the paper's §4 quality metrics, so the CLI table is comparable
            # across host / fused / fused-batched modes (a request also counts
            # as satisfied when it provably exhausted its groups); under
            # degradation each request is judged against ITS OWN tau
            "mean_sample_frac": float(frac.mean()),
            "guarantee_rate": float(
                np.mean((prob >= taus) | (frac >= 0.999))
            ),
            "mean_tier": float(tiers.mean()),
            "max_tier": int(tiers.max(initial=0)),
            "compile_count": int(self.compile_count),
            "compiled_buckets": list(self.compiled_buckets),
            **degrade,
            **continuous,
            **device,
        }


class ServingRuntime:
    """Single-server arrival loop over a :class:`BatchedFusedServer`.

    ``slo_s`` attaches a default latency budget to arrivals that carry none;
    ``controller`` (a :class:`~repro_torch.serving.degrade.DegradationController`)
    enables deadline-driven knob scaling and load shedding.  Transient
    executor failures are retried up to ``max_retries`` times with
    exponential backoff (``backoff_s · 2^attempt``, virtual-clock) before
    the batch's requests are recorded as ``failed``.
    """

    def __init__(
        self,
        server: BatchedFusedServer,
        max_wait_s: float = 0.05,
        max_batch: int | None = None,
        *,
        slo_s: float | None = None,
        controller: DegradationController | None = None,
        max_retries: int = 2,
        backoff_s: float = 0.02,
    ):
        self.server = server
        max_batch = max_batch if max_batch is not None else server.batch_size
        if max_batch > server.batch_size:
            raise ValueError(
                f"max_batch {max_batch} exceeds the server's fixed lane count "
                f"{server.batch_size}"
            )
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if backoff_s < 0:
            raise ValueError("backoff_s must be >= 0")
        self.batcher = AdmissionBatcher(max_batch, max_wait_s)
        self.slo_s = slo_s
        self.controller = controller
        self.max_retries = max_retries
        self.backoff_s = backoff_s

    # ------------------------------------------------------------------
    def warmup(self, requests: list[dict] | None = None) -> list[int]:
        """Build (on the card: capture) every cap bucket the requests can hit.

        A mixed batch's cap is ``bucket(max group)`` = the max of its
        members' single-request caps, so warming one full-lane batch per
        distinct per-request cap covers every batch composition.  Returns
        the warmed buckets.
        """
        reqs = requests if requests is not None else self.server.bundle.requests
        by_cap: dict[int, dict] = {}
        for req in reqs:
            by_cap.setdefault(self.server.batch_cap([req]), req)
        already = set(self.server.compiled_buckets)
        for cap in sorted(by_cap):
            if cap not in already:  # a warm bucket is not paid again
                self.server.serve_batch([by_cap[cap]])
        return sorted(by_cap)

    # ------------------------------------------------------------------
    def _default_delta(self) -> float:
        cfg, p = self.server.config, self.server.bundle.pipeline
        return cfg.delta if cfg.delta is not None else p.delta_default

    def _serve_with_retries(self, requests, make_knobs, stats, now):
        """serve_batch under the bounded-retry/backoff policy.

        ``make_knobs(now)`` builds the per-lane knob list for the CURRENT
        virtual clock (or None without a controller) and is re-invoked after
        every backoff, so a request that burned deadline budget on retries
        is re-tiered against its post-retry slack — retries and degradation
        stay coherent instead of serving late at full accuracy.

        Returns ``(result_or_None, knobs_used, new_now)``; failed attempts
        charge their real wall time to ``busy_s``/the virtual clock, and
        each retry adds an exponential virtual backoff delay (never slept —
        deterministic replay).  ``None`` means retries were exhausted.
        """
        attempt = 0
        knobs = make_knobs(now)
        while True:
            t0 = time.perf_counter()
            try:
                if knobs is None:
                    res = self.server.serve_batch(requests)
                else:
                    res = self.server.serve_batch(requests, knobs=knobs)
            except TransientExecutorError:
                dt = time.perf_counter() - t0
                now += dt
                stats.busy_s += dt
                if attempt >= self.max_retries:
                    return None, knobs, now
                now += self.backoff_s * (2.0**attempt)
                attempt += 1
                stats.n_retries += 1
                knobs = make_knobs(now)  # post-retry slack, re-priced
                continue
            dt = time.perf_counter() - t0
            return (res, dt), knobs, now

    # ------------------------------------------------------------------
    def run(self, arrivals, warmup: bool = True) -> RuntimeStats:
        """Replay a timestamped arrival trace; returns per-request records.

        ``arrivals``: iterable of :class:`Arrival`, ``(t, request)`` or
        ``(t, request, slo_s)`` tuples (seconds on the virtual clock; sorted
        internally).
        """
        arr = sorted(
            (
                a if isinstance(a, Arrival) else Arrival(float(a[0]), *a[1:])
                for a in arrivals
            ),
            key=lambda a: a.t,
        )
        if warmup:
            self.warmup([a.request for a in arr])
        compiles_before = self.server.compile_count

        stats = RuntimeStats(
            tau=self.server.config.tau,
            n_devices=self.server.n_devices,
            lanes=self.server.batch_size,
        )
        if not arr:
            stats.compiled_buckets = self.server.compiled_buckets
            return stats

        deadlines = [
            a.t + a.slo_s
            if a.slo_s is not None
            else (a.t + self.slo_s if self.slo_s is not None else math.inf)
            for a in arr
        ]
        base_delta = self._default_delta()
        ctl = self.controller

        records: list[RequestRecord | None] = [None] * len(arr)
        queue: deque[int] = deque()
        now = arr[0].t
        i = 0
        batch_id = 0
        while i < len(arr) or queue:
            if not queue:
                now = max(now, arr[i].t)
            while i < len(arr) and arr[i].t <= now:
                queue.append(i)
                i += 1
            oldest_wait = now - arr[queue[0]].t
            if not self.batcher.ready(len(queue), oldest_wait, i < len(arr)):
                # idle until the next decision point: the oldest request's
                # max-wait deadline or the next arrival, whichever is first
                # (both are strictly > now, so the loop always progresses)
                now = min(arr[queue[0]].t + self.batcher.max_wait_s, arr[i].t)
                continue
            # ---- admission: shed infeasible requests, then fill the batch
            idxs: list[int] = []
            while queue and len(idxs) < self.batcher.max_size:
                j = queue[0]
                slack = (
                    deadlines[j] - now
                    if math.isfinite(deadlines[j])
                    else None
                )
                if ctl is not None and ctl.should_shed(slack, len(queue)):
                    queue.popleft()
                    records[j] = RequestRecord(
                        req_id=j,
                        arrival_t=arr[j].t,
                        admit_t=now,
                        done_t=now,
                        queue_delay_s=now - arr[j].t,
                        exec_s=0.0,
                        latency_s=now - arr[j].t,
                        batch_id=-1,
                        batch_fill=0,
                        y_hat=float("nan"),
                        prob=0.0,
                        iters=0,
                        sample_frac=0.0,
                        deadline_t=deadlines[j],
                        disposition="shed",
                        tier=len(ctl.tiers) - 1,
                        deadline_met=False,
                    )
                    stats.n_shed += 1
                    continue
                queue.popleft()
                idxs.append(j)
            if not idxs:
                continue  # everything was shed; rerun the admission decision
            # ---- knob assignment: remaining budget + congestion -> tier.
            # Built as a closure over the batch so the retry path can
            # re-price each request's slack after every virtual backoff.
            depth = len(queue)  # still-waiting requests behind this batch

            def make_knobs(t, idxs=idxs, depth=depth):
                if ctl is None:
                    return None
                return [
                    ctl.retier(
                        deadlines[j] - t
                        if math.isfinite(deadlines[j])
                        else None,
                        depth,
                        base_delta,
                    )
                    for j in idxs
                ]

            admit_t = now
            out, knobs, now = self._serve_with_retries(
                [arr[j].request for j in idxs], make_knobs, stats, now
            )
            if out is None:  # retries exhausted: the whole batch failed
                for lane, j in enumerate(idxs):
                    kn = knobs[lane] if knobs is not None else None
                    records[j] = RequestRecord(
                        req_id=j,
                        arrival_t=arr[j].t,
                        admit_t=admit_t,
                        done_t=now,
                        queue_delay_s=admit_t - arr[j].t,
                        exec_s=0.0,
                        latency_s=now - arr[j].t,
                        batch_id=batch_id,
                        batch_fill=len(idxs),
                        y_hat=float("nan"),
                        prob=0.0,
                        iters=0,
                        sample_frac=0.0,
                        deadline_t=deadlines[j],
                        disposition="failed",
                        tier=kn.tier if kn is not None else 0,
                        tau=kn.tau if kn is not None else None,
                        delta=kn.delta if kn is not None else None,
                        deadline_met=False,
                    )
                    stats.n_failed += 1
                batch_id += 1
                if ctl is not None:
                    ctl.observe(ctl.service_est_s, len(queue))
                continue
            res, dt = out
            now += dt
            stats.busy_s += dt
            for lane, j in enumerate(idxs):
                kn = knobs[lane] if knobs is not None else None
                records[j] = RequestRecord(
                    req_id=j,
                    arrival_t=arr[j].t,
                    admit_t=admit_t,
                    done_t=now,
                    queue_delay_s=admit_t - arr[j].t,
                    exec_s=dt,
                    latency_s=now - arr[j].t,
                    batch_id=batch_id,
                    batch_fill=len(idxs),
                    y_hat=float(res.y_hat[lane]),
                    prob=float(res.prob[lane]),
                    iters=int(res.iters[lane]),
                    sample_frac=float(res.sample_frac[lane]),
                    deadline_t=deadlines[j],
                    disposition="ok",
                    tier=kn.tier if kn is not None else 0,
                    tau=kn.tau if kn is not None else None,
                    delta=kn.delta if kn is not None else None,
                    deadline_met=bool(now <= deadlines[j]),
                )
            batch_id += 1
            if ctl is not None:
                # post-batch feedback: EWMA the measured service time and
                # step the hysteretic load tier from the residual queue
                ctl.observe(dt, len(queue))

        stats.records = [r for r in records if r is not None]
        stats.makespan_s = now - arr[0].t
        stats.n_batches = batch_id
        stats.compile_count = self.server.compile_count - compiles_before
        stats.compiled_buckets = self.server.compiled_buckets
        return stats


def _carry_in_range(out: dict, lane: int, cap: int) -> bool:
    """Whether a lane's plan and iteration count can index the device
    tables: ``0 <= z <= cap`` and ``it >= 0``."""
    z = np.asarray(out["z"][lane])
    return bool((z >= 0).all() and (z <= cap).all() and out["it"][lane] >= 0)


class ContinuousServingRuntime:
    """Chunk-granularity lane-table scheduler (continuous batching).

    Drives a :class:`~repro_torch.serving.continuous.ContinuousBatchedServer`:
    instead of admitting a batch and holding every lane until the slowest
    request exits, the runtime dispatches the chunked executor —
    ``chunk_iters`` planner iterations at a time — and at every chunk
    boundary refills lanes whose requests converged with the next requests
    from the queue (iteration-level lane recycling).  There is no max-wait
    admission batcher: a request waits exactly until a lane frees up
    (queue-delay = time-to-first-lane).

    Accounting is per chunk, not per batch: each request's
    :class:`RequestRecord` spans the chunks it was lane-resident for
    (``exec_s`` = lane-resident wall time, ``n_chunks``/``lane`` recorded),
    ``RuntimeStats`` gains ``n_chunks`` / ``n_recycles`` /
    ``lane_occupancy``, and straggler waste is charged per chunk against
    the chunk-boundary device-block maxima
    (``batched.chunked_straggler_report`` over the recorded occupancy and
    per-chunk-iteration matrices).

    SLO-aware degradation composes at the right time scale:
    shed/tier decisions are re-evaluated when a request is admitted INTO A
    LANE — with its remaining deadline slack and the queue depth at that
    boundary — not when it joined the queue; the knobs ride the refill
    dispatch as per-lane inputs, so tier changes build no slot.
    The controller's ``observe`` feedback runs per chunk (service estimate
    = EWMA of chunk wall time).

    Time model matches :class:`ServingRuntime`: virtual arrival clock,
    measured wall time for every admission and chunk, each ending in the
    table's read-back.

    Fault tolerance: before every chunk dispatch the runtime snapshots the
    table's chunk carry (``server.snapshot``: host copies of the small
    leaves, no slot); a
    :class:`~repro_torch.serving.faults.TransientExecutorError` rolls the
    carry back to that chunk boundary, in place (onto the wreck a
    :class:`~repro_torch.serving.faults.ChunkDispatchError` hands back, when it
    does) and replays — bitwise-identical to a fault-free run, because the
    bootstrap RNG is counter-based on the restored per-request iteration
    index.  Admissions are idempotent (same re-init, same counters), so a
    failed ``admit`` is simply retried whole, with each assignment's knobs
    re-priced against its post-retry slack.  After every successful chunk a
    numerical-health check runs over the occupied lanes (NaN/Inf in
    ``y_hat``/``prob``, z outside ``[0, cap]`` or regressing vs the
    monotone-growth invariant, a ``done`` flag the knobs cannot explain);
    unhealthy lanes are quarantined INDIVIDUALLY — the request is re-queued
    for up to ``poison_retries`` full re-admissions (a re-init resets all
    lane state) and recorded ``disposition="poisoned"`` past that bound —
    while every other lane's carry proceeds untouched.  When chunk retries
    are exhausted, the lane-resident requests are recorded ``failed`` and
    their lanes cleared, so a dead device costs its residents — never the
    table, the queue, or the cache.  Every wrecked carry is restored or
    cleared before the next replay reads it (an unoccupied lane's too): on
    the card an index out of range is a device fault, not a clamp.
    """

    def __init__(
        self,
        server: ContinuousBatchedServer,
        *,
        slo_s: float | None = None,
        controller: DegradationController | None = None,
        max_retries: int = 2,
        backoff_s: float = 0.02,
        poison_retries: int = 1,
    ):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if backoff_s < 0:
            raise ValueError("backoff_s must be >= 0")
        if poison_retries < 0:
            raise ValueError("poison_retries must be >= 0")
        self.server = server
        self.slo_s = slo_s
        self.controller = controller
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.poison_retries = poison_retries

    # ------------------------------------------------------------------
    def warmup(self, requests: list[dict] | None = None) -> list[int]:
        """Build (on the card: capture) the refill and table slots of the
        trace's cap bucket.

        A continuous run serves its whole trace from ONE table at the
        trace-wide max cap bucket, so warming that bucket (one admission and
        one chunk, read back) covers the run.  Returns the warmed bucket.
        """
        reqs = requests if requests is not None else self.server.bundle.requests
        cap = self.server.trace_cap(reqs)
        if cap in self.server.compiled_buckets:
            return [cap]
        table = self.server.new_table(cap)
        table, _ = self.server.admit(table, cap, [(0, reqs[0], None)])
        self.server.readback(self.server.run_chunk(table))
        return [cap]

    def _default_delta(self) -> float:
        cfg, p = self.server.config, self.server.bundle.pipeline
        return cfg.delta if cfg.delta is not None else p.delta_default

    def _lane_health(self, out, lane, prev_z_lane, cap, kn) -> str | None:
        """Post-chunk numerical-health verdict for one occupied lane.

        Returns a reason string when the lane's carry violates an invariant
        a healthy executor cannot: non-finite ``y_hat``/``prob``, a
        guarantee probability outside [0, 1], a plan outside ``[0, cap]``
        or shrinking against the monotone-growth invariant, or a ``done``
        flag the knobs cannot explain (guarantee unmet, groups unexhausted,
        iterations left).  ``None`` = healthy.
        """
        y = float(out["y_hat"][lane])
        p = float(out["prob"][lane])
        if not (math.isfinite(y) and math.isfinite(p)):
            return "non-finite y_hat/prob"
        if not (0.0 <= p <= 1.0 + 1e-6):
            return f"prob {p} outside [0, 1]"
        z = np.asarray(out["z"][lane])
        if (z < 0).any() or (z > cap).any():
            return "z outside [0, cap]"
        if (z < prev_z_lane).any():
            return "z regression (monotone-growth invariant)"
        if bool(out["done"][lane]):
            cfg = self.server.config
            tau = float(kn.tau) if kn is not None else float(cfg.tau)
            iter_cap = (
                int(kn.iter_cap) if kn is not None else int(cfg.max_iters)
            )
            exhausted = bool(
                (z >= np.minimum(np.asarray(out["n"][lane]), cap)).all()
            )
            if (
                p < tau - 1e-6
                and not exhausted
                and int(out["it"][lane]) < iter_cap
            ):
                return "done flag inconsistent with the guarantee"
        return None

    # ------------------------------------------------------------------
    def run(self, arrivals, warmup: bool = True) -> RuntimeStats:
        """Replay a timestamped arrival trace through the lane table."""
        arr = sorted(
            (
                a if isinstance(a, Arrival) else Arrival(float(a[0]), *a[1:])
                for a in arrivals
            ),
            key=lambda a: a.t,
        )
        stats = RuntimeStats(
            tau=self.server.config.tau,
            n_devices=self.server.n_devices,
            lanes=self.server.batch_size,
        )
        if not arr:
            stats.compiled_buckets = self.server.compiled_buckets
            return stats
        if warmup:
            self.warmup([a.request for a in arr])
        compiles_before = self.server.compile_count

        deadlines = [
            a.t + a.slo_s
            if a.slo_s is not None
            else (a.t + self.slo_s if self.slo_s is not None else math.inf)
            for a in arr
        ]
        base_delta = self._default_delta()
        ctl = self.controller
        lanes = self.server.batch_size
        cap = self.server.trace_cap([a.request for a in arr])
        table = self.server.new_table(cap)

        records: list[RequestRecord | None] = [None] * len(arr)
        queue: deque[int] = deque()
        # lane bookkeeping is HOST state: the device table never learns
        # which request a lane holds, only its buffers and carry
        occupied: list[int | None] = [None] * lanes
        admit_ts = [0.0] * lanes
        admit_ids = [0] * lanes      # admission-event index -> batch_id
        admit_fill = [0] * lanes     # occupied lanes right after admission
        knobs_by_lane = [None] * lanes
        chunks_by_lane = [0] * lanes
        true_rows = [1] * lanes
        lane_used = [False] * lanes
        prev_it = np.zeros(lanes, np.int64)
        # monotone-z tracking for the post-chunk health check: each occupied
        # lane's plan at its last healthy boundary (set from z⁰ at admission)
        prev_z = np.zeros((lanes, self.server.bundle.pipeline.k), np.int64)
        poison_attempts: dict[int, int] = {}
        occ_rows: list[np.ndarray] = []
        iter_rows: list[np.ndarray] = []
        admissions = 0
        n_chunks = 0
        now = arr[0].t
        i = 0

        def finalize(lane: int, out: dict, t_done: float) -> None:
            j = occupied[lane]
            kn = knobs_by_lane[lane]
            z = np.asarray(out["z"][lane])
            records[j] = RequestRecord(
                req_id=j,
                arrival_t=arr[j].t,
                admit_t=admit_ts[lane],
                done_t=t_done,
                queue_delay_s=admit_ts[lane] - arr[j].t,
                exec_s=t_done - admit_ts[lane],
                latency_s=t_done - arr[j].t,
                batch_id=admit_ids[lane],
                batch_fill=admit_fill[lane],
                y_hat=float(out["y_hat"][lane]),
                prob=float(out["prob"][lane]),
                iters=int(out["it"][lane]),
                sample_frac=float(
                    np.minimum(z, np.asarray(out["n"][lane])).sum()
                )
                / max(true_rows[lane], 1),
                deadline_t=deadlines[j],
                disposition="ok",
                tier=kn.tier if kn is not None else 0,
                tau=kn.tau if kn is not None else None,
                delta=kn.delta if kn is not None else None,
                deadline_met=bool(t_done <= deadlines[j]),
                lane=lane,
                n_chunks=chunks_by_lane[lane],
                z=tuple(int(x) for x in z),
            )
            occupied[lane] = None
            knobs_by_lane[lane] = None

        def drop(lane: int, disposition: str, t: float) -> None:
            """Record a lane-resident request as failed/poisoned and free
            its host bookkeeping (the device lane is cleared separately)."""
            j = occupied[lane]
            kn = knobs_by_lane[lane]
            records[j] = RequestRecord(
                req_id=j,
                arrival_t=arr[j].t,
                admit_t=admit_ts[lane],
                done_t=t,
                queue_delay_s=admit_ts[lane] - arr[j].t,
                exec_s=t - admit_ts[lane],
                latency_s=t - arr[j].t,
                batch_id=admit_ids[lane],
                batch_fill=admit_fill[lane],
                y_hat=float("nan"),
                prob=0.0,
                iters=0,
                sample_frac=0.0,
                deadline_t=deadlines[j],
                disposition=disposition,
                tier=kn.tier if kn is not None else 0,
                tau=kn.tau if kn is not None else None,
                delta=kn.delta if kn is not None else None,
                deadline_met=False,
                lane=lane,
                n_chunks=chunks_by_lane[lane],
            )
            occupied[lane] = None
            knobs_by_lane[lane] = None

        while i < len(arr) or queue or any(l is not None for l in occupied):
            if not queue and all(l is None for l in occupied):
                if i >= len(arr):
                    break
                now = max(now, arr[i].t)  # idle: jump to the next arrival
            while i < len(arr) and arr[i].t <= now:
                queue.append(i)
                i += 1
            # ---- chunk-boundary admission into free lanes: shed/tier
            # decisions are made HERE, with the slack and queue depth of
            # the moment the request actually gets a lane
            free = [l for l in range(lanes) if occupied[l] is None]
            assignments = []
            while queue and free:
                j = queue.popleft()
                slack = (
                    deadlines[j] - now
                    if math.isfinite(deadlines[j])
                    else None
                )
                if ctl is not None and ctl.should_shed(slack, len(queue) + 1):
                    records[j] = RequestRecord(
                        req_id=j,
                        arrival_t=arr[j].t,
                        admit_t=now,
                        done_t=now,
                        queue_delay_s=now - arr[j].t,
                        exec_s=0.0,
                        latency_s=now - arr[j].t,
                        batch_id=-1,
                        batch_fill=0,
                        y_hat=float("nan"),
                        prob=0.0,
                        iters=0,
                        sample_frac=0.0,
                        deadline_t=deadlines[j],
                        disposition="shed",
                        tier=len(ctl.tiers) - 1,
                        deadline_met=False,
                    )
                    stats.n_shed += 1
                    continue
                lane = free.pop(0)
                kn = None
                if ctl is not None:
                    kn = ctl.knobs_for(
                        ctl.tier_for(slack, len(queue)), base_delta
                    )
                assignments.append((lane, arr[j].request, kn))
                occupied[lane] = j
                admit_ts[lane] = now
                admit_ids[lane] = admissions
                chunks_by_lane[lane] = 0
                knobs_by_lane[lane] = kn
                prev_it[lane] = 0
                if lane_used[lane]:
                    stats.n_recycles += 1
                lane_used[lane] = True
            if assignments:
                admissions += 1
                # admission is idempotent (the refill re-inits the whole
                # lane from counter-based RNG), so a transient failure just
                # retries the WHOLE admit — with every assignment's knobs
                # re-priced against its post-retry slack
                attempt = 0
                admitted = True
                while True:
                    t0 = time.perf_counter()
                    try:
                        table, tr = self.server.admit(table, cap, assignments)
                        out = self.server.readback(table)
                    except TransientExecutorError:
                        dt = time.perf_counter() - t0
                        now += dt
                        stats.busy_s += dt
                        if attempt >= self.max_retries:
                            admitted = False
                            break
                        now += self.backoff_s * (2.0**attempt)
                        attempt += 1
                        stats.n_retries += 1
                        if ctl is not None:
                            assignments = [
                                (
                                    lane,
                                    req,
                                    ctl.retier(
                                        deadlines[occupied[lane]] - now
                                        if math.isfinite(
                                            deadlines[occupied[lane]]
                                        )
                                        else None,
                                        len(queue),
                                        base_delta,
                                    ),
                                )
                                for lane, req, _kn in assignments
                            ]
                            for lane, _req, kn in assignments:
                                knobs_by_lane[lane] = kn
                        continue
                    dt = time.perf_counter() - t0
                    now += dt
                    stats.busy_s += dt
                    break
                if not admitted:
                    # retries exhausted before any lane was (fully) refilled:
                    # the assigned requests fail; their lanes are cleared in
                    # case a partial admit left them active
                    dead = [lane for lane, _req, _kn in assignments]
                    for lane in dead:
                        drop(lane, "failed", now)
                        stats.n_failed += 1
                    table = self.server.clear_lanes(table, dead)
                    continue
                fill = sum(l is not None for l in occupied)
                for lane, rows in tr.items():
                    true_rows[lane] = rows
                    admit_fill[lane] = fill
                # a fresh lane can be done straight from z⁰ (guarantee met
                # at the initial plan) — recycle it before paying a chunk
                for lane, _, _ in assignments:
                    prev_z[lane] = np.asarray(out["z"][lane], np.int64)
                    if out["done"][lane]:
                        finalize(lane, out, now)
            if all(l is None for l in occupied):
                continue  # everything shed or instantly done; re-admit
            # ---- one chunk dispatch, checkpointed at the boundary: the
            # snapshot holds host copies of the chunk-mutable carry leaves
            # (CHUNK_CARRY_LEAVES); a transient dispatch failure rolls the
            # table back to this boundary and replays — counter-based RNG
            # makes the replay bitwise-identical, and both snapshot and
            # restore are copies in place (no new slot)
            ckpt = self.server.snapshot(table)
            attempt = 0
            dispatched = True
            while True:
                t0 = time.perf_counter()
                try:
                    table = self.server.run_chunk(table)
                    out = self.server.readback(table)
                except TransientExecutorError as e:
                    dt = time.perf_counter() - t0
                    now += dt
                    stats.busy_s += dt
                    # the raiser may hand back the wrecked table (e.g. a
                    # mid-chunk crash leaving scrambled carry); adopt it so
                    # the rollback is exercised against real damage, then
                    # restore the last good boundary
                    wreck = getattr(e, "table", None)
                    if wreck is not None:
                        table = wreck
                    table = self.server.restore(table, ckpt)
                    stats.n_rollbacks += 1
                    if attempt >= self.max_retries:
                        dispatched = False
                        break
                    now += self.backoff_s * (2.0**attempt)
                    attempt += 1
                    stats.n_retries += 1
                    continue
                dt = time.perf_counter() - t0
                now += dt
                stats.busy_s += dt
                break
            if not dispatched:
                # persistent dispatch failure: fail every resident request
                # and clear their lanes so draining continues (bounded p99
                # instead of an infinite retry loop)
                dead = [l for l in range(lanes) if occupied[l] is not None]
                for lane in dead:
                    drop(lane, "failed", now)
                    stats.n_failed += 1
                table = self.server.clear_lanes(table, dead)
                continue
            n_chunks += 1
            occ = np.array([l is not None for l in occupied])
            occ_rows.append(occ)
            iter_rows.append(np.where(occ, out["it"] - prev_it, 0))
            prev_it = out["it"].copy()
            # ---- post-chunk numerical-health check: quarantine poisoned
            # lanes (NaN/Inf carry, z regression, inconsistent done flag)
            # without touching their healthy neighbors
            poisoned: list[int] = []
            for lane in range(lanes):
                if occupied[lane] is None:
                    continue
                chunks_by_lane[lane] += 1
                verdict = self._lane_health(
                    out, lane, prev_z[lane], cap, knobs_by_lane[lane]
                )
                if verdict is None:
                    prev_z[lane] = np.asarray(out["z"][lane], np.int64)
                    if out["done"][lane]:
                        finalize(lane, out, now)
                    continue
                poisoned.append(lane)
                j = occupied[lane]
                poison_attempts[j] = poison_attempts.get(j, 0) + 1
                if poison_attempts[j] <= self.poison_retries:
                    # bounded re-admission: the request goes back to the
                    # FRONT of the queue and gets a full fresh admit (which
                    # re-initializes every lane leaf), not a carry patch
                    queue.appendleft(j)
                    occupied[lane] = None
                    knobs_by_lane[lane] = None
                else:
                    drop(lane, "poisoned", now)
                    stats.n_poisoned += 1
            # an empty lane's carry is never read back into a record, but
            # the next step reads it too: clear one a fault wrecked
            wrecked = [lane for lane in range(lanes) if occupied[lane] is None
                       and lane not in poisoned and not _carry_in_range(out, lane, cap)]
            if poisoned or wrecked:
                table = self.server.clear_lanes(table, poisoned + wrecked)
            if ctl is not None:
                ctl.observe(dt, len(queue))

        stats.records = [r for r in records if r is not None]
        stats.makespan_s = now - arr[0].t
        stats.n_batches = admissions
        stats.n_chunks = n_chunks
        occ_m = (
            np.stack(occ_rows) if occ_rows else np.zeros((0, lanes), bool)
        )
        it_m = (
            np.stack(iter_rows) if iter_rows else np.zeros((0, lanes), np.int64)
        )
        stats.chunk_stats = chunked_straggler_report(
            it_m, occ_m, lanes=lanes, n_devices=self.server.n_devices
        )
        stats.lane_occupancy = stats.chunk_stats["lane_occupancy"]
        stats.compile_count = self.server.compile_count - compiles_before
        stats.compiled_buckets = self.server.compiled_buckets
        return stats
