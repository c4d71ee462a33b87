"""Fault injection for the serving runtimes: spikes, failures, bursts, wrecked lanes.

Port of ``repro/serving/faults.py``.  Degradation and recovery must be
testable, so this module wraps a server in a seeded fault layer:

* **service-time spikes** — a seeded subset of calls sleeps ``spike_s``
  before dispatching; the runtime measures wall time, so a spike reaches the
  virtual clock like a slow batch;
* **transient executor errors** — a seeded subset of calls raises
  :class:`TransientExecutorError` instead of serving; the runtime retries
  with bounded exponential backoff (``serving/runtime.py``);
* **arrival bursts** — :func:`inject_burst` splices a clump of arrivals into
  a trace.

The continuous path (:class:`FaultyContinuousServer`) adds chunk-granular
faults: a chunk dispatch that dies and leaves its carry wrecked
(:class:`ChunkDispatchError`, the runtime rolls back to its chunk-boundary
checkpoint and replays), a refill that fails before any work (admission is
idempotent, so it is retried whole), a lane whose carry is poisoned after a
chunk (the runtime's health check quarantines it), and a flipped value in
a cached entry (the cache's checksum catches it).

The schedule is a pure function of ``(FaultProfile, call index)``: each
call draws from ``numpy.random.default_rng((seed, stream, call))``, as the
reference does, so the two schedules are bitwise equal.  The lane table's
wreckage is written into its tensors in place (the captured graphs read
fixed addresses), so a fault run builds no slot and captures nothing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.executor_fused import CHUNK_CARRY_LEAVES, ShardedLaneState
from repro_torch.serving.feature_cache import entry_checksum

__all__ = [
    "TransientExecutorError",
    "ChunkDispatchError",
    "FaultProfile",
    "FaultyServer",
    "FaultyContinuousServer",
    "corrupt_cache_entry",
    "inject_burst",
    "poison_lane_carry",
    "scramble_chunk_carry",
]


class TransientExecutorError(RuntimeError):
    """A retryable executor failure (a preempted device, a dropped call, an
    evicted program)."""


class ChunkDispatchError(TransientExecutorError):
    """A chunk dispatch that died mid-flight, leaving the table wrecked.

    ``table`` (when not None) is the lane table the failed dispatch left
    behind: the runtime restores its chunk-boundary checkpoint onto it
    before anything replays over it.
    """

    def __init__(self, msg: str, table=None):
        super().__init__(msg)
        self.table = table


@dataclass(frozen=True)
class FaultProfile:
    """Deterministic, seeded fault schedule over call indices.

    ``*_calls`` pin faults to explicit 0-based call indices; ``*_prob`` add
    seeded Bernoulli faults on top (one draw of
    ``default_rng((seed, stream, call))`` each, a stream per kind, so
    enabling one kind never moves another's schedule).  A call scheduled to
    fail raises before any service work; a spike sleeps ``spike_s`` of wall
    time first.
    """

    seed: int = 0
    spike_s: float = 0.0
    spike_calls: tuple[int, ...] = ()
    spike_prob: float = 0.0
    fail_calls: tuple[int, ...] = ()
    fail_prob: float = 0.0
    chunk_fail_calls: tuple[int, ...] = ()
    chunk_fail_prob: float = 0.0
    refill_fail_calls: tuple[int, ...] = ()
    refill_fail_prob: float = 0.0
    poison_calls: tuple[int, ...] = ()
    poison_prob: float = 0.0
    cache_corrupt_calls: tuple[int, ...] = ()

    def _bernoulli(self, stream: int, call: int, prob: float) -> bool:
        if prob <= 0.0:
            return False
        rng = np.random.default_rng((self.seed, stream, call))
        return bool(rng.random() < prob)

    def spikes_at(self, call: int) -> bool:
        return call in self.spike_calls or self._bernoulli(0, call, self.spike_prob)

    def fails_at(self, call: int) -> bool:
        return call in self.fail_calls or self._bernoulli(1, call, self.fail_prob)

    def chunk_fails_at(self, call: int) -> bool:
        return call in self.chunk_fail_calls or self._bernoulli(2, call, self.chunk_fail_prob)

    def refill_fails_at(self, call: int) -> bool:
        return call in self.refill_fail_calls or self._bernoulli(3, call, self.refill_fail_prob)

    def poisons_at(self, call: int) -> bool:
        return call in self.poison_calls or self._bernoulli(4, call, self.poison_prob)

    def poison_lane(self, call: int, lanes: int) -> int:
        """The (seeded) lane a poison event at ``call`` lands on."""
        rng = np.random.default_rng((self.seed, 5, call))
        return int(rng.integers(lanes))


class FaultyServer:
    """``serve_batch`` interceptor injecting the profile's faults.

    ``calls`` counts every attempt (those that raise too), the index the
    schedule keys on; ``events`` logs ``(call, kind)``.  Every other
    attribute is the wrapped server's.
    """

    def __init__(self, server, profile: FaultProfile, *, sleep=time.sleep):
        self._server = server
        self.profile = profile
        self.calls = 0
        self.events: list[tuple[int, str]] = []
        self._sleep = sleep

    def __getattr__(self, name):
        return getattr(self._server, name)

    def serve_batch(self, requests, knobs=None):
        call = self.calls
        self.calls += 1
        if self.profile.fails_at(call):
            self.events.append((call, "fail"))
            raise TransientExecutorError(f"injected transient failure at serve_batch call {call}")
        if self.profile.spikes_at(call):
            self.events.append((call, "spike"))
            self._sleep(self.profile.spike_s)
        return self._server.serve_batch(requests, knobs=knobs)


def scramble_chunk_carry(table):
    """Wreck a lane table's carry in place (what a dead dispatch leaves):
    every :data:`~repro_torch.core.executor_fused.CHUNK_CARRY_LEAVES` leaf
    of every lane to garbage (NaN floats, -1 integers, cleared flags), on
    every shard of a sharded table.  The big buffers are untouched.  Returns
    the table."""
    for part in getattr(table, "shards", (table,)):
        for name in CHUNK_CARRY_LEAVES:
            leaf = getattr(part, name)
            if leaf.dtype == torch.bool:
                leaf.fill_(False)
            elif leaf.dtype.is_floating_point:
                leaf.fill_(float("nan"))
            else:
                leaf.fill_(-1)
    return table


def poison_lane_carry(table, lane: int):
    """Corrupt ONE lane's carry in place (a partial-write fault): ``y_hat``
    and ``prob`` NaN, ``z = -1`` (out of range, and a regression of the
    monotone plan).  On a sharded table the global lane is written in its
    owner's table (``ShardedLaneState.locate``).  The runtime's health check
    must quarantine exactly this lane and leave the others bitwise as they
    are.  Returns the table."""
    part = table
    if isinstance(table, ShardedLaneState):
        shard, lane = table.locate(lane)
        part = table.shards[shard]
    part.y_hat[lane] = float("nan")
    part.prob[lane] = float("nan")
    part.z[lane] = -1
    return table


def corrupt_cache_entry(cache, seed=0) -> bool:
    """Flip one value in the cache's most-recently-used entry's buffer.

    Bit rot or a torn write in device-resident state: the entry's stored
    checksum no longer matches its contents, which the cache's integrity
    check (``verify_hits`` / ``revalidate``) must catch.  Candidate byte
    flips are retried until the checksum moves (flipping the sign of -0.0,
    or a pad zero into a denormal that drowns in the float64 sums, would
    not).  The buffer is written back in place.  Returns False when the
    cache is empty.
    """
    entries = list(cache._entries.values())
    if not entries:
        return False
    entry = entries[-1]  # most recently used
    v = entry.vals.cpu().numpy().copy()
    n = entry.n.cpu()
    flat = v.reshape(-1)
    orig = flat.copy()
    want = entry_checksum(torch.from_numpy(v), n)
    rng = np.random.default_rng(seed)
    for _ in range(32):
        i = int(rng.integers(flat.size))
        b = int(rng.integers(flat.itemsize))
        flat.view(np.uint8)[flat.itemsize * i + b] ^= 0xFF
        # NaN sums compare unequal to anything: detectable too
        if entry_checksum(torch.from_numpy(v), n) != want:
            break
        flat[i] = orig[i]
    else:
        flat[0] = orig[0] + 1.0
    entry.vals.copy_(torch.from_numpy(v))
    return True


class FaultyContinuousServer:
    """Chunk-granular fault interceptor around a ``ContinuousBatchedServer``.

    ``run_chunk`` and ``admit`` have call counters of their own (the
    schedule's indices); everything else is the wrapped server's.
    ``events`` logs ``(call, kind)``; two runs with one profile inject the
    same faults.
    """

    def __init__(self, server, profile: FaultProfile, *, sleep=time.sleep):
        self._server = server
        self.profile = profile
        self.chunk_calls = 0
        self.admit_calls = 0
        self.events: list[tuple[int, str]] = []
        self._sleep = sleep

    def __getattr__(self, name):
        return getattr(self._server, name)

    def admit(self, table, cap, assignments):
        call = self.admit_calls
        self.admit_calls += 1
        prof = self.profile
        cache = getattr(self._server, "cache", None)
        if call in prof.cache_corrupt_calls and cache is not None:
            if corrupt_cache_entry(cache, seed=(prof.seed, 6, call)):
                self.events.append((call, "cache_corrupt"))
        if prof.refill_fails_at(call):
            self.events.append((call, "refill_fail"))
            raise TransientExecutorError(f"injected refill failure at admit call {call}")
        return self._server.admit(table, cap, assignments)

    def run_chunk(self, table):
        call = self.chunk_calls
        self.chunk_calls += 1
        prof = self.profile
        if prof.spikes_at(call):
            self.events.append((call, "spike"))
            self._sleep(prof.spike_s)
        if prof.chunk_fails_at(call):
            self.events.append((call, "chunk_fail"))
            raise ChunkDispatchError(f"injected chunk-dispatch failure at chunk call {call}",
                                     table=scramble_chunk_carry(table))
        table = self._server.run_chunk(table)
        if prof.poisons_at(call):
            lane = prof.poison_lane(call, self._server.batch_size)
            self.events.append((call, f"poison:{lane}"))
            table = poison_lane_carry(table, lane)
        return table


def inject_burst(arrivals, *, at_t: float, n: int, width_s: float, seed: int = 0,
                 slo_s: float | None = None):
    """Splice ``n`` extra arrivals uniformly into ``[at_t, at_t + width_s)``.

    The burst's requests are drawn (seeded) from the trace's own requests,
    so it stresses admission, not new cap buckets.  Takes and returns
    ``(t, request)`` / ``(t, request, slo_s)`` tuples sorted by time;
    ``slo_s`` attaches a deadline budget to the injected arrivals.  Raises
    on an empty trace, a non-positive width or a negative ``n``.
    """
    base = sorted(arrivals, key=lambda a: a[0])
    if not base:
        raise ValueError("cannot inject a burst into an empty trace")
    if width_s <= 0:
        raise ValueError("width_s must be > 0")
    if n < 0:
        raise ValueError("n must be >= 0")
    rng = np.random.default_rng(seed)
    reqs = [a[1] for a in base]
    ts = np.sort(rng.uniform(at_t, at_t + width_s, n))
    extra = []
    for t in ts:
        req = reqs[int(rng.integers(len(reqs)))]
        extra.append((float(t), req) if slo_s is None else (float(t), req, slo_s))
    return sorted(base + extra, key=lambda a: a[0])
