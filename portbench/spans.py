"""The benchmark's own spans around the calls into the server, and the device trace.

:class:`Probe` stands between ``ContinuousServingRuntime`` and its
``ContinuousBatchedServer``: every call passes through unchanged.  Each
call reads the host clock once, to stop a window that runs past its
grace.  A run with ``--trace 0`` records nothing more.  With ``--trace 1``
the probe records

* in the window, on the host clock: a **refill** span from an ``admit``
  to the end of the read-back that follows it (the runtime's admission:
  the lanes' gathers, copies and one-lane graphs, then the read-back that
  waits for them), with the lanes it refilled, and a **chunk** span from a
  ``run_chunk`` to the end of its read-back;
* in the profiled slice that follows the window, the work its requests
  needed (:mod:`work`): refills, the lanes that iterate past z⁰,
  lane-steps, the rows each refilled group's tables cover.

:class:`Tracer` runs ``torch.profiler`` over a slice of traffic and
reduces its events to device-busy time, time by kernel and the idle gaps
by what the host was doing (the probe's spans name the host's work).
"""
from __future__ import annotations

import contextlib
import math
import time

import numpy as np

__all__ = ["Probe", "Tracer", "WindowOverrun", "merge_intervals"]


class WindowOverrun(RuntimeError):
    """The program did not finish the window's work within its grace."""


class Probe:
    """The server, seen through the benchmark's spans (see the module
    docstring).  A call made after :attr:`deadline` raises
    :class:`WindowOverrun`, so a program that never finishes stops."""

    def __init__(self, server, groups_rows: np.ndarray, field: str, tracer=None):
        self._server = server
        self._rows = groups_rows
        self._field = field
        self.tracer = tracer
        self.recording = False
        self.deadline = math.inf
        self.reset()

    def __getattr__(self, name):
        return getattr(self._server, name)

    def reset(self) -> None:
        """Start the window's records afresh."""
        self.spans: list[tuple] = []            # (kind, t0, t1, lanes)
        self.traced_work = dict(refills=0, iterating=0, lane_steps=0, table_rows=0)
        self._it = np.zeros(self._server.batch_size, np.int64)
        self._pending = None

    def _tick(self) -> float:
        t = time.perf_counter()
        if t > self.deadline:
            raise WindowOverrun("the window's requests were not done within its grace")
        if self.tracer is not None:
            self.tracer.poll(t)
        return t

    def _counting(self) -> bool:
        return self.tracer is not None and self.tracer.active

    def _scope(self, kind: str):
        if self._counting():
            import torch
            return torch.profiler.record_function(f"portbench.{kind}")
        return contextlib.nullcontext()

    def admit(self, table, cap, assignments):
        t0 = self._tick()
        lanes = [lane for lane, _req, _kn in assignments]
        if self._counting():
            w = self.traced_work
            w["refills"] += len(lanes)
            w["table_rows"] += sum(int(self._rows[req[self._field]])
                                   for _l, req, _kn in assignments)
        with self._scope("refill"):
            out = self._server.admit(table, cap, assignments)
        self._pending = ("refill", t0, lanes)
        return out

    def run_chunk(self, table):
        t0 = self._tick()
        with self._scope("chunk"):
            out = self._server.run_chunk(table)
        self._pending = ("chunk", t0, None)
        return out

    def snapshot(self, table):
        with self._scope("snapshot"):
            return self._server.snapshot(table)

    def readback(self, table):
        with self._scope("readback"):
            out = self._server.readback(table)
        t1 = self._tick()
        kind, t0, lanes = self._pending
        if self.recording:
            self.spans.append((kind, t0, t1, len(lanes) if lanes else 0))
        it = out["it"]
        if self._counting():
            if kind == "refill":
                self.traced_work["iterating"] += int((~out["done"][lanes]).sum())
            else:
                # a lane moves ``it`` only while it iterates; a refilled or
                # cleared lane restarts at 0
                self.traced_work["lane_steps"] += int(np.maximum(it - self._it, 0).sum())
        self._it = it
        return out


def merge_intervals(iv: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The union of ``[start, end)`` intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Tracer:
    """``torch.profiler`` over the first ``length_s`` seconds after :meth:`arm`,
    started and stopped from the probe's calls."""

    def __init__(self, length_s: float):
        self.length_s = float(length_s)
        self.active = False
        self._t0 = None
        self._prof = None

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity
        return torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def warm(self) -> None:
        """Start and stop one profile, so the slice's start pays no set-up."""
        import torch
        p = self._profile()
        p.start()
        torch.cuda.synchronize()
        p.stop()

    def arm(self, t0: float) -> None:
        self._t0 = t0

    def poll(self, t: float) -> None:
        if self._t0 is None:
            return
        if self._prof is None:
            self._prof = self._profile()
            self._prof.start()
            self.active = True
        elif self.active and t - self._t0 >= self.length_s:
            self.stop()

    def stop(self) -> None:
        if self.active:
            import torch
            torch.cuda.synchronize()
            self._prof.stop()
            self.active = False

    def reduce(self, top: int = 10) -> dict | None:
        """Device busy seconds, the traced window, seconds by kernel name and
        the idle gaps by the host's span; ``None`` when nothing was traced."""
        import torch

        if self._prof is None:
            return None
        evs = self._prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in evs:
            s, d, name = e.start_ns(), e.duration_ns(), e.name()
            if name.startswith("portbench."):
                # the spans' ranges appear on the device's timeline too: host only
                if e.device_type() != cuda:
                    host.append((name[len("portbench."):], s, s + d))
            elif e.device_type() == cuda and not e.is_user_annotation():
                dev.append((name, s, s + d))
        if not dev:
            return None
        lo = min(min(s for _n, s, _e in dev), min((s for _n, s, _e in host), default=2**63))
        hi = max(max(e for _n, _s, e in dev), max((e for _n, _s, e in host), default=0))
        busy = merge_intervals([(s, e) for _n, s, e in dev])
        by_name: dict[str, float] = {}
        for n, s, e in dev:
            by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
        short = {n: n[:160] for n in by_name}
        gaps: dict[str, float] = {}
        host.sort(key=lambda h: h[1])
        starts = [h[1] for h in host]
        prev = lo
        for s, e in busy + [(hi, hi)]:
            if s > prev:
                # the host's span covering the gap's middle names it (spans do not nest)
                mid = (s + prev) // 2
                i = int(np.searchsorted(starts, mid, side="right")) - 1
                label = (host[i][0] if i >= 0 and mid < host[i][2]
                         else "runtime between server calls")
                gaps[label] = gaps.get(label, 0.0) + (s - prev) * 1e-9
            prev = max(prev, e)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return dict(
            busy_s=sum(e - s for s, e in busy) * 1e-9,
            window_s=(hi - lo) * 1e-9,
            kernels=by_name,
            device_ops=[[short[n], v] for n, v in ops],
            idle_gaps=[[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]],
        )
