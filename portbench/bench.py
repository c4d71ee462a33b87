"""One run of a cell: set-up, the measured window, its trace, the check against the reference.

:func:`run_cell` builds the cell's deployment (``data.py``, from the
configuration's ``deployment_seed``) and the port's server over it
(``system.py``), warms every shape the traffic uses (one admission into
every lane, a chunk, a recycle: the refill and table graphs of the one cap
bucket are captured there), then measures ``seconds``: segments of requests
all due at once are fed to ``ContinuousServingRuntime.run`` until
``seconds`` have passed.

With ``trace`` the window records the probe's spans, and a slice of the
same traffic follows it under the profiler (``Tracer``), which slows the
host: the window's spans and counters are read untraced, and the slice
gives the device's numbers and the work it did.  Then the peak
memory is read, the program's state is freed, and the plain reference
(float64, on the same device) answers every served group for :mod:`judge`.  The metrics are read by each metric's reader
(``metrics/``) from the context this module assembles.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from types import SimpleNamespace

from portbench import catalog, judge, traffic, work
from portbench.data import make_deployment
from portbench.reference import Reference
from portbench.spans import Probe, Tracer, WindowOverrun

__all__ = ["FORBIDDEN", "Session", "card_line", "forbidden_modules", "read_metrics", "run_cell"]

#: Top-level module names that may not be loaded once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Seconds of the profiled slice that follows the window of a traced run.
TRACE_S = 2.0
#: How far past its window a run may go before it is stopped as hung.
GRACE_S = 60.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name, power limit and clocks, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


class Session:
    """A cell's deployment and the port's server over it, built and warmed
    once; :meth:`window` measures, :meth:`close` frees the program's state
    and :meth:`judge` holds a window's answers to the reference.

    ``sizes`` overrides the deployment's ``rows_per_group`` and
    ``n_serve_groups`` and the traffic's ``lanes`` and ``segment_requests``
    (the CPU tests' small runs); ``deployment_seed`` the configuration's (the
    limits' readings over other deployments).
    """

    def __init__(self, name: str, seed: int, *, device="cuda", sizes: dict | None = None,
                 deployment_seed: int | None = None, trace: bool = False,
                 t_start: float | None = None):
        from repro_torch.serving import ContinuousServingRuntime

        from portbench.system import build_server, knobs

        t_start = time.perf_counter() if t_start is None else t_start
        sizes = dict(sizes or {})
        self.name, self.device = name, device
        self.cell = c = catalog.cell(name)
        self.config, self.traffic = c["config_spec"], dict(c["traffic_spec"])
        if self.traffic["arrivals"] not in traffic.ARRIVALS:
            raise ValueError(f"unknown arrivals {self.traffic['arrivals']!r}")
        for key in ("lanes", "segment_requests"):
            if key in sizes:
                self.traffic[key] = sizes.pop(key)
        dseed = self.config["deployment_seed"] if deployment_seed is None else deployment_seed
        self.dep = make_deployment(self.config, int(dseed), **sizes)
        self.delta, self.tau = knobs(self.dep, self.traffic["setting"])
        self.field = self.config["group_field"]
        self.tracer = Tracer(TRACE_S) if trace else None
        self.probe = Probe(build_server(self.dep, self.traffic, device), self.dep.sizes,
                           self.field, self.tracer)
        self.runtime = ContinuousServingRuntime(self.probe)
        warm = traffic.backlog_segment(self.dep.n_groups, 2 * int(self.traffic["lanes"]),
                                       traffic.rng_for(seed, "warm"), self.field)
        self.runtime.run(warm)
        if self.tracer is not None:
            self.tracer.warm()
        _sync(device)
        self.setup_s = time.perf_counter() - t_start

    def window(self, seconds: float, seed: int, *, grace_s: float = GRACE_S,
               traced: bool = False):
        """Measure ``seconds`` of the cell's traffic; with ``traced`` the
        profiler runs over its first ``TRACE_S`` seconds.  The context of the
        window."""
        probe, n_groups = self.probe, self.dep.n_groups
        segment = int(self.traffic["segment_requests"])
        probe.reset()
        probe.recording = self.tracer is not None and not traced
        offered: list = []
        runs: list = []           # (first offered index, RuntimeStats)
        marks: list = []          # seconds into the window at each segment's end
        overrun = None
        rng = traffic.rng_for(seed, "backlog")
        t0 = time.perf_counter()
        probe.deadline = t0 + seconds + grace_s
        if traced:
            self.tracer.arm(t0)
        try:
            while time.perf_counter() - t0 < seconds:
                seg = traffic.backlog_segment(n_groups, segment, rng, self.field)
                base = len(offered)
                offered.extend(seg)
                runs.append((base, self.runtime.run(seg, warmup=False)))
                marks.append(time.perf_counter() - t0)
        except WindowOverrun as e:
            overrun = str(e)
        _sync(self.device)
        window_s = time.perf_counter() - t0
        probe.recording = False
        trace_red = None
        if traced:
            self.tracer.stop()
            trace_red = self.tracer.reduce()
        served = []
        for base, st in runs:
            for r in st.records:
                if r.disposition == "ok":
                    g = offered[base + r.req_id][1][self.field]
                    served.append((g, float(r.y_hat), float(r.prob), tuple(r.z), int(r.iters)))
        return SimpleNamespace(
            config=self.config, traffic=self.traffic, dep=self.dep, setup_s=self.setup_s,
            window_s=window_s, runs=runs, served=served, spans=probe.spans,
            traced_work=dict(probe.traced_work), segment_ends_s=marks, trace=trace_red,
            work_fns=work, attempted=len(offered), failed=len(offered) - len(served),
            overrun=overrun, delta=self.delta, tau=self.tau)

    def close(self) -> None:
        """Free the program's state (its tables, graphs and buffers)."""
        self.runtime = self.probe = None
        gc.collect()
        if str(self.device).startswith("cuda"):
            import torch
            torch.cuda.empty_cache()

    def reference(self, dtype=None) -> Reference:
        import torch
        return Reference(self.dep, delta=self.delta, tau=self.tau,
                         dtype=torch.float64 if dtype is None else dtype, device=self.device)

    def judge(self, ctx, ref: Reference | None = None, also: list = ()) -> None:
        """Hold every served answer of ``ctx`` (and the answers ``also``) to the
        reference: sets ``ctx.values``, ``ctx.checks`` and ``ctx.correct``."""
        ref = self.reference() if ref is None else ref
        served = list(ctx.served) + list(also)
        loops = {g: ref.serve(g) for g in sorted({s[0] for s in served})}
        at_plan = {(g, z): ref.at_plan(g, z) for g, z in sorted({(s[0], s[3]) for s in served})}
        ctx.values = judge.numbers(self.dep.task, self.delta, served, loops, at_plan)
        ctx.checks = judge.check(ctx.values, self.cell["limits"])
        ctx.correct = (all(ok for *_x, ok in ctx.checks) and ctx.failed == 0
                       and ctx.overrun is None)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             sizes: dict | None = None, grace_s: float = GRACE_S,
             t_start: float | None = None):
    """One run of cell ``name``: set-up, the window, the peak memory, the
    program freed, the reference's check; the window's context."""
    s = Session(name, seed, device=device, sizes=sizes, t_start=t_start, trace=trace)
    ctx = s.window(seconds, seed, grace_s=grace_s)
    sliced = []
    if trace:
        # the profiler slows the host: its slice follows the window, which the
        # spans and counters are read from, and gives only the device's numbers
        sl = s.window(TRACE_S, seed, grace_s=grace_s, traced=True)
        ctx.trace, ctx.traced_work = sl.trace, sl.traced_work
        sliced = sl.served
        ctx.attempted += sl.attempted
        ctx.failed += sl.failed
        ctx.overrun = ctx.overrun or sl.overrun
    ctx.memory_peak = 0
    if str(device).startswith("cuda"):
        import torch
        ctx.memory_peak = int(torch.cuda.max_memory_allocated())
    s.close()
    s.judge(ctx, also=sliced)
    return ctx


def read_metrics(ctx, entries: list[dict]) -> dict:
    """``{name: {"value", "unit"}}`` of the entries whose reader found
    something to read."""
    out = {}
    for m in entries:
        v = catalog.metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
