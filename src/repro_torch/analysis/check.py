"""The contract checker: ``python -m repro_torch.analysis.check``.

Port of ``repro/analysis/check.py``.  Builds every serving program at test
scale on ``--device`` (default ``cuda``; ``cpu`` runs the plain versions):
the fixed-lane batch programs (``fused``), the same over a mesh
(``sharded_lanes``: on the CPU 2 simulated shards; on the card every
visible card, or 2 simulated shards on one), the continuous table's
``refill`` and ``chunk``, the cache-fed programs with ``cold`` and
``refresh`` (``fused_prebuilt``) and the recovery probes, for each pipeline
of ``--pipelines``, then holds each against its registered
:class:`~repro_torch.analysis.contracts.ExecutableContract`:

1. **slots** — real batches through the real server, then the server's
   ``check_compile_contract`` (one slot a cap bucket, on every shard; two
   for the continuous pair); the slot tensors keep their addresses across
   batches of one bucket and a change of fill (``donated``), and knobs given
   as Python or numpy scalars keep the slot's dtypes (``weak_type_inputs``);
2. **programs** — each program run once eagerly on a ``capture=False``
   twin under :class:`~repro_torch.analysis.program_lint.OpRecorder`: no
   RNG operator, no host sync, float64 only at the sites ``baseline.json``
   allows, no read of another shard's tensors; on the card the captured
   graphs are also replayed under ``torch.cuda.set_sync_debug_mode("error")``;
3. **probes** — cache coherence after an append, chunk rollback, lane
   quarantine, store recovery and cache integrity, bitwise against
   fault-free oracles, and the incremental step's **flatness** at caps
   2048 and 8192.

The observed facts are diffed against the section of ``baseline.json`` for
the device (``cpu`` or ``cuda``), so a drift fails with a diff even where a
contract was loosened to match; ``--update-baseline`` rewrites that section.
``--mutation-test`` runs the seeded violations of
:mod:`repro_torch.analysis.mutations` and fails unless each is caught.

Exit status: 0 clean, 1 on findings, baseline drift or a missed mutation.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import difflib
import json
import sys
import time
from collections.abc import Sequence
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.analysis import program_lint
from repro_torch.analysis.contracts import ExecutableContract, all_contracts, contract_for
from repro_torch.analysis.program_lint import LintFinding, OpRecorder, wrap_programs
from repro_torch.core.executor import BiathlonConfig
from repro_torch.core.executor_fused import FusedExecutor
from repro_torch.data.synthetic import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_serving_mesh, simulated_devices
from repro_torch.serving import (
    BatchedFusedServer,
    BiathlonServer,
    ContinuousBatchedServer,
    LaneKnobs,
    gather_lanes,
)

__all__ = ["main", "run_checks"]

BASELINE_PATH = Path(__file__).with_name("baseline.json")
DEFAULT_PIPELINES = ("turbofan", "sensor_health")
#: test-scale data, as the reference's checker: one cap bucket, the real
#: builders and the real servers
SMALL = dict(rows_per_group=300, n_train_groups=30, n_serve_groups=4, n_requests=6)
CFG = BiathlonConfig(m=64, m_sobol=16, n_bootstrap=32)
LANES = 4
#: caps of the flatness probe (4x apart: a rescan grows with the cap)
FLATNESS_CAPS = (2048, 8192)
#: the tensors a slot is made with (``FusedExecutor._slot``), which every run
#: writes in place; the programs' own outputs (``n``, ``step``, the AFC
#: tables) are rebound by each eager run and held by the graph pool on the card
SLOT_TENSORS = ("vals", "n_in", "agg", "delta", "exact", "active", "tau", "iter_cap",
                "z", "it", "y_hat", "prob", "idx", "want")
RUN_PROGRAMS = ("init", "sobol0", "step")


# ---------------------------------------------------------------- helpers
#: planner iterations of the recorded runs: enough to reach every program,
#: few enough to keep the eager runs short
PROBE_ITERS = 2


def tight_knobs(bundle, fill: int) -> list[LaneKnobs]:
    """Knobs under which the small requests iterate (0.1·δ, at most
    :data:`PROBE_ITERS` iterations), so a recorded run reaches every
    program."""
    p = bundle.pipeline
    delta = CFG.delta if CFG.delta is not None else p.delta_default
    return [LaneKnobs(0.1 * delta, CFG.tau, PROBE_ITERS)] * fill


def executors(run) -> list:
    """The shards' executors of a sharded run, or ``[run]``."""
    return [sh.exe for sh in run.shards] if hasattr(run, "shards") else [run]


def slot_addresses(run, names: Sequence[str] = SLOT_TENSORS) -> dict[str, int]:
    """Addresses of every slot's fixed tensors (and a prebuilt slot's tables)."""
    out = {}
    for i, exe in enumerate(executors(run)):
        for key, s in exe._slots.items():
            fixed = {n: getattr(s, n) for n in names}
            if exe.prebuilt and s.incremental:
                fixed["tables"] = s.tables
            for name, ptr in program_lint.slot_addresses(fixed).items():
                out[f"shard{i}/{key}/{name}"] = ptr
    return out


def table_addresses(table) -> dict[str, int]:
    """Addresses of a lane table's tensors and of its refill slot's fixed ones."""
    out = {}
    for i, t in enumerate(getattr(table, "shards", (table,))):
        for name, ptr in program_lint.slot_addresses(t).items():
            out[f"shard{i}/{name}"] = ptr
        src = {n: getattr(t.src, n) for n in SLOT_TENSORS}
        for name, ptr in program_lint.slot_addresses(src).items():
            out[f"shard{i}/src.{name}"] = ptr
    return out


def _compile_contract_findings(srv: Any, exe: str) -> list[LintFinding]:
    """The server's own compile-contract assertion, as a finding."""
    try:
        srv.check_compile_contract()
        return []
    except AssertionError as e:
        return [LintFinding(contract="executables_per_bucket", executable=exe,
                            where="<slot counts>", message=str(e))]


@contextlib.contextmanager
def _sync_debug_error():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def sync_debug_findings(slots, exe: str) -> list[LintFinding]:
    """On the card: replay every captured graph of ``slots`` under
    ``set_sync_debug_mode("error")``; a replay that syncs raises."""
    out = []
    for where, s in slots:
        if getattr(s, "graphs", None) is None:
            continue
        try:
            with _sync_debug_error():
                for graph, _ in s.graphs:
                    graph.replay()
        except RuntimeError as e:
            out.append(LintFinding(contract="host_sync", executable=exe, where=where,
                                   message=f"a captured replay synchronised: {e}"))
    torch.cuda.synchronize()
    return out


def knob_findings(srv: BatchedFusedServer, requests, exe: str) -> list[LintFinding]:
    """``weak_type_inputs``: the executor run with knobs given as Python
    floats and ints, numpy float64 and int64, and ints for floats keeps
    every slot tensor's dtype and builds no slot."""
    p, run = srv.bundle.pipeline, srv._run
    cap = srv.batch_cap(requests)
    vals, ns, exacts = gather_lanes(p, srv.bundle.store, requests, cap, srv.batch_size,
                                    srv._staging, policy="reject")
    built = srv.compile_count

    def dtypes():
        return {f"{i}/{k}/{name}": dt for i, x in enumerate(executors(run))
                for k, s in x._slots.items() for name, dt in program_lint.slot_dtypes(s).items()}

    want = dtypes()
    for delta, tau, it in ((0.5, 0.95, 8), (np.float64(0.5), np.float64(0.95), np.int64(8)),
                           (1, 1, 8)):
        run(vals, torch.from_numpy(ns), srv._agg_ids, delta, torch.from_numpy(exacts), True,
            tau, it)
    srv._staging.release(vals)
    out = program_lint.check_dtypes(dtypes(), want, exe)
    if srv.compile_count != built:
        out.append(LintFinding(
            contract="weak_type_inputs", executable=exe, where="<slot counts>",
            message=f"knobs of other Python or numpy types built {srv.compile_count - built} "
                    "slot(s)"))
    return out


def lint_records(records, owned, contract: ExecutableContract, exe: str,
                 programs: Sequence[str], allowed_f64) -> tuple[list[LintFinding], dict]:
    """The program checks of one executable's records against its contract;
    ``(findings, facts)``."""
    findings: list[LintFinding] = []
    if contract.rng == "counter_based":
        findings += program_lint.check_rng(records, exe)
    findings += program_lint.check_host_sync(records, exe)
    f64, sites = program_lint.check_f64(records, exe, allowed_f64)
    if not contract.allow_f64:
        findings += f64
    cross = program_lint.check_collectives(records, owned, exe)
    if len(cross) > contract.collectives:
        findings += cross
    ran = sorted({r.program for r in records})
    for name in programs:
        if name not in ran:
            findings.append(LintFinding(
                contract="coverage", executable=exe, where=name,
                message="the recorded run never reached this program: nothing of it was checked"))
    by = lambda field: sum(1 for f in findings if f.contract == field)  # noqa: E731
    facts = {
        "contract": contract.name,
        "collectives": len(cross),
        "rng_findings": by("rng"),
        "host_sync_findings": by("host_sync"),
        "f64_sites": sites,
        "programs": ran,
    }
    return findings, facts


def cache_coherence_findings(cached: Any, oracle: Any, requests, exe: str) -> list[LintFinding]:
    """Serve the same requests through a cache-fed server and an uncached
    oracle: a cached entry whose versions lag the store shows as another
    plan or ŷ (the plans are bitwise across the two paths).  Also the
    oracle of the ``stale_cache_read`` mutant."""
    findings = []
    for i, req in enumerate(requests):
        a, b = cached.serve(req), oracle.serve(req)
        same_z = bool(np.array_equal(a["z"], b["z"]))
        same_y = abs(a["y_hat"] - b["y_hat"]) <= 1e-4 * max(abs(b["y_hat"]), 1.0)
        if not (same_z and same_y):
            findings.append(LintFinding(
                contract="cache_version_key", executable=exe, where=f"request[{i}]",
                message=(f"cache-fed serve diverged from the uncached oracle (y {a['y_hat']:.6g} "
                         f"vs {b['y_hat']:.6g}, z match={same_z}): a stale entry was served; "
                         "the key must hold the group versions")))
    return findings


def _drain(srv: Any, table: Any, max_chunks: int = 256) -> dict:
    out = srv.readback(table)
    for _ in range(max_chunks):
        if out["done"].all():
            break
        out = srv.readback(srv.run_chunk(table))
    return out


def _bits(out: dict, lane: int) -> tuple:
    return (out["z"][lane].tolist(), int(out["it"][lane]),
            np.float32(out["y_hat"][lane]).view(np.int32).item(),
            np.float32(out["prob"][lane]).view(np.int32).item())


def rollback_findings(srv: Any, requests, exe: str, *,
                      skip_restore: Sequence[str] = ()) -> list[LintFinding]:
    """Roll a failed chunk back and replay: bitwise the fault-free run.

    A chunk runs, then the next chunk's dispatch is declared failed (it ran
    on the device, its read-back came back scrambled,
    ``faults.scramble_chunk_carry``), the snapshot taken before it is
    restored and the table drained: every lane's plan, iterations, ŷ and
    prob must equal the never-failed run's, since the bootstrap keys follow
    the restored ``it``.  ``skip_restore`` is the seam of the
    ``rollback_skips_bootstrap_carry`` mutant: a leaf the rollback forgets
    keeps what the failed dispatch left (a scrambled ``it`` of -1 would
    index the key table out of range on the card, a device fault, where
    JAX clamps it).
    """
    from repro_torch.serving import faults

    lanes = list(range(min(srv.batch_size, len(requests))))
    cap = srv.trace_cap([requests[lane] for lane in lanes])
    assignments = [(lane, requests[lane], None) for lane in lanes]
    table, _ = srv.admit(srv.new_table(cap), cap, assignments)
    want = _drain(srv, table)

    table, _ = srv.admit(srv.new_table(cap), cap, assignments)
    srv.run_chunk(table)
    ckpt = srv.snapshot(table)
    srv.run_chunk(table)                     # the dispatch that fails
    left = srv.snapshot(table)
    faults.scramble_chunk_carry(table)
    srv.restore(table, {k: (left[k] if k in skip_restore else v) for k, v in ckpt.items()})
    got = _drain(srv, table)
    return [LintFinding(
        contract="rollback_replay", executable=exe, where=f"lane[{lane}]",
        message=("replay after a chunk rollback diverged from the fault-free run "
                 f"({_bits(got, lane)} vs {_bits(want, lane)}: plan, it, y and prob bits): "
                 "the checkpoint must restore every chunk carry leaf"),
    ) for lane in lanes if _bits(got, lane) != _bits(want, lane)]


def quarantine_findings(srv: Any, requests, exe: str, *,
                        reset_on_readmit: bool = True) -> list[LintFinding]:
    """Poison lane 0's carry, quarantine and re-admit it: the re-admitted
    lane equals a never-poisoned run and its neighbour is untouched, bit for
    bit.  ``reset_on_readmit=False`` is the seam of the
    ``quarantine_readmit_without_reset`` mutant: the lane's flags flipped
    back to live with the poisoned carry kept."""
    from repro_torch.serving import faults

    reqs = list(requests[:2])
    cap = srv.trace_cap(reqs)
    assignments = [(lane, reqs[lane], None) for lane in (0, 1)]
    table, _ = srv.admit(srv.new_table(cap), cap, assignments)
    want = _drain(srv, table)

    table, _ = srv.admit(srv.new_table(cap), cap, assignments)
    srv.run_chunk(table)
    faults.poison_lane_carry(table, 0)
    if reset_on_readmit:
        srv.clear_lanes(table, [0])
        table, _ = srv.admit(table, cap, [(0, reqs[0], None)])
    else:
        table.want[0] = True
        table.active[0] = True
    got = _drain(srv, table)
    return [LintFinding(
        contract="quarantine_isolation", executable=exe, where=f"lane[{lane}] ({label})",
        message=(f"{label} lane diverged from the never-poisoned run ({_bits(got, lane)} vs "
                 f"{_bits(want, lane)}): quarantine must re-initialise the poisoned lane and "
                 "touch nothing else"),
    ) for lane, label in ((0, "re-admitted"), (1, "neighbour"))
        if _bits(got, lane) != _bits(want, lane)]


def store_recovery_findings(bundle: Any, exe: str) -> list[LintFinding]:
    """Journal replay rebuilds the index exactly: after a few journaled
    appends, a torn derived state (shuffled permutation, shifted offsets,
    cleared versions) must ``recover`` to the never-crashed one."""
    t, _c, g = bundle.pipeline.agg_specs(bundle.requests[0])[0]
    table = bundle.store[t]
    for shift in (0.5, -1.25):
        table.append({name: [float(np.asarray(col[np.isfinite(col)]).mean()) + shift]
                      for name, col in table.columns.items()}, group_key=g)
    want = (table.perm.copy(), table.group_ptr.copy(), dict(table.group_ids),
            list(table.versions))
    rng = np.random.default_rng(0)
    table.perm = rng.permutation(table.perm)
    table.group_ptr = table.group_ptr + 7
    table.versions = []
    table.recover()
    same = (np.array_equal(want[0], table.perm) and np.array_equal(want[1], table.group_ptr)
            and want[2] == dict(table.group_ids) and want[3] == list(table.versions))
    return [] if same else [LintFinding(
        contract="store_recovery", executable=exe, where=f"table[{t}]",
        message="journal replay did not rebuild perm / group_ptr / versions exactly")]


def cache_integrity_findings(bundle: Any, dev, exe: str) -> list[LintFinding]:
    """A flipped byte in a resident entry is detected, never served."""
    from repro_torch.serving import corrupt_cache_entry

    srv = BiathlonServer(bundle, CFG, mode="fused", cache_size=4, device=dev)
    req = bundle.requests[0]
    want = srv.serve(req)
    srv.cache.verify_hits = True
    if not corrupt_cache_entry(srv.cache, seed=0):
        return [LintFinding(contract="cache_integrity", executable=exe, where="<cache>",
                            message="the corruption probe found no resident entry to flip")]
    got = srv.serve(req)
    out = []
    if srv.cache.corruptions < 1:
        out.append(LintFinding(
            contract="cache_integrity", executable=exe, where="<cache>",
            message="a flipped byte in a resident entry went undetected by its checksum"))
    if not (np.array_equal(want["z"], got["z"]) and want["y_hat"] == got["y_hat"]):
        out.append(LintFinding(
            contract="cache_integrity", executable=exe, where="<cache>",
            message=f"the rebuild after the corruption diverged (y {got['y_hat']:.6g} vs "
                    f"{want['y_hat']:.6g})"))
    return out


def allowed_f64(path: Path = BASELINE_PATH) -> list[str]:
    """The float64 ``site op`` keys ``baseline.json`` allows."""
    return json.loads(path.read_text()).get("allowed_f64", []) if path.exists() else []


# ----------------------------------------------------------- per-executable
def serving_mesh(dev: torch.device):
    """The checker's mesh: every visible card (4 or 2 of them, as the lanes
    split), else 2 shards simulated on ``dev``."""
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        d = next((d for d in (4, 2) if d <= n and LANES % d == 0), 0)
        if d:
            return make_serving_mesh(d)
    return make_serving_mesh(devices=simulated_devices(2, dev))


def check_fused(bundle: Any, dev, *, mesh: Any = None,
                allowed=()) -> tuple[str, list[LintFinding], dict]:
    """The fixed-lane batch programs (over ``mesh`` when given)."""
    name = "sharded_lanes" if mesh is not None else "fused"
    exe = f"{bundle.name}/{name}"
    on = dict(mesh=mesh) if mesh is not None else dict(device=dev)
    srv = BatchedFusedServer(bundle, CFG, batch_size=LANES, **on)
    reqs = list(bundle.requests[:3])
    srv.serve_batch(reqs[:1])
    before = slot_addresses(srv._run)
    srv.serve_batch(reqs, knobs=tight_knobs(bundle, 3))   # another fill, same bucket
    findings = _compile_contract_findings(srv, exe)
    moved = program_lint.check_in_place(before, slot_addresses(srv._run), exe)
    knobs = knob_findings(srv, reqs, exe)
    findings += moved + knobs
    if srv.device.type == "cuda":
        findings += sync_debug_findings(
            [(f"shard {i} {k}", s) for i, x in enumerate(executors(srv._run))
             for k, s in x._slots.items()], exe)

    lint = BatchedFusedServer(bundle, CFG, batch_size=LANES, capture=False, **on)
    rec = OpRecorder()
    cap, e = lint.batch_cap(reqs), len(bundle.pipeline.exact_features)
    shards = executors(lint._run)
    for i, x in enumerate(shards):
        wrap_programs(rec, x._slot(LANES // len(shards), cap, e), RUN_PROGRAMS, shard=i)
    owned = [program_lint.owned_storages(x, SLOT_TENSORS) for x in shards]
    lint.serve_batch(reqs, knobs=tight_knobs(bundle, 3))
    f2, facts = lint_records(rec.records, owned, contract_for(name), exe, RUN_PROGRAMS, allowed)
    facts.update(in_place=not moved, weak_type_inputs=len(knobs))
    return exe, findings + f2, facts


def check_continuous(bundle: Any, dev, *, allowed=()) -> list[tuple[str, list, dict]]:
    """The continuous table: the refill and chunk slots."""
    srv = ContinuousBatchedServer(bundle, CFG, batch_size=LANES, chunk_iters=2, device=dev)
    reqs = list(bundle.requests[:3])
    kn = tight_knobs(bundle, 3)
    cap = srv.trace_cap(reqs)
    table = srv.new_table(cap)
    before = table_addresses(table)
    srv.admit(table, cap, [(0, reqs[0], kn[0]), (1, reqs[1], kn[1])])
    for _ in range(2):
        srv.run_chunk(table)
    srv.admit(table, cap, [(2, reqs[2], kn[2])])             # a recycling admission
    srv.new_table(cap)                                        # the bucket's table again
    exe_r, exe_c = f"{bundle.name}/refill", f"{bundle.name}/chunk"
    findings = _compile_contract_findings(srv, f"{bundle.name}/refill+chunk")
    moved = program_lint.check_in_place(before, table_addresses(table), exe_c)
    findings += moved
    if srv.device.type == "cuda":
        findings += sync_debug_findings([("table", table), ("refill", table.src)], exe_c)

    lint = ContinuousBatchedServer(bundle, CFG, batch_size=LANES, chunk_iters=2, capture=False,
                                   device=dev)
    rec = OpRecorder()
    t = lint.new_table(cap)
    wrap_programs(rec, t.src, ("refill.init", "refill.sobol0", "refill.step"))
    wrap_programs(rec, t, ("chunk.step", "refill.write_lane"))
    owned = [program_lint.owned_storages(lint._exe, SLOT_TENSORS)]
    lint.admit(t, cap, [(lane, reqs[lane], kn[lane]) for lane in range(3)])
    _drain(lint, t)
    out = []
    for exe, prefix, programs in ((exe_r, "refill.", ("refill.init", "refill.sobol0",
                                                      "refill.write_lane")),
                                  (exe_c, "chunk.", ("chunk.step",))):
        records = [r for r in rec.records if r.program.startswith(prefix)]
        f2, facts = lint_records(records, owned, contract_for(exe.split("/")[1]), exe,
                                 programs, allowed)
        facts["in_place"] = not moved
        out.append((exe, (findings if prefix == "refill." else []) + f2, facts))
    return out


def check_feature_cache(bundle: Any, dev, *, allowed=()) -> tuple[str, list, dict]:
    """Cache-fed serving: a hit builds no slot, an append stays coherent,
    and the prebuilt programs with ``cold`` and ``refresh`` lint clean."""
    exe = f"{bundle.name}/fused_prebuilt"
    srv = BiathlonServer(bundle, CFG, mode="fused", cache_size=8, device=dev)
    reqs = list(bundle.requests[:3])
    for req in reqs:
        srv.serve(req)
    findings = _compile_contract_findings(srv, exe)
    before = srv.compile_count
    srv.serve(reqs[0])
    hit_clean = srv.compile_count == before
    if not hit_clean:
        findings.append(LintFinding(
            contract="executables_per_bucket", executable=exe, where="<cache hit>",
            message=f"a cache hit built {srv.compile_count - before} slot(s)"))
    oracle = BiathlonServer(bundle, CFG, mode="fused", device=dev)
    t, _c, g = bundle.pipeline.agg_specs(reqs[0])[0]
    table = bundle.store[t]
    table.append({name: [float(np.asarray(col).mean()) + 3.0]
                  for name, col in table.columns.items()}, group_key=g)
    coherence = cache_coherence_findings(srv, oracle, reqs, exe)
    findings += coherence

    lint = BatchedFusedServer(bundle, CFG, batch_size=LANES, cache_size=8, capture=False,
                              device=dev)
    rec = OpRecorder()
    cap, e = lint.batch_cap(reqs), len(bundle.pipeline.exact_features)
    wrap_programs(rec, lint._run._slot(LANES, cap, e), RUN_PROGRAMS)
    lint.cache.cold = rec.wrap("cold", lint.cache.cold)
    lint.cache.refresh = rec.wrap("refresh", lint.cache.refresh)
    owned = [program_lint.owned_storages(lint._run, SLOT_TENSORS)]
    lint.serve_batch(reqs, knobs=tight_knobs(bundle, 3))
    for shift in (1.0, 2.0):                 # appended rows land inside the served prefixes
        table.append({name: [float(np.asarray(col).mean()) + shift]
                      for name, col in table.columns.items()}, group_key=g)
    lint.serve_batch(reqs, knobs=tight_knobs(bundle, 3))
    f2, facts = lint_records(rec.records, owned, contract_for("fused_prebuilt"), exe,
                             RUN_PROGRAMS + ("cold", "refresh"), allowed)
    facts.update(hit_zero_slots=hit_clean, append_coherent=not coherence)
    return exe, findings + f2, facts


def check_recovery(bundle: Any, dev) -> tuple[str, list, dict]:
    """Fault-tolerance probes: rollback, quarantine, store recovery and
    cache integrity on the real servers, deterministic (the probes wreck
    the state directly).  Mutates the store, so it runs last for its
    pipeline."""
    exe = f"{bundle.name}/recovery"
    srv = ContinuousBatchedServer(bundle, tight_config(bundle), batch_size=2, chunk_iters=2,
                                  device=dev)
    reqs = list(bundle.requests[:2])
    f_roll = rollback_findings(srv, reqs, exe)
    f_quar = quarantine_findings(srv, reqs, exe)
    f_cache = cache_integrity_findings(bundle, dev, exe)
    f_store = store_recovery_findings(bundle, exe)
    facts = {
        "contract": "recovery",
        "rollback_bitwise": not f_roll,
        "quarantine_isolated": not f_quar,
        "store_recover_exact": not f_store,
        "cache_corruption_detected": not f_cache,
    }
    return exe, f_roll + f_quar + f_cache + f_store, facts


def tight_config(bundle) -> BiathlonConfig:
    """``CFG`` at 0.1·δ and 8 iterations at most: the small requests iterate
    over several chunks of 2."""
    return dataclasses.replace(CFG, delta=0.1 * bundle.pipeline.delta_default, max_iters=8)


def flatness_steps(dev, cls=FusedExecutor) -> dict[int, list]:
    """The records of one incremental step of a toy executor (linear model,
    k = 3, parametric) at each of :data:`FLATNESS_CAPS`, through the plain
    versions (``use_kernel=False``): a kernel launch hides its work from the
    recorder, the plain version's operators show it.  The holistic rank
    index is left out: by its design it reads a row of cap/128 block counts
    an evaluation (as the reference's does)."""
    w = torch.tensor([1.0, -2.0, 0.5], device=dev)
    steps = {}
    for cap in FLATNESS_CAPS:
        exe = cls(lambda rows, exact: rows @ w, k=3, task="regression", n_classes=2, m=16,
                  m_sobol=8, alpha=0.05, gamma=0.01, tau=0.95, max_iters=8,
                  afc_backend="incremental", holistic=(), quantiles=None, n_boot=16,
                  boot_seed=0, approximate=None, device=dev, use_kernel=False, capture=False)
        rec = OpRecorder()
        wrap_programs(rec, exe._slot(1, cap, 0), RUN_PROGRAMS)
        vals = torch.randn((1, 3, cap), generator=torch.Generator().manual_seed(cap))
        exe(vals, torch.full((1, 3), cap, dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
            1e-6, torch.zeros((1, 0)), iter_cap=1)
        steps[cap] = [r for r in rec.records if r.program == "step"]
    return steps


def check_flatness(dev) -> tuple[str, list, dict]:
    """The incremental step's flatness probe (pipeline-independent)."""
    exe = "probe/incremental_flatness"
    steps = flatness_steps(dev)
    findings = program_lint.check_while_flatness(steps, exe)
    if not all(steps.values()):
        findings.append(LintFinding(contract="coverage", executable=exe, where="step",
                                    message="the probe never ran a step"))
    return exe, findings, {"contract": "fused", "caps": list(FLATNESS_CAPS),
                           "flat": not findings}


# ----------------------------------------------------------------- driver
def run_checks(pipelines: Sequence[str] = DEFAULT_PIPELINES, *, device=None,
               flatness: bool = True, seconds: dict | None = None
               ) -> tuple[list[LintFinding], dict[str, dict]]:
    """Run every check on ``device``; returns ``(findings, facts_by_executable)``.
    ``seconds``, when given, receives the wall seconds of each check."""
    dev = resolve_device(device)
    allowed = allowed_f64()
    findings: list[LintFinding] = []
    facts: dict[str, dict] = {}
    seconds = {} if seconds is None else seconds
    clock = [time.perf_counter()]

    def add(exe, f, fa):
        findings.extend(f)
        facts[exe] = fa
        now = time.perf_counter()
        seconds[exe] = now - clock[0]
        clock[0] = now

    for pname in pipelines:
        bundle = make_pipeline(pname, device=dev, **SMALL)
        add(*check_fused(bundle, dev, allowed=allowed))
        add(*check_fused(bundle, dev, mesh=serving_mesh(dev), allowed=allowed))
        for item in check_continuous(bundle, dev, allowed=allowed):
            add(*item)
        # last for the pipeline: these mutate the store
        add(*check_feature_cache(bundle, dev, allowed=allowed))
        add(*check_recovery(bundle, dev))
    if flatness:
        add(*check_flatness(dev))
    return findings, facts


def baseline_section(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "cpu"


def baseline_diff(facts: dict, baseline_path: Path, section: str,
                  groups: Sequence[str] | None = None) -> list[str]:
    """Unified diff of the observed facts against the baseline's section:
    its executables of the ``groups`` run (``"<pipeline>/..."`` and
    ``"probe/..."``; default: the whole section)."""
    got = json.dumps(facts, indent=2, sort_keys=True).splitlines()
    if not baseline_path.exists():
        return [f"baseline {baseline_path} missing: run with --update-baseline"]
    want = json.loads(baseline_path.read_text()).get(section)
    if want is None:
        return [f"baseline {baseline_path} has no {section!r} section: run with "
                "--update-baseline"]
    if groups is not None:
        want = {k: v for k, v in want.items() if k.split("/")[0] in groups}
    want = json.dumps(want, indent=2, sort_keys=True).splitlines()
    return list(difflib.unified_diff(want, got, fromfile=f"{baseline_path}[{section}]",
                                     tofile="<observed>", lineterm=""))


def run_mutations(device=None) -> int:
    """Run the seeded violations; returns the number NOT caught."""
    from repro_torch.analysis import mutations

    dev = resolve_device(device)
    missed = 0
    for name, fn in mutations.MUTATIONS.items():
        caught = fn(dev)
        print(f"mutation {name:<34s} {'caught' if caught else 'MISSED'}")
        for f in caught[:3]:
            print(f"    {f}")
        missed += not caught
    return missed


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.check",
                                 description="Contract checker for the serving programs.")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--pipelines", default=",".join(DEFAULT_PIPELINES),
                    help="comma-separated pipeline names (data/synthetic.py)")
    ap.add_argument("--baseline", type=Path, default=BASELINE_PATH,
                    help="facts baseline to diff against")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the device's section of the baseline from this run")
    ap.add_argument("--no-flatness", action="store_true",
                    help="skip the incremental step's flatness probe")
    ap.add_argument("--list", action="store_true", help="print the registered contracts")
    ap.add_argument("--mutation-test", action="store_true",
                    help="check that every seeded violation is caught")
    args = ap.parse_args(argv)

    if args.list:
        for name, c in sorted(all_contracts().items()):
            print(f"{name}: {json.dumps(c.as_dict(), indent=2)}")
        return 0
    dev = resolve_device(args.device)
    if args.mutation_test:
        missed = run_mutations(dev)
        if missed:
            print(f"FAIL: {missed} seeded mutation(s) not caught")
            return 1
        print("all seeded mutations caught")
        return 0

    pipelines = tuple(p for p in args.pipelines.split(",") if p)
    seconds: dict[str, float] = {}
    findings, facts = run_checks(pipelines, device=dev, flatness=not args.no_flatness,
                                 seconds=seconds)
    print("seconds by check: " + json.dumps({k: round(v, 3) for k, v in seconds.items()}))
    for f in findings:
        print(f"VIOLATION {f}")
    section = baseline_section(dev)
    groups = pipelines + (() if args.no_flatness else ("probe",))
    rc = 1 if findings else 0
    if args.update_baseline:
        base = json.loads(args.baseline.read_text()) if args.baseline.exists() else {}
        kept = {k: v for k, v in base.get(section, {}).items() if k.split("/")[0] not in groups}
        base[section] = {**kept, **facts}
        args.baseline.write_text(json.dumps(base, indent=2, sort_keys=True) + "\n")
        print(f"baseline written: {args.baseline} [{section}]")
    else:
        diff = baseline_diff(facts, args.baseline, section, groups)
        if diff:
            print("baseline drift:")
            for line in diff:
                print(f"  {line}")
            rc = 1
    print(("FAIL" if rc else "OK") + f": {len(facts)} executables checked on {dev}, "
          f"{len(findings)} violation(s)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
