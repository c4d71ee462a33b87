"""Seeded contract violations: the checker's sensitivity tests.

Port of ``repro/analysis/mutations.py``.  A checker that never fires is
indistinguishable from one that cannot fire.  Each function here builds a
deliberately broken variant of a real serving pattern, the regressions the
contracts exist to stop, runs the check that should catch it, and returns
its findings; an empty list means the checker missed it.  ``python -m
repro_torch.analysis.check --mutation-test`` and
``tests/test_torch_analysis.py`` fail on a miss.

The mutants subclass or wrap the real executor, cache and servers; the real
code is never edited.  Most run on a toy executor (a linear model over k = 3
features, m = 16, m_sobol = 8), small enough to run eagerly in milliseconds.
Each takes the device to run on.
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from repro_torch.analysis import program_lint
from repro_torch.analysis.program_lint import LintFinding, OpRecorder, wrap_programs
from repro_torch.core.executor_fused import FusedExecutor, shard_lanes_executor
from repro_torch.kernels.sampled_agg.ops import masked_estimates
from repro_torch.launch.mesh import make_serving_mesh, simulated_devices

__all__ = ["MUTATIONS"]

_K = 3
_LANES = 4
_CAP = 256
_RUN = ("init", "sobol0", "step")


def _toy(dev, cls=FusedExecutor, **overrides) -> FusedExecutor:
    """A toy executor of class ``cls``, eager, on ``dev``."""
    w = torch.tensor([1.0, -2.0, 0.5], device=dev)
    kw = dict(k=_K, task="regression", n_classes=2, m=16, m_sobol=8, alpha=0.05, gamma=0.01,
              tau=0.95, max_iters=8, afc_backend="auto", holistic=(), quantiles=None, n_boot=16,
              boot_seed=0, approximate=None, device=dev, use_kernel=True, capture=False)
    kw.update(overrides)
    return cls(lambda rows, exact: rows @ w, **kw)


def _inputs(agg=(0, 0, 0), lanes: int = _LANES, cap: int = _CAP):
    """Seeded toy batch: ``(vals, n, agg_ids, delta, exact)``, a tight δ so
    every lane iterates."""
    vals = torch.randn((lanes, _K, cap), generator=torch.Generator().manual_seed(7))
    n = torch.full((lanes, _K), cap, dtype=torch.int32)
    n[1::2] = cap // 2
    return vals, n, torch.tensor(agg, dtype=torch.int32), 1e-3, torch.zeros((lanes, 0))


def _recorded_run(exes, run, *args, **kwargs) -> tuple[OpRecorder, list]:
    """``run(*args)`` with the programs of each of ``exes`` recorded; with
    the storages each executor holds through the run."""
    from repro_torch.analysis.check import SLOT_TENSORS

    rec = OpRecorder()
    per = args[0].shape[0] // len(exes)
    for i, exe in enumerate(exes):
        wrap_programs(rec, exe._slot(per, args[0].shape[-1], args[4].shape[-1]), _RUN, shard=i)
    owned = [program_lint.owned_storages(x, SLOT_TENSORS) for x in exes]
    run(*args, **kwargs)
    return rec, owned


# ----------------------------------------------------------------- mutants
class _PeekingStep(FusedExecutor):
    """Shard 0's step reads a tensor of shard 1's slot."""

    peer: FusedExecutor | None = None

    def _step(self, s):
        super()._step(s)
        other = next(iter(self.peer._slots.values()))
        s.y_hat.add_(other.y_hat * 0.0)


def injected_collective(dev) -> list[LintFinding]:
    """One shard's step reads another shard's tensor, on a 2-shard mesh
    simulated on ``dev``: cross-shard traffic on the hot path, which
    re-serialises every step on the slowest shard (and on two cards is a
    copy between them).  The storage check of the programs must see it."""
    mesh = make_serving_mesh(devices=simulated_devices(2, dev))
    made = iter([_toy(dev, _PeekingStep), _toy(dev)])
    run = shard_lanes_executor(lambda d: next(made), mesh)
    exes = [sh.exe for sh in run.shards]
    exes[0].peer = exes[1]
    rec, owned = _recorded_run(exes, run, *_inputs())
    return program_lint.check_collectives(rec.records, owned, "mutant/peeking_step")


class _GeneratorBootstrap(FusedExecutor):
    """Bootstrap keys drawn from a ``torch.Generator`` at every evaluation."""

    def _afc(self, s, z, it):
        gen = torch.Generator(device=self.device).manual_seed(0)
        table = self.key_table
        self.key_table = torch.randint(0, 2 ** 31 - 1, table.shape, generator=gen,
                                       dtype=table.dtype, device=self.device)
        try:
            return super()._afc(s, z, it)
        finally:
            self.key_table = table


def split_rng_bootstrap(dev) -> list[LintFinding]:
    """The holistic bootstrap draws come from a ``torch.Generator`` instead of
    threefry keyed on the lane's ``it``: a request's draws then depend on the
    generator's history, which breaks recycled-lane and rollback parity."""
    exe = _toy(dev, _GeneratorBootstrap, holistic=(1,), quantiles=(0.5,))
    rec, _ = _recorded_run([exe], exe, *_inputs(agg=(0, 5, 0)))
    return program_lint.check_rng(rec.records, "mutant/generator_bootstrap")


class _RebindingKnobs(FusedExecutor):
    """``_set_knobs`` copies a knob into a new tensor instead of the slot's."""

    def _set_knobs(self, s, agg_ids, delta, exact, active, tau, iter_cap):
        super()._set_knobs(s, agg_ids, delta, exact, active, tau, iter_cap)
        s.tau = s.tau.clone()


def dropped_donation(dev) -> list[LintFinding]:
    """A run rebinds a slot tensor (the knob ``tau``) instead of writing it
    in place: the captured graphs would go on reading the old tensor.  The
    addresses across two runs of one bucket must show it."""
    exe = _toy(dev, _RebindingKnobs)
    args = _inputs()
    exe(*args)
    slot = next(iter(exe._slots.values()))
    before = program_lint.slot_addresses(slot)
    exe(*args)
    return program_lint.check_in_place(before, program_lint.slot_addresses(slot),
                                       "mutant/rebinding_knobs")


class _Float64Knob(FusedExecutor):
    """``_set_knobs`` stores δ as a new float64 tensor, as given."""

    def _set_knobs(self, s, agg_ids, delta, exact, active, tau, iter_cap):
        super()._set_knobs(s, agg_ids, delta, exact, active, tau, iter_cap)
        s.delta = torch.full(s.delta.shape, float(delta), dtype=torch.float64,
                             device=self.device)


def weak_type_knob(dev) -> list[LintFinding]:
    """A knob given as a Python float reaches the slot as float64: the graphs
    would be captured over a tensor of another dtype than the slot's, and the
    step computes in float64.  The slot's dtypes after a run must show it."""
    exe = _toy(dev, _Float64Knob)
    vals, n, agg, _, exact = _inputs()
    slot = exe._slot(_LANES, _CAP, 0)
    want = program_lint.slot_dtypes(slot)
    exe(vals, n, agg, 1e-3, exact)                       # the knob as a Python float
    return program_lint.check_dtypes(program_lint.slot_dtypes(slot), want, "mutant/float64_knob")


class _ReadingStep(FusedExecutor):
    """A debug read of the lanes' best probability inside the step."""

    def _step(self, s):
        super()._step(s)
        float(s.prob.max())


def host_callback_in_loop(dev) -> list[LintFinding]:
    """``.item()`` inside the step program: a read-back every iteration of
    the hot loop, which a captured graph cannot hold at all.  The host-sync
    lint must flag it in the loop body."""
    exe = _toy(dev, _ReadingStep)
    rec, _ = _recorded_run([exe], exe, *_inputs())
    return program_lint.check_host_sync(rec.records, "mutant/reading_step")


class _RescanningAfc(FusedExecutor):
    """The incremental step also rescans the ``(L, k, cap)`` buffer."""

    def _afc(self, s, z, it):
        value, sigma, reps = super()._afc(s, z, it)
        if s.incremental:
            value, _ = masked_estimates(s.vals, z, s.n, s.agg, use_kernel=self.use_kernel)
        return value, sigma, reps


def cap_leak_in_loop_body(dev) -> list[LintFinding]:
    """O(cap) work leaked into the incremental step (a rescan of the prefix
    buffer every evaluation): the step at caps 2048 and 8192 must differ."""
    from repro_torch.analysis.check import flatness_steps

    return program_lint.check_while_flatness(flatness_steps(dev, _RescanningAfc),
                                             "mutant/rescanning_step")


def _small(name: str, dev):
    from repro_torch.data.synthetic import make_pipeline

    return make_pipeline(name, rows_per_group=120, n_train_groups=20, n_serve_groups=2,
                         n_requests=2, device=dev)


class _VersionlessStore:
    """The store as a cache sees it, with every group at version 0."""

    def __init__(self, store):
        self._store = store

    def __getattr__(self, name):
        return getattr(self._store, name)

    def __getitem__(self, table):
        return self._store[table]

    def spec_versions(self, specs):
        return tuple(0 for _ in specs)


def stale_cache_read(dev) -> list[LintFinding]:
    """A feature cache keyed without group versions: an append leaves a
    stale entry resident and a later hit serves pre-append aggregates.  The
    append-coherence probe must see the cached server diverge from an
    uncached oracle."""
    from repro_torch.analysis.check import cache_coherence_findings
    from repro_torch.core.executor import BiathlonConfig
    from repro_torch.data.store import bucket_size
    from repro_torch.serving import BiathlonServer

    b = _small("turbofan", dev)
    cfg = BiathlonConfig(m=32, m_sobol=8, n_bootstrap=16)
    srv = BiathlonServer(b, cfg, mode="fused", cache_size=4, device=dev)
    srv.cache.store = _VersionlessStore(srv.cache.store)   # the seeded bug
    req = b.requests[0]
    srv.serve(req)
    t, _c, g = b.pipeline.agg_specs(req)[0]
    table = b.store[t]
    # grow the group without crossing its bucket (a new cap is a new key)
    n = table.group_size(g)
    grow = max(1, min(6, bucket_size(n) - n))
    table.append({name: [float(np.asarray(col).mean()) + 5.0] * grow
                  for name, col in table.columns.items()}, group_key=np.full(grow, g))
    oracle = BiathlonServer(b, cfg, mode="fused", device=dev)
    return cache_coherence_findings(srv, oracle, [req], "mutant/stale_cache_read")


def rollback_skips_bootstrap_carry(dev) -> list[LintFinding]:
    """A chunk rollback that does not restore ``it``, the lane's iteration
    count and the index of its bootstrap keys: the replay draws other
    replicate ranks and stops at other iterations.  ``sensor_health``
    (holistic) at 0.1·δ, so the keys are on the path and the lanes iterate
    past the failed chunk; the bitwise rollback probe must see it."""
    from repro_torch.analysis.check import rollback_findings, tight_config
    from repro_torch.serving import ContinuousBatchedServer

    b = _small("sensor_health", dev)
    srv = ContinuousBatchedServer(b, tight_config(b), batch_size=2, chunk_iters=2, device=dev)
    return rollback_findings(srv, list(b.requests[:2]), "mutant/rollback_skips_it",
                             skip_restore=("it",))


def quarantine_readmit_without_reset(dev) -> list[LintFinding]:
    """A quarantine that re-admits a poisoned lane by flipping its flags back
    to live with the poisoned carry kept: the scrambled plan and NaN
    prediction leak into the recovered request.  The quarantine probe must
    see the lane diverge from its never-poisoned run."""
    from repro_torch.analysis.check import quarantine_findings, tight_config
    from repro_torch.serving import ContinuousBatchedServer

    b = _small("turbofan", dev)
    srv = ContinuousBatchedServer(b, tight_config(b), batch_size=2, chunk_iters=2, device=dev)
    return quarantine_findings(srv, list(b.requests[:2]), "mutant/quarantine_no_reset",
                               reset_on_readmit=False)


#: name -> builder(device); each must return >= 1 finding or the checker is blind.
MUTATIONS: dict[str, Callable[[torch.device], list[LintFinding]]] = {
    "injected_collective": injected_collective,
    "split_rng_bootstrap": split_rng_bootstrap,
    "dropped_donation": dropped_donation,
    "weak_type_knob": weak_type_knob,
    "host_callback_in_loop": host_callback_in_loop,
    "cap_leak_in_loop_body": cap_leak_in_loop_body,
    "stale_cache_read": stale_cache_read,
    "rollback_skips_bootstrap_carry": rollback_skips_bootstrap_carry,
    "quarantine_readmit_without_reset": quarantine_readmit_without_reset,
}
