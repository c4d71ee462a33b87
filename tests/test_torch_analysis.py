"""The port's contract checker: registry, program lint and mutation sensitivity.

Port of ``tests/test_analysis.py``, case by case where the port has a
counterpart (the reference lints jaxprs and HLO; the port records what each
program dispatches when it runs eagerly, ``analysis/program_lint.py``):

1. the registry: contracts registered on import, an identical registration
   a no-op and a conflicting one an error, unknown names, the arithmetic of
   ``assert_compile_contract`` (per shard too), and ``check_compile_contract``
   on the three servers;
2. the lint: RNG, host-sync, float64, knob dtypes, in-place slots, reads
   across shards and the step's flatness, each clean on the real programs
   and flagged on a seeded one;
3. the nine seeded mutations (``analysis/mutations.py``), each caught with a
   finding that names the contract field, including the port's counterparts
   of the two the reference's checker misses (its ``host_callback_in_loop``
   and ``rollback_skips_bootstrap_carry`` tests fail);
4. ``python -m repro_torch.analysis.check --device cpu`` on one pipeline, its
   facts equal to the ``cpu`` section of ``baseline.json``.
"""
import functools
import json

import numpy as np
import pytest
import torch
from serving_fixtures import SMALL_CFG, make_small_bundle
from test_torch_bridge import bundle_to_numpy

from repro_torch.analysis import check, mutations, program_lint
from repro_torch.analysis.contracts import (
    ExecutableContract,
    all_contracts,
    assert_compile_contract,
    contract_for,
    register_contract,
)
from repro_torch.analysis.program_lint import OpRecorder
from repro_torch.bridge import bundle_from_numpy
from repro_torch.core.executor import BiathlonConfig
from repro_torch.launch.mesh import make_serving_mesh, simulated_devices
from repro_torch.serving import (
    BatchedFusedServer,
    BiathlonServer,
    ContinuousBatchedServer,
    LaneKnobs,
)

CPU = torch.device("cpu")
CFG = BiathlonConfig(m=SMALL_CFG.m, m_sobol=SMALL_CFG.m_sobol)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def small_port():
    return bundle_from_numpy(bundle_to_numpy(make_small_bundle()))


# ------------------------------------------------------------- registry
def test_builders_register_their_contracts_on_import():
    names = set(all_contracts())
    assert {"fused", "fused_prebuilt", "afc_precompute", "chunk", "refill",
            "sharded_lanes"} <= names
    assert contract_for("fused").executables_per_bucket == 1
    assert contract_for("fused").collectives == 0
    assert contract_for("sharded_lanes").collectives == 0
    assert contract_for("sharded_lanes").executables_per_bucket == 1
    assert contract_for("chunk").while_body_flat
    assert contract_for("refill").donated
    assert contract_for("afc_precompute").executables_per_bucket == 0  # eager: no slot


def test_reregister_identical_is_noop_conflict_raises():
    c = contract_for("fused")
    assert register_contract(c) is c
    evil = ExecutableContract(name="fused", builder=c.builder, executables_per_bucket=99)
    with pytest.raises(ValueError, match="conflicting contract"):
        register_contract(evil)
    with pytest.raises(ValueError, match="rng"):
        ExecutableContract(name="x", builder="b", executables_per_bucket=1, rng="split")
    with pytest.raises(ValueError, match=">= 0"):
        ExecutableContract(name="x", builder="b", executables_per_bucket=-1)


def test_unknown_contract_names_the_known_ones():
    with pytest.raises(KeyError, match="fused"):
        contract_for("definitely_not_registered")


class _FakeServer:
    def __init__(self, count, buckets, shards=()):
        self.compile_count = count
        self.compiled_buckets = buckets
        self.shard_compile_counts = list(shards)


def test_assert_compile_contract_arithmetic():
    assert_compile_contract(_FakeServer(2, [128, 1024]), "fused")
    assert_compile_contract(_FakeServer(4, [128, 1024]), ("refill", "chunk"))
    assert_compile_contract(_FakeServer(2, [128, 1024]), ("fused_prebuilt", "afc_precompute"))
    assert_compile_contract(_FakeServer(2, [128, 1024], [2, 2]), "sharded_lanes")
    with pytest.raises(AssertionError, match="'fused'"):
        assert_compile_contract(_FakeServer(3, [128, 1024]), "fused")
    with pytest.raises(AssertionError, match="refill"):
        assert_compile_contract(_FakeServer(5, [128, 1024]), ("refill", "chunk"))
    with pytest.raises(AssertionError, match="cap buckets"):
        assert_compile_contract(_FakeServer(2, [128, 1024]), "fused", buckets=[128, 2048])
    with pytest.raises(AssertionError, match="on shard 1"):
        assert_compile_contract(_FakeServer(2, [128, 1024], [2, 3]), "sharded_lanes")


def test_check_compile_contract_on_all_three_servers():
    port = small_port()
    single = BiathlonServer(port, CFG, device="cpu")
    single.serve({"g": 0})
    single.check_compile_contract(buckets=[128])
    cached = BiathlonServer(port, CFG, cache_size=4, device="cpu")
    cached.serve({"g": 0})
    cached.serve({"g": 0})                     # a hit builds nothing
    cached.check_compile_contract(buckets=[128])
    batched = BatchedFusedServer(port, CFG, batch_size=4, device="cpu")
    batched.serve_batch([{"g": 0}])
    batched.check_compile_contract(buckets=[128])
    sharded = BatchedFusedServer(port, CFG, batch_size=4,
                                 mesh=make_serving_mesh(devices=simulated_devices(2, "cpu")))
    sharded.serve_batch([{"g": 0}, {"g": 1}, {"g": 2}])
    sharded.check_compile_contract(buckets=[128])
    cont = ContinuousBatchedServer(port, CFG, batch_size=2, chunk_iters=2, device="cpu")
    table = cont.new_table(128)
    cont.admit(table, 128, [(0, {"g": 0}, None)])
    cont.run_chunk(table)
    cont.check_compile_contract(buckets=[128])
    # an untracked slot breaks each server's contract
    for srv, exe, name in ((single, single._fused, "'fused'"), (batched, batched._run, "'fused'"),
                           (sharded, sharded._run.shards[0].exe, "sharded_lanes"),
                           (cont, cont._exe, "refill")):
        exe.slots_built += 1
        with pytest.raises(AssertionError, match=name):
            srv.check_compile_contract()


# --------------------------------------------------------------- the lint
def _recorded(fn, program="step"):
    rec = OpRecorder()
    with rec.scope(program):
        fn()
    return rec.records


def _toy_records(**overrides):
    exe = mutations._toy(CPU, **overrides)
    agg = (0, 5, 0) if overrides.get("holistic") else (0, 0, 0)
    rec, _ = mutations._recorded_run([exe], exe, *mutations._inputs(agg=agg))
    return rec.records


def test_threefry_bootstrap_is_counter_based_and_generator_draws_are_flagged():
    records = _toy_records(holistic=(1,), quantiles=(0.5,))
    assert {"init", "sobol0", "step"} <= {r.program for r in records}
    assert program_lint.check_rng(records, "good/threefry") == []
    gen = torch.Generator().manual_seed(0)
    bad = _recorded(lambda: torch.randn(4, generator=gen) + torch.rand(4))
    found = program_lint.check_rng(bad, "bad/generator")
    assert len(found) == 2 and all(f.contract == "rng" for f in found)


def test_read_back_in_the_step_is_flagged_as_per_iteration():
    records = _toy_records()
    assert program_lint.check_host_sync(records, "good/step") == []
    x = torch.arange(6.0)
    bad = _recorded(lambda: (float(x.sum()), torch.nonzero(x > 2), x[x > 1]))
    found = program_lint.check_host_sync(bad, "bad/reads")
    assert {f.where.split(":")[1].split(".")[1] for f in found} >= {
        "_local_scalar_dense", "nonzero"}
    assert all("loop body" in f.message for f in found)
    other = program_lint.check_host_sync(_recorded(lambda: float(x.sum()), "init"), "bad/init")
    assert other and "loop body" not in other[0].message


def test_float64_outside_the_allowed_sites_is_flagged():
    records = _toy_records()
    allowed = check.allowed_f64()
    found, seen = program_lint.check_f64(records, "good/toy", allowed)
    assert found == [] and seen and set(seen) <= set(allowed)
    bad = _recorded(lambda: torch.ones(3, dtype=torch.float64).sum())
    found, seen = program_lint.check_f64(bad, "bad/f64", allowed)
    assert found and all(f.contract == "allow_f64" for f in found)
    assert "None aten.ones.default" in seen      # no site of the port called it


def test_knobs_of_other_types_keep_the_slot_dtypes():
    port = small_port()
    srv = BatchedFusedServer(port, CFG, batch_size=4, device="cpu")
    reqs = [{"g": g} for g in range(3)]
    srv.serve_batch(reqs)
    assert check.knob_findings(srv, reqs, "good/knobs") == []
    assert srv.compile_count == 1
    kn = LaneKnobs(delta=0.5, tau=0.95, iter_cap=64)   # pinned at construction
    assert (kn.delta.dtype, kn.tau.dtype, kn.iter_cap.dtype) == (np.float32, np.float32,
                                                                 np.int32)
    found = program_lint.check_dtypes({"delta": torch.float64}, {"delta": torch.float32}, "bad")
    assert found and found[0].contract == "weak_type_inputs"


def test_slots_are_written_in_place_and_a_rebinding_is_flagged():
    port = small_port()
    srv = BatchedFusedServer(port, CFG, batch_size=4, device="cpu")
    srv.serve_batch([{"g": 0}])
    before = check.slot_addresses(srv._run)
    srv.serve_batch([{"g": g} for g in range(3)], knobs=[LaneKnobs(0.2, 0.9, 3)] * 3)
    assert program_lint.check_in_place(before, check.slot_addresses(srv._run), "good") == []
    slot = next(iter(srv._run._slots.values()))
    slot.delta = slot.delta.clone()
    found = program_lint.check_in_place(before, check.slot_addresses(srv._run), "bad")
    assert [f.where.rsplit("/", 1)[1] for f in found] == ["delta"]


def test_shards_read_only_their_own_tensors():
    mesh = make_serving_mesh(devices=simulated_devices(2, "cpu"))
    run = mutations.shard_lanes_executor(lambda d: mutations._toy(d), mesh)
    exes = [sh.exe for sh in run.shards]
    rec, owned = mutations._recorded_run(exes, run, *mutations._inputs())
    assert {r.shard for r in rec.records} == {0, 1}
    assert program_lint.check_collectives(rec.records, owned, "good/shards") == []


def test_step_is_flat_in_the_cap_and_a_cap_sized_op_is_flagged():
    steps = check.flatness_steps(CPU)
    assert all(steps.values()) and program_lint.check_while_flatness(steps, "good") == []
    bad = {cap: _recorded(lambda cap=cap: torch.zeros(cap).cumsum(0)) for cap in (64, 256)}
    found = program_lint.check_while_flatness(bad, "bad/scan")
    assert found and found[0].contract == "while_body_flat"


# ------------------------------------------------------------ mutations
@pytest.mark.parametrize("name", sorted(mutations.MUTATIONS))
def test_seeded_mutation_is_caught(name):
    findings = mutations.MUTATIONS[name](CPU)
    assert findings, f"checker is blind to seeded mutation {name!r}"
    for f in findings:
        assert f.contract and f.message and f.executable and f.where


def test_mutation_messages_name_the_contract_field():
    by_name = {
        "injected_collective": "collectives",
        "split_rng_bootstrap": "rng",
        "dropped_donation": "donated",
        "weak_type_knob": "weak_type_inputs",
        "host_callback_in_loop": "host_sync",
        "cap_leak_in_loop_body": "while_body_flat",
        "stale_cache_read": "cache_version_key",
        "rollback_skips_bootstrap_carry": "rollback_replay",
        "quarantine_readmit_without_reset": "quarantine_isolation",
    }
    assert set(by_name) == set(mutations.MUTATIONS)
    for name in ("injected_collective", "host_callback_in_loop", "weak_type_knob"):
        found = mutations.MUTATIONS[name](CPU)
        assert all(f.contract == by_name[name] for f in found), (name, found)
    found = mutations.MUTATIONS["host_callback_in_loop"](CPU)
    assert all(f.where.startswith("step:") and "loop body" in f.message for f in found)


# ------------------------------------------------------------ the command
def test_check_command_on_one_pipeline_matches_the_baseline(capsys):
    """The checker on turbofan and the flatness probe: no finding, facts
    equal to the baseline's cpu section; ``--list`` prints every contract."""
    assert check.main(["--device", "cpu", "--pipelines", "turbofan"]) == 0
    out = capsys.readouterr().out
    assert "OK: 7 executables checked on cpu, 0 violation(s)" in out
    assert "baseline drift" not in out and "VIOLATION" not in out
    base = json.loads(check.BASELINE_PATH.read_text())["cpu"]
    assert base["turbofan/sharded_lanes"]["collectives"] == 0
    assert base["probe/incremental_flatness"]["flat"]
    assert all(f["in_place"] for f in base.values() if "in_place" in f)
    assert check.main(["--device", "cpu", "--list"]) == 0
    listed = capsys.readouterr().out
    assert all(f"{name}: " in listed for name in all_contracts())
