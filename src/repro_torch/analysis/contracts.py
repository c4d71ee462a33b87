"""Executable contracts: declared invariants of the serving programs.

Port of ``repro/analysis/contracts.py`` (the port keeps its own copy, with
no import of the JAX package).  A contract is the machine-readable half of
a builder's docstring: how many slots (on the card, one capture of a set
of CUDA graphs each) its owning server may build per power-of-two cap
bucket, whether a program may read another shard's tensors, which slot
tensors must be written in place, and what RNG its programs may use.
Builders declare their contract next to the code it constrains
(``core/executor_fused.py`` calls :func:`register_contract` at import
time), and three consumers read the registry:

* the checker (``repro_torch.analysis.check``) records what each program
  dispatches and checks it against the contract, then diffs the facts
  against the checked-in ``baseline.json``;
* the servers' ``check_compile_contract`` and the tests assert their slot
  counts through :func:`assert_compile_contract`, so a test and the
  checker never disagree on what "no rebuilds" means;
* readers, through ``python -m repro_torch.analysis.check --list``.

The fields, as the port reads them:

``executables_per_bucket``
    slots per cap bucket (a sharded bucket: one slot on every shard counts
    once, and each shard's own count is held to the same number).
``collectives``
    reads of another shard's tensors, copies between devices and
    ``torch.distributed`` operations inside a program: 0.
``donated``
    the slot tensors a run writes in place (the captured graphs read their
    addresses): they keep their addresses across batches of one bucket.
``rng``
    ``"counter_based"``: no PyTorch RNG operator inside a program; the
    bootstrap draws come from ``core/threefry.py`` keyed on the lane's
    ``it``.  ``"free"`` lifts the restriction.
``weak_type_inputs``
    False: a knob given as a Python or numpy scalar of another type reaches
    the slot in the slot's dtype and builds no slot.
``allow_f64``
    False: no float64 slot tensor, program input or output, but the sites
    ``baseline.json`` allows by name.
``while_body_flat``
    a step of the incremental AFC path dispatches the same operators with
    the same output sizes at two caps.
"""
from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass, fields
from typing import Any

__all__ = [
    "ExecutableContract",
    "all_contracts",
    "assert_compile_contract",
    "contract_for",
    "register_contract",
]

#: RNG disciplines a contract can demand of its programs.
RNG_COUNTER_BASED = "counter_based"
RNG_FREE = "free"


@dataclass(frozen=True)
class ExecutableContract:
    """Invariants one program builder promises (see the module docstring)."""

    name: str
    builder: str
    executables_per_bucket: int
    collectives: int = 0
    donated: tuple[str, ...] = ()
    rng: str = RNG_COUNTER_BASED
    weak_type_inputs: bool = False
    allow_f64: bool = False
    while_body_flat: bool = False
    description: str = ""

    def __post_init__(self) -> None:
        if self.executables_per_bucket < 0:
            raise ValueError(f"contract {self.name!r}: executables_per_bucket must be >= 0")
        if self.collectives < 0:
            raise ValueError(f"contract {self.name!r}: collectives must be >= 0")
        if self.rng not in (RNG_COUNTER_BASED, RNG_FREE):
            raise ValueError(
                f"contract {self.name!r}: rng must be {RNG_COUNTER_BASED!r} or {RNG_FREE!r}, "
                f"got {self.rng!r}")

    def as_dict(self) -> dict[str, Any]:
        d = {f.name: getattr(self, f.name) for f in fields(self)}
        d["donated"] = list(self.donated)
        return d


_REGISTRY: dict[str, ExecutableContract] = {}


def register_contract(contract: ExecutableContract) -> ExecutableContract:
    """Register a builder's contract; returns it for inline declaration.

    Registering the identical contract again is a no-op (a module may be
    imported again); a conflicting contract under a registered name raises.
    """
    prev = _REGISTRY.get(contract.name)
    if prev is not None and prev != contract:
        raise ValueError(
            f"conflicting contract registration for {contract.name!r}: {prev} vs {contract}")
    _REGISTRY[contract.name] = contract
    return contract


def contract_for(name: str) -> ExecutableContract:
    """The registered contract, or an error naming what is registered."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no contract registered under {name!r}; known: {sorted(_REGISTRY)} (builders "
            "register at import time: import the owning module first)") from None


def all_contracts() -> dict[str, ExecutableContract]:
    """Snapshot of the registry (name -> contract), in declaration order."""
    return dict(_REGISTRY)


def assert_compile_contract(
    server: Any,
    name: str | Sequence[str],
    *,
    buckets: Sequence[int] | None = None,
) -> None:
    """Assert a server's slot counts match its contract(s).

    The one place the expected-slot arithmetic lives: a server with
    ``compile_count`` (slots built) and ``compiled_buckets`` (cap buckets
    served) must satisfy

        compile_count == sum(executables_per_bucket) * len(compiled_buckets)

    and, where it has ``shard_compile_counts`` (a server over a mesh), so
    must every shard's own count.  ``name`` is a contract name or a sequence
    of them, whose per-bucket budgets add up (the continuous table's refill
    and chunk).  ``buckets`` also pins the bucket list.  Raises
    ``AssertionError`` naming the contract(s).
    """
    names = (name,) if isinstance(name, str) else tuple(name)
    cs = [contract_for(n) for n in names]
    got_buckets = list(server.compiled_buckets)
    per_bucket = sum(c.executables_per_bucket for c in cs)
    expected = per_bucket * len(got_buckets)
    label = " + ".join(repr(c.name) for c in cs)
    builders = ", ".join(sorted({c.builder for c in cs}))
    counts = [("", int(server.compile_count))]
    counts += [(f" on shard {i}", int(c))
               for i, c in enumerate(getattr(server, "shard_compile_counts", ()))]
    for where, observed in counts:
        if observed != expected:
            raise AssertionError(
                f"contract {label} (builder {builders}) violated{where}: {observed} slots "
                f"built for {len(got_buckets)} cap bucket(s) {got_buckets}, contract allows "
                f"{per_bucket} per bucket = {expected}")
    if buckets is not None and got_buckets != sorted(buckets):
        raise AssertionError(
            f"contract {label}: served cap buckets {got_buckets} != expected {sorted(buckets)}")
