"""Lint of the port's serving programs: what each dispatches when run eagerly.

Port of ``repro/analysis/jaxpr_lint.py`` and ``hlo_lint.py``, in one
module.  The reference lints traced jaxprs and compiled HLO; the port's
programs (the z⁰, Saltelli and step programs of a slot, the continuous
table's refill and chunk, the cache's ``cold`` and ``refresh``) are Python
functions that a CUDA graph captures once, so the port runs each of them
once **eagerly** (``capture=False``) under :class:`OpRecorder`, a
``TorchDispatchMode`` that records every aten operator they dispatch: its
name, the storages and devices of its tensor inputs, the shapes and dtypes
of its outputs, and, for an operator that touches float64, the port's
function that called it.  The checks below read those records, so they run
on the CPU (tier-1) as on the card.

Every finding is a :class:`LintFinding` whose ``contract`` names the
contract field it violates (``contracts.ExecutableContract``) or the
runtime invariant a probe of ``check.py`` holds.
"""
from __future__ import annotations

import contextlib
import functools
import sys
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Callable, Iterable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = [
    "LintFinding",
    "OpRecord",
    "OpRecorder",
    "check_collectives",
    "check_dtypes",
    "check_f64",
    "check_host_sync",
    "check_in_place",
    "check_rng",
    "check_while_flatness",
    "owned_storages",
    "slot_addresses",
    "slot_dtypes",
    "wrap_programs",
]

_PKG = Path(__file__).resolve().parents[1]          # .../repro_torch

#: aten operators that draw from PyTorch's generators (base names, trailing
#: ``_`` dropped): a program that dispatches one is not counter-based.
RNG_OPS = frozenset({
    "normal", "uniform", "bernoulli", "rand", "randn", "randint", "randperm",
    "rand_like", "randn_like", "randint_like", "multinomial", "exponential", "random",
    "poisson", "geometric", "cauchy", "log_normal", "native_dropout",
})
#: aten operators that read a device value back to the host (a sync).
HOST_SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "is_nonzero", "nonzero", "nonzero_static",
    "masked_select", "equal", "allclose",
})
#: the loop bodies: a finding there is paid every iteration.
LOOP_PROGRAMS = frozenset({"step", "chunk.step"})


@dataclass(frozen=True)
class LintFinding:
    """One contract violation: which contract field, in which program of
    which executable, where, and what."""

    contract: str
    executable: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.contract}] {self.executable} @ {self.where}: {self.message}"


@dataclass(frozen=True)
class OpRecord:
    """One aten operator a program dispatched."""

    program: str
    shard: int
    op: str                                   # e.g. "aten.add.Tensor"
    inputs: tuple[tuple[str, int], ...]       # (device, storage address) of tensor inputs
    out_shapes: tuple[tuple[int, ...], ...]   # of the outputs that are not views
    out_devices: tuple[str, ...]              # of every tensor output
    dtypes: tuple[torch.dtype, ...]           # of every tensor input and output
    site: str | None                          # "core/guarantee.py::guarantee_prob" for f64

    @property
    def base(self) -> str:
        """``add`` of ``aten.add.Tensor``; ``normal`` of ``aten.normal_``."""
        parts = self.op.split(".")
        return (parts[1] if len(parts) > 1 else parts[0]).rstrip("_")


def _storage(t: torch.Tensor) -> tuple[str, int]:
    return str(t.device), t.untyped_storage().data_ptr()


@functools.lru_cache(maxsize=512)
def _port_file(filename: str) -> str | None:
    """``filename`` relative to ``repro_torch/``, or None outside the port
    (and for this package)."""
    path = Path(filename).resolve()
    if _PKG in path.parents and "analysis" not in path.relative_to(_PKG).parts:
        return path.relative_to(_PKG).as_posix()
    return None


def _site() -> str | None:
    """The innermost frame of the port outside this package: file relative
    to ``repro_torch/`` and function."""
    frame = sys._getframe(1)
    while frame is not None:
        rel = _port_file(frame.f_code.co_filename)
        if rel is not None:
            return f"{rel}::{frame.f_code.co_name}"
        frame = frame.f_back
    return None


class OpRecorder(TorchDispatchMode):
    """Records every aten operator dispatched while it is entered, under the
    program and shard :meth:`scope` names.  Enter it only around a program:
    ``with rec.scope("step", shard=0): program(slot)``."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []
        self._program, self._shard = "?", 0
        self._seen: set[tuple[str, int]] = set()

    @contextlib.contextmanager
    def scope(self, program: str, shard: int = 0):
        prev = self._program, self._shard
        self._program, self._shard = program, shard
        try:
            with self:
                yield
        finally:
            self._program, self._shard = prev

    def wrap(self, program: str, fn: Callable, shard: int = 0) -> Callable:
        """``fn`` recorded under ``program`` at its first call (a program
        dispatches the same operators at every call: its checks need one)."""
        def recorded(*args, **kwargs):
            if (program, shard) in self._seen:
                return fn(*args, **kwargs)
            self._seen.add((program, shard))
            with self.scope(program, shard):
                return fn(*args, **kwargs)
        return recorded

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        views = [r.alias_info is not None and not r.alias_info.is_write
                 for r in func._schema.returns]
        shapes = tuple(tuple(t.shape) for i, t in enumerate(outs)
                       if not (i < len(views) and views[i]))
        dtypes = tuple(t.dtype for t in ins + outs)
        site = _site() if torch.float64 in dtypes else None
        self.records.append(OpRecord(
            program=self._program, shard=self._shard, op=str(func),
            inputs=tuple(_storage(t) for t in ins if t.numel()), out_shapes=shapes,
            out_devices=tuple(str(t.device) for t in outs), dtypes=dtypes, site=site))
        return out


def wrap_programs(rec: OpRecorder, slot: SimpleNamespace, names: Sequence[str],
                  shard: int = 0) -> None:
    """Record an eager slot's programs (``slot.programs``, as
    ``FusedExecutor._launch`` calls them) under ``names``."""
    slot.programs = tuple(rec.wrap(name, fn, shard) for name, fn in zip(names, slot.programs))


# ------------------------------------------------------------------ checks
def check_rng(records: Iterable[OpRecord], exe: str) -> list[LintFinding]:
    """``rng``: no PyTorch RNG operator inside a program."""
    return [LintFinding(
        contract="rng", executable=exe, where=f"{r.program}:{r.op}",
        message=("a PyTorch RNG operator inside a program: its draws depend on the "
                 "generator's state, not on the lane's it, so a request recycled into "
                 "another lane or replayed after a rollback draws other bootstrap ranks "
                 "(use core/threefry keyed on it)"),
    ) for r in records if r.base in RNG_OPS]


def check_host_sync(records: Iterable[OpRecord], exe: str) -> list[LintFinding]:
    """Host sync: no read-back (``.item()``, ``nonzero``, ``masked_select``,
    a copy from a card to the host) inside a program; one in a loop body is
    paid every iteration."""
    out = []
    for r in records:
        d2h = any(d.startswith("cuda") for d, _ in r.inputs) and "cpu" in r.out_devices
        if r.base in HOST_SYNC_OPS or d2h:
            loop = " in the loop body (every iteration)" if r.program in LOOP_PROGRAMS else ""
            out.append(LintFinding(
                contract="host_sync", executable=exe, where=f"{r.program}:{r.op}",
                message=(f"a read-back to the host{loop}: a captured program cannot "
                         "hold one, and an eager one stalls the card until it is done")))
    return out


def check_f64(records: Iterable[OpRecord], exe: str,
              allowed: Iterable[str]) -> tuple[list[LintFinding], list[str]]:
    """``allow_f64``: float64 only at the allowed ``site op`` keys.  Returns
    the findings and the sorted keys seen (the checker's facts)."""
    allowed = set(allowed)
    seen = sorted({f"{r.site} {r.op}" for r in records if torch.float64 in r.dtypes})
    return [LintFinding(
        contract="allow_f64", executable=exe, where=key,
        message="a float64 operator outside the allowed sites of baseline.json "
                "(the stack is float32; the degenerate-sigma indicator is the exception)",
    ) for key in seen if key not in allowed], seen


def check_dtypes(slot_dtypes: dict[str, torch.dtype], expected: dict[str, torch.dtype],
                 exe: str) -> list[LintFinding]:
    """``weak_type_inputs``: after knobs given as Python or numpy scalars of
    other types, every slot tensor keeps its fixed dtype."""
    return [LintFinding(
        contract="weak_type_inputs", executable=exe, where=name,
        message=(f"slot tensor {name} became {dt} (fixed: {expected[name]}) after a knob "
                 "given as a Python or numpy scalar: the graphs read the fixed tensor, and "
                 "a float64 knob is a float64 slot buffer"),
    ) for name, dt in slot_dtypes.items() if name in expected and dt != expected[name]]


def check_in_place(before: dict[str, int], after: dict[str, int], exe: str) -> list[LintFinding]:
    """``donated``: every slot tensor keeps its address (a captured graph
    reads the address it was captured with)."""
    return [LintFinding(
        contract="donated", executable=exe, where=name,
        message=("slot tensor rebound between runs of one bucket: the captured graphs "
                 "would go on reading the old tensor"),
    ) for name, ptr in before.items() if after.get(name) != ptr]


def check_collectives(records: Iterable[OpRecord], owned: Sequence[set],
                      exe: str) -> list[LintFinding]:
    """``collectives``: shard i's programs read no storage that shard j owns
    and shard i does not (``owned[j]``, :func:`owned_storages`: shards of a
    simulated mesh may share a read-only constant), copy nothing between
    two cards and run no ``torch.distributed`` operator."""
    out = []
    for r in records:
        mine = owned[r.shard] if r.shard < len(owned) else set()
        foreign = [j for j, own in enumerate(owned)
                   if j != r.shard and any(key in own and key not in mine for key in r.inputs)]
        cards = {d for d, _ in r.inputs if d.startswith("cuda")}
        dist = r.op.split(".")[0] in ("c10d", "_c10d_functional", "c10d_functional")
        if foreign or len(cards) > 1 or dist:
            what = (f"reads shard {foreign[0]}'s tensors" if foreign else
                    "a torch.distributed operator" if dist else f"spans devices {sorted(cards)}")
            out.append(LintFinding(
                contract="collectives", executable=exe, where=f"shard {r.shard} {r.program}:{r.op}",
                message=(f"cross-shard traffic inside a program ({what}): a shard's lanes "
                         "must depend on its own tensors only")))
    return out


def check_while_flatness(steps: dict[int, list[OpRecord]], exe: str) -> list[LintFinding]:
    """``while_body_flat``: the loop body at every cap dispatches the same
    operators with the same output sizes (views left out), so nothing in it
    grows with the cap."""
    caps = sorted(steps)
    out = []
    base = [(r.op, r.out_shapes) for r in steps[caps[0]]]
    for cap in caps[1:]:
        other = [(r.op, r.out_shapes) for r in steps[cap]]
        if other == base:
            continue
        i = next((i for i, (a, b) in enumerate(zip(base, other)) if a != b),
                 min(len(base), len(other)))
        got = other[i] if i < len(other) else None
        want = base[i] if i < len(base) else None
        out.append(LintFinding(
            contract="while_body_flat", executable=exe, where=f"caps {caps[0]} vs {cap}, op {i}",
            message=(f"the loop body differs with the cap ({len(base)} vs {len(other)} "
                     f"operators; first difference {want} vs {got}): work that grows with "
                     "the cap leaked into the step")))
    return out


# ------------------------------------------------------------ slot helpers
def _tensors(obj: Any, depth: int = 0) -> Iterable[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of the tensors held by an executor, a slot or a
    table (attributes, dicts, tuples), to a small depth."""
    if isinstance(obj, torch.Tensor):
        yield "", obj
        return
    if depth > 3:
        return
    if isinstance(obj, dict):
        items = ((str(k), v) for k, v in obj.items())
    elif isinstance(obj, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(obj))
    elif isinstance(obj, SimpleNamespace) or (depth == 0 and hasattr(obj, "__dict__")):
        items = vars(obj).items()
    else:
        return
    for name, v in items:
        if name in ("programs", "graphs", "model_fn", "src"):
            continue
        for sub, t in _tensors(v, depth + 1):
            yield (f"{name}.{sub}" if sub else name), t


def slot_addresses(slot: Any) -> dict[str, int]:
    """Address of every tensor of a slot or table, by name."""
    return {name: t.data_ptr() for name, t in _tensors(slot) if t.numel()}


def slot_dtypes(slot: Any) -> dict[str, torch.dtype]:
    """Dtype of every tensor of a slot or table, by name."""
    return {name: t.dtype for name, t in _tensors(slot)}


def owned_storages(exe: Any, slot_tensors: Sequence[str]) -> set[tuple[str, int]]:
    """The storages an executor holds for the whole of a run: its constants,
    its slots' fixed tensors (``slot_tensors``, and a prebuilt slot's
    tables) and its lane tables.  A program's own outputs are left out:
    they are made during the run, and the address of one may be that of a
    temporary another shard freed before, which says nothing."""
    out = set()
    for name, v in vars(exe).items():
        if name not in ("_slots", "_tables"):
            out |= {_storage(t) for _, t in _tensors(v, 1) if t.numel()}
    for s in exe._slots.values():
        fixed = [getattr(s, n) for n in slot_tensors]
        if exe.prebuilt and s.incremental:
            fixed.append(s.tables)
        out |= {_storage(t) for _, t in _tensors(fixed, 1) if t.numel()}
    for t in getattr(exe, "_tables", {}).values():
        out |= {_storage(x) for _, x in _tensors(t) if x.numel()}
    return out
