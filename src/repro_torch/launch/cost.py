"""What a traced step costs: FLOPs, bytes and collective traffic, and the
roofline's peaks.

The port's counterpart of ``repro/launch/hlo_cost.py`` and
``repro/launch/hlo_stats.py``.  Those read the compiled HLO; PyTorch has no
HLO, so the port counts the operators that a step dispatches:

* FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (the matrix
  products and attention, 2·m·n·k a product, as the HLO's dots);
* bytes from a dispatch mode that adds each operator's operands and
  results (views excepted, which move nothing).  No operator is fused, so
  this is the unfused traffic: an upper bound of what the card would move;
* collective link bytes from ``models/lm/collectives.STATS``, weighted by
  ``hlo_stats.py``'s ring factors.

Both modes run on ``meta`` tensors, so a full-scale step is counted without
memory.  A scan (``models/lm/scan.py``) on ``meta`` is priced as
``hlo_cost.while_costs`` prices a ``while``: one trip is dispatched and its
counts weighed by the trip count (the backward pass's by the same rule),
and :attr:`StepCost.loops` lists each loop's trips and one trip's cost.

:data:`HW` holds the NVIDIA H100 SXM 80GB's published peaks at its 700 W
limit (not the TPU's of ``hlo_stats.py``): 989e12 dense bf16 FLOP/s on the
tensor cores, 3.35e12 B/s of HBM3, and 450e9 B/s each way over NVLink 4,
which holds between the 8 cards of one host only.
"""
from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.models.lm import collectives, scan

__all__ = ["HW", "StepCost", "TRACE_LIMIT_S", "TraceCut", "count"]

HW = {
    "card": "NVIDIA H100 SXM 80GB, 700 W",
    "peak_flops": 989e12,     # bf16 FLOP/s, dense tensor cores
    "hbm_bw": 3.35e12,        # bytes/s
    "link_bw": 450e9,         # bytes/s each way, NVLink 4
    "link_scope": "NVLink's rate holds within one host of 8 cards; a 16-way model axis "
                  "or a pod spans hosts, whose network is slower",
}


def _bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_bytes(t) for t in tree.values())
    return 0


# a trace still running after 20 minutes stops at its next operator
# (:class:`TraceCut`): the guard for a trace that runs away
TRACE_LIMIT_S = 1200.0


class _ByteCounter(TorchDispatchMode):
    """Adds every dispatched operator's operand and result bytes; past
    ``deadline`` (``time.monotonic()``) it raises at the next operator."""

    def __init__(self, deadline: float):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.deadline = deadline
        self.cut = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if time.monotonic() > self.deadline:
            self.cut = True
            raise TimeoutError("trace deadline")
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += _bytes((args, kwargs)) + _bytes(out)
            self.ops += 1
        return out


@dataclass
class StepCost:
    flops: float
    bytes: float
    ops: int
    collectives: dict
    # one entry a priced loop kind: name, pass, trips, calls and one trip's
    # flops, bytes and operators (the counterpart of ``while_costs``)
    loops: list = field(default_factory=list)


class _Tally(dict):
    """Counts at a point of a trace, or the difference of two, by name:
    they add, subtract and multiply by a trip count (exactly, but for the
    collectives' link bytes, which are floats)."""

    def __add__(self, other):
        return _Tally({k: self.get(k, 0) + other.get(k, 0) for k in self.keys() | other.keys()})

    def __sub__(self, other):
        return self + other * -1

    def __mul__(self, n: int):
        return _Tally({k: v * n for k, v in self.items()})


class _Pricer:
    """What ``scan.pricing`` needs of a trace: its tally, additions to it
    (the weighed trips), and the loops' records."""

    def __init__(self, flops: FlopCounterMode, nbytes: "_ByteCounter"):
        self.flops, self.nbytes = flops, nbytes
        self.extra_flops = 0
        self.loops: dict = {}

    def total_flops(self) -> int:
        return int(self.flops.get_total_flops()) + self.extra_flops

    def tally(self) -> _Tally:
        st = collectives.STATS
        return _Tally({"flops": self.total_flops(), "bytes": self.nbytes.bytes,
                       "ops": self.nbytes.ops, "link_bytes": st.link_bytes,
                       **{("per_op_bytes", k): v for k, v in st.per_op_bytes.items()},
                       **{("per_op_count", k): v for k, v in st.per_op_count.items()}})

    def add(self, t: _Tally) -> None:
        self.extra_flops += t.get("flops", 0)
        self.nbytes.bytes += t.get("bytes", 0)
        self.nbytes.ops += t.get("ops", 0)
        st = collectives.STATS
        st.link_bytes += t.get("link_bytes", 0)
        for key, v in t.items():
            if isinstance(key, tuple):
                table = getattr(st, key[0])
                table[key[1]] = table.get(key[1], 0) + v

    def record(self, name: str, trips: int, pass_: str, trip: _Tally) -> None:
        key = (name, pass_, trips, trip["flops"], trip["bytes"], trip["ops"])
        self.loops[key] = self.loops.get(key, 0) + 1

    def as_list(self) -> list:
        return [{"name": n, "pass": p, "trips": t, "calls": c, "trip_flops": f,
                 "trip_bytes": b, "trip_ops": o}
                for (n, p, t, f, b, o), c in self.loops.items()]


class TraceCut(Exception):
    """A trace stopped at its time limit; ``cost`` is what it had counted."""

    def __init__(self, cost: StepCost):
        super().__init__(f"trace stopped at its time limit after {cost.ops} operators")
        self.cost = cost


def count(fn, *args, price_loops: bool = True, **kwargs) -> tuple[object, StepCost]:
    """``fn(*args, **kwargs)`` and what it cost: FLOPs, bytes and operators
    dispatched, and the collectives it counted (``collectives.STATS`` is
    reset before).  Scans on ``meta`` are priced once a trip unless
    ``price_loops`` is False (then every trip is dispatched).  A call still
    running after ``TRACE_LIMIT_S`` stops at its next operator and raises
    :class:`TraceCut` with the counts so far."""
    _attention_ops()  # registered before the counter copies the formulas
    collectives.reset_stats()
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter(time.monotonic() + TRACE_LIMIT_S)
    pricer = _Pricer(flops, nbytes)

    def cost():
        return StepCost(float(pricer.total_flops()), float(nbytes.bytes), nbytes.ops,
                        collectives.STATS.as_dict(), pricer.as_list())

    priced = scan.pricing(pricer) if price_loops else contextlib.nullcontext()
    try:
        with flops, nbytes, priced:
            out = fn(*args, **kwargs)
    except Exception:  # the deadline's error may reach here wrapped by autograd
        if nbytes.cut:
            raise TraceCut(cost()) from None
        raise
    return out, cost()


# --------------------------------------------------------------------------
# The flash_attention kernels as operators on the meta device
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def live_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the kernel does not mask: keys at or below the
    query's position (its position ``sk - sq`` on) under ``causal``, and
    above position − ``window`` where ``window`` > 0."""
    if not causal and window <= 0:
        return sq * sk
    off = sk - sq
    total = 0
    for i in range(sq):
        hi = min(sk, i + off + 1) if causal else sk
        lo = max(0, i + off - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


_OPS: dict = {}


def _attention_ops():
    """The two operators (defined once, on first use): the forward kernel and
    its backward pair, with shape-only bodies and the kernels' FLOPs."""
    if _OPS:
        return _OPS
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch_cost::flash_attention", mutates_args=())
    def fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
        return q.new_empty((*q.shape[:-1], v.shape[-1]))

    @fwd.register_fake
    def _(q, k, v, causal, window):
        return q.new_empty((*q.shape[:-1], v.shape[-1]))

    @torch.library.custom_op("repro_torch_cost::flash_attention_bwd", mutates_args=())
    def bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
            do: torch.Tensor, causal: bool, window: int) -> list[torch.Tensor]:
        return [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]

    @bwd.register_fake
    def _(q, k, v, o, do, causal, window):
        return [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]

    def setup(ctx, inputs, output):
        q, k, v, causal, window = inputs
        ctx.save_for_backward(q, k, v, output)
        ctx.causal, ctx.window = causal, window

    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = bwd(q, k, v, o, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None

    fwd.register_autograd(backward, setup_context=setup)

    # (B, S, H, D) layout: per live pair and head, q·k and p·v
    @register_flop_formula(torch.ops.repro_torch_cost.flash_attention)
    def _(q_shape, k_shape, v_shape, causal, window, *args, out_shape=None, **kwargs):
        b, sq, h, d = q_shape
        return b * h * live_pairs(sq, k_shape[1], causal, window) * 2 * (d + v_shape[-1])

    # dq: q·k, do·v, ds·k; dk dv: q·k, p·do, do·v, ds·q
    @register_flop_formula(torch.ops.repro_torch_cost.flash_attention_bwd)
    def _(q_shape, k_shape, v_shape, o_shape, do_shape, causal, window, *args,
          out_shape=None, **kwargs):
        b, sq, h, d = q_shape
        dv = v_shape[-1]
        return b * h * live_pairs(sq, k_shape[1], causal, window) * 2 * (4 * d + 3 * dv)

    _OPS.update(fwd=fwd, bwd=bwd)
    return _OPS


def meta_attention(q, k, v, *, causal: bool, window: int = 0) -> torch.Tensor:
    """The ``flash_attention`` kernel's launch on ``meta`` tensors: one
    operator that reads q, k, v and writes the output, with the kernel's
    FLOPs (live pairs only), and on the backward pass the two backward
    kernels as one operator."""
    return _attention_ops()["fwd"](q, k, v, causal, window)
