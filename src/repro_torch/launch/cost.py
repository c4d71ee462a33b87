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
memory.

:data:`HW` holds the NVIDIA H100 SXM 80GB's published peaks at its 700 W
limit (not the TPU's of ``hlo_stats.py``): 989e12 dense bf16 FLOP/s on the
tensor cores, 3.35e12 B/s of HBM3, and 450e9 B/s each way over NVLink 4,
which holds between the 8 cards of one host only.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.models.lm import collectives

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
# (:class:`TraceCut`): xlstm's full-scale cells, whose sLSTM scan is a Python
# loop over positions on every shard, would take hours
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


class TraceCut(Exception):
    """A trace stopped at its time limit; ``cost`` is what it had counted."""

    def __init__(self, cost: StepCost):
        super().__init__(f"trace stopped at its time limit after {cost.ops} operators")
        self.cost = cost


def count(fn, *args, **kwargs) -> tuple[object, StepCost]:
    """``fn(*args, **kwargs)`` and what it cost: FLOPs, bytes and operators
    dispatched, and the collectives it counted (``collectives.STATS`` is
    reset before).  A call still running after ``TRACE_LIMIT_S`` stops at
    its next operator and raises :class:`TraceCut` with the counts so far."""
    _attention_ops()  # registered before the counter copies the formulas
    collectives.reset_stats()
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter(time.monotonic() + TRACE_LIMIT_S)

    def cost():
        return StepCost(float(flops.get_total_flops()), float(nbytes.bytes), nbytes.ops,
                        collectives.STATS.as_dict())

    try:
        with flops, nbytes:
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
