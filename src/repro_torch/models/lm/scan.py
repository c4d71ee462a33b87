"""The port's ``lax.scan``: a loop of trips over sequences, priced once per
trip when a step's cost is being counted.

The reference's SSD, mLSTM and sLSTM scans are ``jax.lax.scan``s; its cost
tools (``repro/launch/hlo_cost.py``, ``while_costs``) price a ``while`` body
once and multiply it by the trip count.  The port's scans are Python loops,
and ``launch/cost.count`` counts every operator that a step dispatches, so a
loop of 32768 trips on 16 shards dispatches millions.  :func:`scan` is the
one loop the three scans run through:

* on any device but ``meta``, or when no step is being counted, it is the
  plain loop: ``carry, y = body(carry, xs[t], *consts)`` for every trip ``t``;
* on ``meta`` tensors while ``cost.count`` prices loops (:func:`pricing`), it
  runs the body once and weighs what that trip dispatched (FLOPs, bytes,
  operators, collectives) by the trip count, then hands back one output a
  trip (aliases of the one trip's), so that what the caller does with them
  is counted as the loop's own outputs would be.  Where a gradient is taken,
  the loop is one ``autograd.Function`` whose backward prices the loop's
  backward pass (:class:`_PricedLoop`).

The body takes every tensor that needs a gradient as an argument (a trip's
slices ``xs[t]``, the carry, or ``consts``), never from its closure: the
priced loop routes gradients through those alone.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["pricing", "scan"]

_PRICER = None
# the backward is priced from loops of these many trips: the first trip and
# the last differ from the others (the first's carry needs no gradient, the
# last's gets only the caller's), and one more trip adds one middle trip
_MINI = (3, 4)


@contextlib.contextmanager
def pricing(pricer):
    """Loops on ``meta`` are priced by ``pricer`` while active.  ``pricer``
    has ``tally()`` (the counts so far, a value that adds, subtracts and
    multiplies by an int), ``add(tally)`` and ``record(name, trips, pass_,
    tally)`` (one trip's cost)."""
    global _PRICER
    saved, _PRICER = _PRICER, pricer
    try:
        yield
    finally:
        _PRICER = saved


def scan(name: str, body, carry: tuple, xs: tuple, consts: tuple = ()):
    """``lax.scan`` of ``body`` over ``xs``, a tuple of sequences of one
    slice a trip: ``carry, y = body(carry, tuple(x[t] for x in xs),
    *consts)`` for each trip, in order.  Returns (the last carry, the list
    of the trips' ``y``).  ``name`` names the loop in the priced record."""
    trips = len(xs[0])
    tensors = (*carry, *(x[0] for x in xs), *consts)
    if _PRICER is not None and trips >= _MINI[-1] and all(t.is_meta for t in tensors):
        return _priced(name, body, carry, xs, consts)
    ys = []
    for t in range(trips):
        carry, y = body(carry, tuple(x[t] for x in xs), *consts)
        ys.append(y)
    return carry, ys


def _priced(name, body, carry, xs, consts):
    """The priced loop (module docstring); refuses tensors off ``meta``,
    since it would return values that no trip computed."""
    trips = len(xs[0])
    flat = (*carry, *(x[t] for t in range(trips) for x in xs), *consts)
    off = [t.device for t in flat if not t.is_meta]
    if off:
        raise ValueError(f"a priced loop runs on meta tensors only, not on {off[0]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in flat):
        spec = (name, body, len(carry), len(xs), trips, len(consts))
        out = _PricedLoop.apply(spec, *flat)
        return tuple(out[:len(carry)]), list(out[len(carry):])
    carry, y = _one_trip(_PRICER, name, body, carry, tuple(x[0] for x in xs), consts, trips)
    return carry, [y] * trips


def _one_trip(pricer, name, body, carry, x, consts, trips):
    """One trip of ``body``, its dispatches weighed by ``trips``."""
    before = pricer.tally()
    carry, y = body(carry, x, *consts)
    trip = pricer.tally() - before
    pricer.add(trip * (trips - 1))
    pricer.record(name, trips, "forward", trip)
    return carry, y


class _PricedLoop(torch.autograd.Function):
    """A priced loop through which a gradient is taken.  Inputs: the carry,
    every trip's slices (trip-major), the consts; outputs: the last carry,
    one ``y`` a trip.

    The backward pass of the real loop is the first trip's, the last's and
    ``trips − 2`` identical middle trips', with the gradient accumulations
    between them (into the consts, and into a carry that a trip both hands
    on and returns).  So the backward runs the loop of 3 trips and of 4 on
    the saved first slices, each to its gradient, and prices ``B(3) +
    (trips − 3)·(B(4) − B(3))``, where ``B(k)`` is what the ``k``-trip
    backward dispatched; those loops' own dispatches are taken back out.
    Under remat the recomputed forward re-enters :func:`scan` and is priced
    again, as the real recomputation is."""

    @staticmethod
    def forward(ctx, spec, *flat):
        name, body, n_carry, n_x, trips, n_const = spec
        consts = flat[len(flat) - n_const:]
        carry, y = _one_trip(_PRICER, name, body, flat[:n_carry], flat[n_carry:n_carry + n_x],
                             consts, trips)
        ctx.spec, ctx.pricer = spec, _PRICER
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*flat[:n_carry + n_x * _MINI[-1]], *consts)
        seen: set = set()
        out = []
        for t in (*carry, y, *(y for _ in range(trips - 1))):  # distinct outputs
            out.append(t.detach() if id(t) in seen else t)
            seen.add(id(t))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        name, body, n_carry, n_x, trips, n_const = ctx.spec
        pricer = ctx.pricer
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        carry0 = saved[:n_carry]
        first = [saved[n_carry + t * n_x:n_carry + (t + 1) * n_x] for t in range(_MINI[-1])]
        consts = saved[len(saved) - n_const:]
        need_c = need[:n_carry]
        need_x = need[n_carry:n_carry + n_x]
        need_k = need[len(need) - n_const:]
        g_carry, g_y = grads[:n_carry], grads[n_carry:]
        start = pricer.tally()
        back = {}
        for k in _MINI:
            leaf = lambda t, n: t.detach().requires_grad_(n)  # noqa: E731
            c_in = tuple(leaf(t, n) for t, n in zip(carry0, need_c))
            x_in = [tuple(leaf(t, n) for t, n in zip(first[i], need_x)) for i in range(k)]
            k_in = tuple(leaf(t, n) for t, n in zip(consts, need_k))
            with torch.enable_grad():
                carry, ys = c_in, []
                for i in range(k):
                    carry, y = body(carry, x_in[i], *k_in)
                    ys.append(y)
            # the trips' own gradients: the first k − 1 trips' and the last's
            pairs = [(o, g) for o, g in zip((*ys, *carry), (*g_y[:k - 1], g_y[-1], *g_carry))
                     if g is not None and o.requires_grad]
            wrt = [t for t in (*c_in, *(t for x in x_in for t in x), *k_in) if t.requires_grad]
            before = pricer.tally()
            got = torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                      allow_unused=True) if pairs and wrt else [None] * len(wrt)
            back[k] = pricer.tally() - before
        k3, k4 = _MINI
        mid = back[k4] - back[k3]
        pricer.add(back[k3] + mid * (trips - k3) - (pricer.tally() - start))
        pricer.record(name, trips, "backward", mid)
        # the gradients of the k4-trip loop, in the inputs' places; the later
        # trips' slices get aliases of the last one's (shapes only: on meta)
        got = iter(got)
        g_c = [next(got) if n else None for n in need_c]
        g_x = [[next(got) if n else None for n in need_x] for _ in range(k4)]
        g_k = [next(got) if n else None for n in need_k]
        last = g_x[-1]
        g_x += [[None if g is None else g.detach() for g in last] for _ in range(trips - k4)]
        return (None, *g_c, *(g for x in g_x for g in x), *g_k)

