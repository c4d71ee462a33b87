"""The comparison that decides ``correct``: every served request against the plain reference.

A request is one serving group, and the reference's answer for a group is
its whole loop (``reference.Reference.serve``) and its estimate at the
program's final plan (``at_plan``).  The numbers, each held to its limit
in ``limits/<config>.json``:

``plan_mismatch``
    share of the served requests whose final plan ``z`` or iteration count
    differs from the reference's loop (the planner, the guarantee's stop,
    the Saltelli direction);
``yhat_gap`` (regression)
    the widest ``|ŷ − ŷ_ref| / δ`` at the program's plan (the AFC
    estimates and the forest on them);
``yhat_flip`` (classification)
    share of the requests whose class differs from the reference's at the
    program's plan;
``prob_gap``
    the widest ``|prob − prob_ref|`` at the program's plan (the forest on
    the QMC rows, Eq. 1 or the class vote).

A request that was not served (shed, failed, poisoned, or no record) is
not correct.
"""
from __future__ import annotations

__all__ = ["NUMBERS", "check", "numbers"]

NUMBERS = {"regression": ("plan_mismatch", "yhat_gap", "prob_gap"),
           "classification": ("plan_mismatch", "yhat_flip", "prob_gap")}


def numbers(task: str, delta: float, served: list, loops: dict, at_plan: dict) -> dict:
    """The compared numbers of ``served`` answers ``(group, ŷ, prob, z,
    iters)`` against the reference's ``loops[group]`` (an ``Answer``) and
    ``at_plan[(group, z)] = (ŷ, prob)``."""
    n = max(len(served), 1)
    mismatch = flips = 0
    yhat_gap = prob_gap = 0.0
    for g, y_hat, prob, z, iters in served:
        ref = loops[g]
        mismatch += tuple(z) != tuple(ref.z) or int(iters) != int(ref.iters)
        y_ref, p_ref = at_plan[(g, tuple(z))]
        flips += y_hat != y_ref
        yhat_gap = max(yhat_gap, abs(y_hat - y_ref) / delta if delta > 0 else 0.0)
        prob_gap = max(prob_gap, abs(prob - p_ref))
    out = {"plan_mismatch": mismatch / n, "prob_gap": prob_gap}
    if task == "classification":
        out["yhat_flip"] = flips / n
    else:
        out["yhat_gap"] = yhat_gap
    return {k: out[k] for k in NUMBERS[task]}


def check(values: dict, limits: dict) -> list[tuple[str, float, float, bool]]:
    """``(name, value, limit, within)`` of each number."""
    return [(k, float(v), float(limits[k]), float(v) <= float(limits[k]))
            for k, v in values.items()]
