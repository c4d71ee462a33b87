"""Traffic: one general generator of request streams, driven by a mix's parameter file.

A mix (``traffic/<name>.json``) names the knobs (``setting``), the lane
table (``lanes``, ``chunk_iters``) and the arrivals.  ``"backlog"``, the
one kind there is, feeds the runtime segments of ``segment_requests``
requests that are all due at once, so no lane waits for a request.  A
request is a serving group; each group is offered equally often, in an
order drawn from the seed.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ARRIVALS", "backlog_segment", "balanced_groups", "rng_for"]

#: The kinds of arrivals the generator makes.
ARRIVALS = ("backlog",)
#: Sub-streams drawn from one ``--seed``: the warm-up's requests, the backlog's.
STREAMS = {"warm": 0, "backlog": 1}


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """The generator of one sub-stream of ``seed`` (any non-negative integer)."""
    return np.random.default_rng([int(seed), STREAMS[stream]])


def balanced_groups(n_groups: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` serving groups, each ``n / n_groups`` times (the remainder from
    the first groups), in an order drawn from ``rng``: every seed offers the
    same requests, in another order."""
    return rng.permutation(np.arange(n) % n_groups)


def backlog_segment(n_groups: int, n: int, rng: np.random.Generator,
                    field: str = "gid") -> list[tuple[float, dict]]:
    """``n`` requests, all due at t = 0; each request dict is its own object."""
    return [(0.0, {field: int(g)}) for g in balanced_groups(n_groups, n, rng)]
