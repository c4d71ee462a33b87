"""SLO-aware graceful degradation: knob tiers, deadline controller, shedding.

Port of ``repro/serving/degrade.py`` (host logic in numpy, no device work).
Biathlon prices accuracy with (delta, tau): under overload the runtime
spends some of it instead of letting queue delay absorb every burst.

* a **knob-tier ladder** (:class:`KnobTier`): an ordered strictest →
  loosest sequence of (delta_scale, tau, iter_cap) settings.  All three are
  per-lane inputs of the fused executor (``core/executor_fused.py``), copied
  into its slot before a run, so moving between tiers builds no slot and
  captures no graph;
* a :class:`DegradationController` mapping each request's **remaining SLO
  budget** (slack) and the current **queue depth** to a tier, with two
  deterministic decision functions (``tier_for``, ``should_shed``) over
  explicit state (an EWMA service-time estimate and a hysteretic load
  tier).  Tighter slack or a deeper queue never yields a stricter tier;
* **load shedding**: when even the loosest tier cannot meet a request's
  deadline (``slack < floor_speedup · service_est``), or the queue exceeds
  its bound, the request is rejected at admission with a ``shed``
  disposition;
* **hysteresis**: the load tier steps up as soon as the queue crosses its
  high watermark and back down only after ``cooldown`` consecutive calm
  observations.

The decisions equal the reference's bit for bit: the same float64
arithmetic on the same inputs.  The runtime integration lives in
``serving/runtime.py``, the fault harness in ``serving/faults.py``.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np

__all__ = [
    "KnobTier",
    "LaneKnobs",
    "DegradationController",
    "default_tiers",
    "validate_tiers",
]


@dataclass(frozen=True)
class KnobTier:
    """One rung of the degradation ladder (strictest tier = index 0).

    ``delta_scale`` multiplies the pipeline's baseline error bound,
    ``tau`` is the absolute Eq. 1 confidence target, ``iter_cap`` the
    planner-iteration ceiling (clamped to the executor's
    ``max_iters``).  All three are data to the executor: copied into its
    slot, never a reason to build one.
    """

    name: str
    delta_scale: float
    tau: float
    iter_cap: int


@dataclass(frozen=True)
class LaneKnobs:
    """Resolved per-lane knob vector handed to ``serve_batch``.

    Values are pinned to numpy float32 / int32 at construction, the dtypes
    the executor's slot holds them in, so a knob reads the same on the
    host as it does on the device.
    """

    delta: float
    tau: float
    iter_cap: int
    tier: int = 0

    def __post_init__(self) -> None:
        object.__setattr__(self, "delta", np.float32(self.delta))
        object.__setattr__(self, "tau", np.float32(self.tau))
        object.__setattr__(self, "iter_cap", np.int32(self.iter_cap))


def default_tiers(tau: float, max_iters: int) -> tuple[KnobTier, ...]:
    """The stock 4-rung ladder around a pipeline's (tau, max_iters).

    Scales are chosen so each rung roughly halves the expected planner
    iteration budget: a wider delta satisfies Eq. 1 at a smaller plan, a
    lower tau accepts the guarantee earlier, and the iter_cap hard-bounds
    the planner loop for requests whose groups resist both.
    """
    return (
        KnobTier("baseline", 1.0, tau, max_iters),
        KnobTier("relaxed", 1.5, max(tau - 0.03, 0.5), max(max_iters // 2, 1)),
        KnobTier("degraded", 2.5, max(tau - 0.07, 0.5), max(max_iters // 4, 1)),
        KnobTier("floor", 4.0, max(tau - 0.15, 0.5), 1),
    )


def validate_tiers(tiers) -> tuple[KnobTier, ...]:
    """Tiers must run strictest → loosest; returns them as a tuple.

    Monotonicity here is what makes the controller's monotonicity
    meaningful: non-decreasing delta_scale, non-increasing tau,
    non-increasing iter_cap.  Rejects empty ladders and out-of-range taus.
    """
    tiers = tuple(tiers)
    if not tiers:
        raise ValueError("degradation ladder needs at least one tier")
    for t in tiers:
        if not (0.0 < t.tau <= 1.0):
            raise ValueError(f"tier {t.name!r}: tau {t.tau} outside (0, 1]")
        if t.delta_scale < 1.0:
            raise ValueError(
                f"tier {t.name!r}: delta_scale {t.delta_scale} < 1 would be "
                "stricter than baseline"
            )
        if t.iter_cap < 0:
            raise ValueError(f"tier {t.name!r}: iter_cap {t.iter_cap} < 0")
    for a, b in zip(tiers, tiers[1:]):
        if b.delta_scale < a.delta_scale or b.tau > a.tau or b.iter_cap > a.iter_cap:
            raise ValueError(
                f"tiers must run strictest->loosest: {a.name!r} -> {b.name!r} "
                "tightens a knob"
            )
    return tiers


class DegradationController:
    """Maps (remaining SLO budget, queue depth) → knob tier; sheds the rest.

    Decision state is explicit and small: an EWMA **service-time estimate**
    (seconds per admission batch, whatever tier is currently running) and a
    hysteretic **load tier**.  Both decision functions are *pure* in
    (args, state) — identical (queue state, deadline, capacity estimate)
    always produce identical decisions, which is what makes shedding
    auditable and the property tests meaningful.

    ``tier_for`` computes a dimensionless *pressure* — expected completion
    wait over remaining slack, ``(queue_depth/lanes + 1) · est / slack`` —
    and bisects it into ``pressure_thresholds`` (one fewer than the tier
    count, increasing); the result is floored by the load tier, so a
    deadline-rich request still degrades when the queue says the system is
    drowning.  ``should_shed`` rejects a request whose slack is below what
    even the loosest tier could deliver (``floor_speedup · est``; looser
    tiers run faster, so the floor is a fraction of the current estimate)
    or that would grow the queue past ``max_queue``.
    """

    def __init__(
        self,
        tiers,
        *,
        service_est_s: float,
        lanes: int = 8,
        pressure_thresholds: tuple[float, ...] | None = None,
        floor_speedup: float = 0.5,
        max_queue: int | None = None,
        queue_high: float = 2.0,
        queue_low: float = 0.5,
        cooldown: int = 3,
        ewma_alpha: float = 0.5,
    ):
        self.tiers = validate_tiers(tiers)
        if service_est_s <= 0:
            raise ValueError("service_est_s must be > 0")
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        if pressure_thresholds is None:
            # geometric defaults: tier i engages when the expected wait
            # crosses 2^(i-1) x half the remaining budget
            pressure_thresholds = tuple(
                0.5 * 2.0**i for i in range(len(self.tiers) - 1)
            )
        thresholds = tuple(float(x) for x in pressure_thresholds)
        if len(thresholds) != len(self.tiers) - 1:
            raise ValueError(
                f"need {len(self.tiers) - 1} pressure thresholds for "
                f"{len(self.tiers)} tiers, got {len(thresholds)}"
            )
        if any(b <= a for a, b in zip(thresholds, thresholds[1:])):
            raise ValueError("pressure_thresholds must be strictly increasing")
        if not (0.0 < floor_speedup <= 1.0):
            raise ValueError("floor_speedup must be in (0, 1]")
        if not (0.0 < ewma_alpha <= 1.0):
            raise ValueError("ewma_alpha must be in (0, 1]")
        if queue_low > queue_high:
            raise ValueError("queue_low watermark above queue_high")
        self.lanes = int(lanes)
        self._thresholds = thresholds
        self.floor_speedup = float(floor_speedup)
        self.max_queue = max_queue
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.cooldown = int(cooldown)
        self.ewma_alpha = float(ewma_alpha)
        self._service_est_s = float(service_est_s)
        self._load_tier = 0
        self._calm = 0

    # ---------------------------------------------------------------- state
    @property
    def service_est_s(self) -> float:
        """Current EWMA estimate of one admission batch's service time."""
        return self._service_est_s

    @property
    def load_tier(self) -> int:
        """Hysteretic queue-driven tier floor (0 = baseline)."""
        return self._load_tier

    @property
    def min_service_s(self) -> float:
        """Estimated service time of the LOOSEST tier — the shed floor."""
        return self.floor_speedup * self._service_est_s

    # -------------------------------------------------- pure decision fns
    def pressure(self, slack_s: float, queue_depth: int) -> float:
        """Expected completion wait over remaining budget (dimensionless)."""
        wait = (queue_depth / self.lanes + 1.0) * self._service_est_s
        return wait / max(slack_s, 1e-9)

    def tier_for(self, slack_s: float | None, queue_depth: int) -> int:
        """Deterministic tier choice; monotone in both arguments.

        Less slack or a deeper queue can only move the answer toward looser
        tiers.  ``slack_s=None`` (no deadline) contributes no deadline
        pressure — the request still inherits the hysteretic load tier.
        """
        deadline_tier = 0
        if slack_s is not None:
            deadline_tier = bisect.bisect_right(
                self._thresholds, self.pressure(slack_s, queue_depth)
            )
        return max(deadline_tier, self._load_tier)

    def should_shed(self, slack_s: float | None, queue_depth: int) -> bool:
        """Reject now rather than queue unboundedly?  Deterministic.

        True when even the loosest tier's estimated service time exceeds
        the remaining budget, or the queue is past its hard bound.
        Monotone: shedding at some slack implies shedding at any smaller
        slack (same queue depth and state).
        """
        if self.max_queue is not None and queue_depth > self.max_queue:
            return True
        if slack_s is None:
            return False
        return slack_s < self.min_service_s

    # ------------------------------------------------------- state updates
    def observe(self, service_s: float, queue_depth: int) -> None:
        """Post-batch bookkeeping: EWMA the estimate, step the load tier.

        The load tier ratchets UP immediately whenever the queue is at or
        above ``queue_high`` full batches, but steps DOWN one rung only
        after ``cooldown`` consecutive observations at or below
        ``queue_low`` — tighten-back is hysteretic so a borderline queue
        does not flap between tiers.
        """
        a = self.ewma_alpha
        self._service_est_s = (1.0 - a) * self._service_est_s + a * float(service_s)
        if queue_depth >= self.queue_high * self.lanes:
            self._load_tier = min(self._load_tier + 1, len(self.tiers) - 1)
            self._calm = 0
        elif queue_depth <= self.queue_low * self.lanes:
            self._calm += 1
            if self._calm >= self.cooldown and self._load_tier > 0:
                self._load_tier -= 1
                self._calm = 0
        else:
            self._calm = 0

    # ------------------------------------------------------------- resolve
    def knobs_for(self, tier: int, base_delta: float) -> LaneKnobs:
        """Resolve a tier index into the absolute per-lane knob vector."""
        t = self.tiers[min(max(tier, 0), len(self.tiers) - 1)]
        return LaneKnobs(
            delta=float(base_delta) * t.delta_scale,
            tau=t.tau,
            iter_cap=t.iter_cap,
            tier=min(max(tier, 0), len(self.tiers) - 1),
        )

    def retier(
        self,
        slack_s: float | None,
        queue_depth: int,
        base_delta: float,
    ) -> LaneKnobs:
        """``tier_for`` + ``knobs_for`` in one call — the retry-path seam.

        Both runtimes re-price a request's knobs from its CURRENT slack
        whenever that slack changes (admission, and again after every
        retry backoff), so budget burned on retries degrades the request
        coherently instead of serving it late at full accuracy.
        """
        return self.knobs_for(self.tier_for(slack_s, queue_depth), base_delta)
