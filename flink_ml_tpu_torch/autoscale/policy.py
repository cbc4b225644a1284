"""The decision loop — capacity follows traffic, with hysteresis.

A copy of the JAX package's ``autoscale/policy.py``.  One policy object owns the serving/training split of a fixed chip
budget and decides, frame by frame, whether to move it:

- **Scale serving out** when interactive pressure is high — p99 at the
  SLO high-watermark, interactive queue depth past its threshold, or
  interactive sheds happening AT ALL (a shed is the envelope already
  torn, not a leading indicator).  Chips come from the learner: a
  serving scale-up re-uses servables that are already warm, and the
  matching training preemption is a chunk-boundary resize — so acting
  is cheap and the policy leans toward protecting interactive
  traffic.
- **Yield trough capacity to training** when pressure is low AND chips
  are measurably idle — the learner grows one worker at a time toward
  its max, driving staleness down during the diurnal trough.
- **Hold** otherwise.

Thrash control, the part production controllers live or die on:

- **Deadband**: scale-out triggers at ``p99 >= high_frac * target``,
  release requires ``p99 <= low_frac * target`` — between the
  watermarks NOTHING moves, so a p99 oscillating inside the band
  (noisy quantiles, GC hiccups) produces zero churn.
- **Min-dwell**: after any actuation the policy holds for
  ``min_dwell_s`` on the injected clock regardless of signals, which
  bounds decisions/minute by construction (the hysteresis matrix in
  ``tests/test_torch_autoscale.py`` asserts the ceiling).
- **Publish-storm immunity by construction**: a decision is a pure
  function of (pressure, idle, staleness, dwell state) — model
  generations and publish counters are carried in the frame for trace
  correlation only and never read here, so 30 back-to-back generations
  cause zero placement churn (tested).

NaN inputs (never-published staleness, a class with no tenants yet) are
treated as "unknown": they can never satisfy a trigger, so a cold
control plane holds instead of actuating on absent data.
"""

from __future__ import annotations

import math
import time

from dataclasses import dataclass
from typing import Callable, Optional

from .signals import SignalFrame

__all__ = ["AutoscalePolicy", "Decision", "PolicyConfig",
           "DECISION_HOLD", "DECISION_SCALE_SERVING",
           "DECISION_YIELD_TO_TRAINING"]

#: decision kinds: serving takes a worker's chips from the learner /
#: the learner gets a worker's chips back / nothing moves
DECISION_SCALE_SERVING = "scale_serving"
DECISION_YIELD_TO_TRAINING = "yield_to_training"
DECISION_HOLD = "hold"


@dataclass(frozen=True)
class Decision:
    """One tick's verdict: the target split plus WHY — ``reason`` is
    what the controller stamps on its tracer instant, so a Perfetto
    trace reads as a causal story ("p99 1.9x target" -> preempt)."""

    kind: str
    reason: str
    serving_chips: int
    learner_workers: int
    at: float

    @property
    def actuates(self) -> bool:
        return self.kind != DECISION_HOLD


@dataclass(frozen=True)
class PolicyConfig:
    """Watermarks and dwell for one fleet.  ``total_chips`` is the whole
    budget; serving owns whatever the learner doesn't
    (``serving = total - learner_workers * chips_per_worker``)."""

    #: interactive p99 SLO target, ms
    p99_target_ms: float
    total_chips: int
    chips_per_worker: int = 1
    #: deadband watermarks as fractions of the target
    high_frac: float = 0.9
    low_frac: float = 0.5
    #: interactive queue depth that forces scale-out regardless of p99
    queue_high: int = 64
    #: idle fraction at-or-above which trough capacity yields to training
    idle_high: float = 0.5
    #: staleness at-or-above which the trough handoff is also URGENT
    #: (reported in the reason; NaN staleness never triggers anything)
    staleness_high_s: float = 60.0
    #: minimum seconds between actuations (the injected-clock dwell)
    min_dwell_s: float = 10.0
    min_serving_chips: int = 1
    min_learner_workers: int = 0
    max_learner_workers: Optional[int] = None

    def __post_init__(self):
        if self.p99_target_ms <= 0:
            raise ValueError("p99_target_ms must be positive")
        if not 0.0 < self.low_frac < self.high_frac:
            raise ValueError(
                "need 0 < low_frac < high_frac — an inverted deadband "
                "actuates on both edges at once")
        if self.total_chips < 1 or self.chips_per_worker < 1:
            raise ValueError("total_chips/chips_per_worker must be >= 1")
        if self.min_serving_chips < 0 or self.min_learner_workers < 0:
            raise ValueError("placement floors must be >= 0")
        if self.min_serving_chips \
                + self.min_learner_workers * self.chips_per_worker \
                > self.total_chips:
            raise ValueError("placement floors overcommit total_chips")


class AutoscalePolicy:
    """Stateful hysteresis around the pure per-frame trigger logic.
    ``decide`` never touches an actuator — it returns a
    :class:`Decision` the controller turns into placement + elastic
    transitions, so the unit matrix can drive the policy with synthetic
    frames and a fake clock."""

    def __init__(self, config: PolicyConfig, *,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config
        self.clock = clock
        self._last_actuation_at: Optional[float] = None
        self.decisions = 0
        self.actuations = 0
        self.holds = 0
        self.last_reason = ""

    # -- trigger predicates (pure, NaN-safe) --------------------------------
    def _pressure(self, frame: SignalFrame) -> Optional[str]:
        """The scale-out trigger, or None.  NaN compares false on every
        branch — absent data never actuates."""
        cfg = self.config
        from ..serving.scheduler import SLO_INTERACTIVE

        p99 = frame.interactive_p99_ms
        if p99 >= cfg.high_frac * cfg.p99_target_ms:
            return (f"interactive p99 {p99:.1f}ms >= "
                    f"{cfg.high_frac:.2f}x target {cfg.p99_target_ms}ms")
        depth = frame.queue_depth.get(SLO_INTERACTIVE, 0.0)
        if depth >= cfg.queue_high:
            return (f"interactive queue depth {depth:.0f} >= "
                    f"{cfg.queue_high}")
        if frame.shed_rate.get(SLO_INTERACTIVE, 0.0) > 0.0:
            return "interactive sheds observed — envelope already torn"
        return None

    def _trough(self, frame: SignalFrame) -> Optional[str]:
        """The yield-to-training trigger, or None.  An active brownout
        vetoes the yield outright: the fleet is
        capacity-short after a chip loss and whole classes are being
        shed at admission — handing chips to the learner now would
        fight the failover driver's recovery (idle fraction can look
        deceptively high mid-failover because browned-out classes stop
        arriving)."""
        cfg = self.config
        if getattr(frame, "brownout_level", 0) > 0:
            return None
        p99 = frame.interactive_p99_ms
        p99_low = (not math.isfinite(p99)
                   or p99 <= cfg.low_frac * cfg.p99_target_ms)
        if not p99_low:
            return None
        idle = frame.chip_idle_fraction
        if not (math.isfinite(idle) and idle >= cfg.idle_high):
            return None
        reason = (f"trough: idle fraction {idle:.2f} >= {cfg.idle_high}, "
                  f"p99 below {cfg.low_frac:.2f}x target")
        staleness = frame.learner_staleness_s
        if math.isfinite(staleness) and staleness >= cfg.staleness_high_s:
            reason += f"; learner staleness {staleness:.0f}s"
        return reason

    # -- the loop body -------------------------------------------------------
    def decide(self, frame: SignalFrame, *,
               learner_workers: int) -> Decision:
        """One tick: current split in, target split out.  The split is
        expressed as the learner's worker count; serving owns the rest
        of the budget."""
        cfg = self.config
        self.decisions += 1
        now = frame.at

        def _hold(reason: str) -> Decision:
            self.holds += 1
            self.last_reason = reason
            return Decision(
                kind=DECISION_HOLD, reason=reason, at=now,
                serving_chips=cfg.total_chips
                - learner_workers * cfg.chips_per_worker,
                learner_workers=learner_workers)

        def _move(kind: str, reason: str, workers: int) -> Decision:
            self._last_actuation_at = now
            self.actuations += 1
            self.last_reason = reason
            return Decision(
                kind=kind, reason=reason, at=now,
                serving_chips=cfg.total_chips
                - workers * cfg.chips_per_worker,
                learner_workers=workers)

        pressure = self._pressure(frame)
        trough = None if pressure else self._trough(frame)
        if pressure is None and trough is None:
            return _hold("deadband")
        if self._last_actuation_at is not None \
                and now - self._last_actuation_at < cfg.min_dwell_s:
            return _hold(
                f"min-dwell: {now - self._last_actuation_at:.1f}s since "
                f"last actuation < {cfg.min_dwell_s}s "
                f"(suppressed: {pressure or trough})")
        if pressure is not None:
            target = learner_workers - 1
            if target < cfg.min_learner_workers:
                return _hold(f"{pressure}; learner already at its "
                             f"floor {cfg.min_learner_workers}")
            return _move(DECISION_SCALE_SERVING,
                         f"{pressure}; preempting one learner worker",
                         target)
        target = learner_workers + 1
        max_workers = cfg.max_learner_workers
        if max_workers is None:
            max_workers = (cfg.total_chips - cfg.min_serving_chips) \
                // cfg.chips_per_worker
        if target > max_workers \
                or cfg.total_chips - target * cfg.chips_per_worker \
                < cfg.min_serving_chips:
            return _hold(f"{trough}; learner already at its ceiling")
        return _move(DECISION_YIELD_TO_TRAINING,
                     f"{trough}; granting one learner worker", target)

    def snapshot(self) -> dict:
        return {
            "decisions": self.decisions,
            "actuations": self.actuations,
            "holds": self.holds,
            "last_reason": self.last_reason,
        }
