"""Staleness policy: when to publish, and delta vs full.

A copy of the JAX package's ``online/staleness.py`` (host code).

The continuous driver cuts at chunk boundaries; this policy decides what
each cut becomes:

- ``"skip"``  — not due yet (``publish_every`` cuts coalesce into one
  publish; serving keeps the previous generation).
- ``"delta"`` — the steady-state path: same-shape params, incremental
  encode, device-resident buffer swap (no reload, no warm-up).
- ``"full"``  — re-anchor: first publish after (re)start, a structural
  change (:class:`~.delta.DeltaShapeChanged` upstream), every
  ``full_every`` publishes (bounds how long a consumer that lost one
  update stays unable to resync), or when the sparse encoding would not
  actually save bytes.

The decision rule is deliberately *proactive*, not reactive: a delta
whose payload is >= ``full_ratio`` of the full tree ships as a full
update — same bits served either way (both carry raw new values), but
the full update additionally re-anchors the consumer's base, so it is
strictly more robust at equal cost.

``max_staleness_s`` is the freshness floor: even when ``publish_every``
says skip, a cut older than this publishes anyway — the gauge the
serving metrics expose (``staleness_seconds``) is the same number this
policy bounds.
"""

from __future__ import annotations

import time

from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = ["StalenessPolicy", "PublishStats"]


@dataclass
class PublishStats:
    """Rolling publish accounting the policy consults (and the driver /
    bench read back)."""
    publishes: int = 0
    deltas: int = 0
    fulls: int = 0
    skips: int = 0
    last_publish_at: Optional[float] = None
    last_published_step: Optional[int] = None
    delta_bytes: int = 0
    full_bytes: int = 0

    def staleness_s(self, now: Optional[float] = None) -> float:
        if self.last_publish_at is None:
            return float("inf")
        return (now if now is not None else time.time()) \
            - self.last_publish_at


@dataclass
class StalenessPolicy:
    #: publish every Nth cut (1 = every chunk boundary)
    publish_every: int = 1
    #: force a full re-anchor every Nth PUBLISH (0 = never; the first
    #: publish is always full regardless)
    full_every: int = 0
    #: publish regardless of cadence once the served model is this stale
    max_staleness_s: Optional[float] = None
    #: ship full when the delta payload reaches this fraction of the
    #: full tree's bytes (re-anchoring is free at that point)
    full_ratio: float = 0.9
    #: injectable clock (tests pin it)
    clock: Callable[[], float] = field(default=time.time)

    def __post_init__(self):
        if self.publish_every < 1:
            raise ValueError("publish_every must be >= 1")
        if not 0.0 < self.full_ratio <= 1.0:
            raise ValueError("full_ratio must be in (0, 1]")

    def due(self, cut_index: int, stats: PublishStats) -> bool:
        """Should cut number ``cut_index`` (0-based, monotonically
        increasing across the driver's life) publish at all?"""
        if cut_index % self.publish_every == 0:
            return True
        if (self.max_staleness_s is not None
                and stats.staleness_s(self.clock()) >= self.max_staleness_s):
            return True
        return False

    def wants_full(self, stats: PublishStats) -> bool:
        """Full re-anchor due by cadence (independent of shape changes,
        which force full upstream)?"""
        if stats.publishes == 0:
            return True
        return bool(self.full_every) and \
            stats.publishes % self.full_every == 0

    def choose(self, delta_bytes: int, full_bytes: int,
               stats: PublishStats) -> str:
        """``"delta"`` or ``"full"`` for a publish that CAN be a delta."""
        if self.wants_full(stats):
            return "full"
        if delta_bytes >= self.full_ratio * full_bytes:
            return "full"
        return "delta"
