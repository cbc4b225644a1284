"""Controller inputs — one typed frame per tick over the metrics tree.

A copy of the JAX package's ``autoscale/signals.py``.  The policy must not grope around a nested snapshot dict: this module
turns ``MetricsTree.snapshot()`` into a :class:`SignalFrame` — the
closed set of numbers the decision loop consumes:

- per-tenant interactive/standard/bulk **p99 + queue depth + shed
  counters** (from the scheduler's ``tenants.<name>.*`` subtree), with shed counters turned into **windowed rates**
  (counter deltas over the sample interval — a counter's absolute value
  says nothing about *now*);
- **model staleness** (max over tenants, plus the optionally-designated
  learner tenant's own) — the continuous learner's freshness bound;
- **fleet gauges** (size, membership epoch) from the learner fleet's
  ``elastic`` subtree, when one is registered;
- **chip-idle fraction** from the scheduler's busy-accounting gauge
  — computed by the scheduler in ITS OWN clock
  domain, so this module never divides one clock's busy seconds by
  another clock's wall delta.

Clock discipline (the ``CheckpointManager`` pattern): the sampler's
``clock=`` stamps frames and windows rate computations; the controller
injects ONE clock through sampler, policy, and its own latency gauges,
so a test advancing a fake clock moves every timer coherently and MTTR
accounting never mixes domains.

A missing surface degrades to neutral, never to a fake number: no
scheduler subtree means empty tenants and NaN idle fraction; a
NaN/absent staleness (never published) stays NaN — the policy treats
NaN as "unknown, do not actuate on it" (the ``obs/tree.py``
absent-not-faked export stance).
"""

from __future__ import annotations

import math
import time

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

__all__ = ["SignalFrame", "SignalSource", "TenantSignal"]


def _num(value: Any, default: float = float("nan")) -> float:
    """A finite float, or ``default`` — snapshot leaves may be absent,
    None, or NaN-by-contract (never-published staleness)."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return default
    return float(value)


@dataclass(frozen=True)
class TenantSignal:
    """One tenant's slice of the frame."""

    name: str
    slo: str
    p99_ms: float
    queue_depth: float
    shed_total: float
    shed_rate_per_s: float
    staleness_s: float


@dataclass(frozen=True)
class SignalFrame:
    """Everything the policy reads, one tick.  Frozen: a decision is a
    pure function of one frame plus policy state."""

    at: float
    tenants: Mapping[str, TenantSignal]
    #: worst (max) p99 over the named SLO class, ms; NaN when the class
    #: has no tenants yet
    interactive_p99_ms: float
    #: per-class queue depth (the scheduler's per-class gauges)
    queue_depth: Mapping[str, float]
    #: per-class windowed shed rate, events/s over the sample interval
    shed_rate: Mapping[str, float]
    #: scheduler busy-accounting idle fraction over ITS window [0, 1]
    chip_idle_fraction: float
    #: max model staleness over every tenant (NaN = never published)
    staleness_s: float
    #: the designated learner tenant's staleness (falls back to the max)
    learner_staleness_s: float
    fleet_size: int
    membership_epoch: int
    #: max live model generation over tenants — carried for trace
    #: correlation ONLY; the policy never keys a decision on it (the
    #: publish-storm immunity contract, tested)
    max_generation: float
    #: the scheduler's brownout ladder rung: nonzero while a
    #: failover has the fleet capacity-short and classes are being shed
    #: at admission — the policy holds capacity-yielding moves while it
    #: is up (shrinking serving mid-failover would fight the driver)
    brownout_level: int = 0


class SignalSource:
    """Samples a :class:`~flink_ml_tpu_torch.obs.tree.MetricsTree` into
    :class:`SignalFrame`\\s, windowing counters against the previous
    sample.  ``scheduler_key``/``elastic_key`` name the tree providers
    (the ``default_tree`` names)."""

    def __init__(self, tree: Any, *,
                 clock: Callable[[], float] = time.monotonic,
                 scheduler_key: str = "scheduler",
                 elastic_key: str = "elastic",
                 learner_tenant: Optional[str] = None):
        self._tree = tree
        self.clock = clock
        self.scheduler_key = scheduler_key
        self.elastic_key = elastic_key
        self.learner_tenant = learner_tenant
        self._prev_at: Optional[float] = None
        self._prev_shed: Dict[str, float] = {}
        self.samples = 0

    # -- parsing -----------------------------------------------------------
    @staticmethod
    def _tenant_rows(sched: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
        """Group the scheduler's flat dotted keys
        (``tenants.<name>.<metric...>``) back into per-tenant dicts."""
        rows: Dict[str, Dict[str, Any]] = {}
        for key, value in sched.items():
            parts = str(key).split(".")
            if len(parts) < 3 or parts[0] != "tenants":
                continue
            rows.setdefault(parts[1], {})[".".join(parts[2:])] = value
        return rows

    def sample(self) -> SignalFrame:
        now = self.clock()
        snap = self._tree.snapshot()
        sched = snap.get(self.scheduler_key, {}) or {}
        elastic = snap.get(self.elastic_key, {}) or {}

        from ..serving.scheduler import SLO_CLASSES

        tenants: Dict[str, TenantSignal] = {}
        shed_total = {slo: 0.0 for slo in SLO_CLASSES}
        max_staleness = float("nan")
        max_generation = float("nan")
        dt = (now - self._prev_at) if self._prev_at is not None else None
        for name, row in self._tenant_rows(sched).items():
            slo = str(row.get("slo", "standard"))
            staleness = _num(row.get("model_staleness_seconds"))
            shed = _num(row.get("shed"), 0.0)
            prev = self._prev_shed.get(f"tenant:{name}", shed)
            rate = ((shed - prev) / dt) if dt else 0.0
            self._prev_shed[f"tenant:{name}"] = shed
            tenants[name] = TenantSignal(
                name=name, slo=slo,
                p99_ms=_num(row.get("latency_p99_ms")),
                queue_depth=_num(row.get("queue_depth"), 0.0),
                shed_total=shed, shed_rate_per_s=rate,
                staleness_s=staleness)
            if math.isfinite(staleness) and not (
                    math.isfinite(max_staleness)
                    and max_staleness >= staleness):
                max_staleness = staleness
            gen = _num(row.get("model_generation"))
            if math.isfinite(gen) and not (
                    math.isfinite(max_generation)
                    and max_generation >= gen):
                max_generation = gen

        queue_depth, shed_rate = {}, {}
        for slo in SLO_CLASSES:
            queue_depth[slo] = _num(sched.get(f"queue_depth_{slo}"), 0.0)
            total = _num(sched.get(f"shed_{slo}"), 0.0)
            prev = self._prev_shed.get(f"class:{slo}", total)
            shed_rate[slo] = ((total - prev) / dt) if dt else 0.0
            self._prev_shed[f"class:{slo}"] = total
            shed_total[slo] = total

        inter = [t.p99_ms for t in tenants.values()
                 if t.slo == SLO_CLASSES[0] and math.isfinite(t.p99_ms)]
        learner_staleness = max_staleness
        if self.learner_tenant is not None \
                and self.learner_tenant in tenants:
            learner_staleness = tenants[self.learner_tenant].staleness_s

        frame = SignalFrame(
            at=now, tenants=tenants,
            interactive_p99_ms=max(inter) if inter else float("nan"),
            queue_depth=queue_depth, shed_rate=shed_rate,
            chip_idle_fraction=_num(sched.get("chip_idle_fraction")),
            staleness_s=max_staleness,
            learner_staleness_s=learner_staleness,
            fleet_size=int(_num(elastic.get("fleet_size"), 0.0)),
            membership_epoch=int(_num(elastic.get("membership_epoch"),
                                      0.0)),
            max_generation=max_generation,
            brownout_level=int(_num(sched.get("brownout_level"), 0.0)))
        self._prev_at = now
        self.samples += 1
        return frame
