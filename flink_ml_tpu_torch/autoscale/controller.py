"""The actuation loop — one tick: sample, decide, publish, move.

A copy of the JAX package's ``autoscale/controller.py``.
:class:`AutoscaleController` drives the serving and training actuators.
Each :meth:`tick`:

1. **samples** a :class:`~.signals.SignalFrame` from the metrics tree
   (the :class:`~.signals.SignalSource`);
2. **decides** through the :class:`~.policy.AutoscalePolicy` hysteresis
   loop;
3. on an actuating decision, **publishes** the next
   :class:`~.placement.PlacementMap` generation (atomic, durable, CAS —
   :class:`~.placement.PlacementStore`) and then moves the actuators to
   match it:

   - **serving**: :meth:`SharedScheduler.apply_placement` rescales WFQ
     weights to the tenants' chip counts, and every placed tenant's
     servable is confirmed warm against the :class:`ModelRegistry` —
     cheap by construction, because a servable is warmed once, at its
     admission, and a placement change builds nothing;
   - **training**: ``elastic.request_resize(workers, reason=)`` on any
     object that offers it (the JAX package's elastic coordinator
     applies it at the learner's next chunk boundary; that coordinator
     is not ported).

Every decision — actuating or held — is a tracer instant
(``autoscale_decision``, with the policy's reason string), so a
Perfetto trace reads as a causal story of why the fleet moved.

Clock discipline: the controller takes ONE
``clock=`` and the convenience constructor threads it through sampler
and policy, so dwell timers, staleness windows, and the
``decision_latency_s`` gauge live in a single injected domain — a fake
clock in tests advances all of them coherently, and MTTR-style
accounting never divides one clock's delta by another's.

Like :class:`~flink_ml_tpu_torch.obs.tree.ObsSampler`, the controller can
run tick-on-demand (tests, bench replay loops) or as a background
daemon thread (``start()``/``stop()``); the thread's cadence uses the
wall sleep of ``threading.Event.wait`` but every *measurement* stays on
the injected clock.
"""

from __future__ import annotations

import threading
import time

from typing import Any, Callable, Dict, List, Optional

from .placement import PlacementMap, PlacementStore
from .policy import AutoscalePolicy, Decision
from .signals import SignalFrame, SignalSource

__all__ = ["AutoscaleController"]


class AutoscaleController:
    """Wire a sampler, a policy, and a placement store onto the live
    actuators.  ``scheduler`` / ``elastic`` are each optional — a
    serving-only or training-only deployment still gets decisions and
    placements; the missing actuator is simply not moved."""

    def __init__(self, *, store: PlacementStore, policy: AutoscalePolicy,
                 signals: SignalSource,
                 scheduler: Any = None, elastic: Any = None,
                 health: Any = None,
                 clock: Callable[[], float] = time.monotonic,
                 interval_s: float = 1.0):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self.store = store
        self.policy = policy
        self.signals = signals
        self.scheduler = scheduler
        self.elastic = elastic
        #: the serving fleet's lease table: when wired, the
        #: layout skips declared-dead chips, so a controller tick racing
        #: a failover converges onto the SAME survivor set — the two
        #: writers already share one placement generation stream (CAS);
        #: sharing the health view means the retry loser re-derives an
        #: edit the winner would also have made, never a re-placement
        #: back onto a dead chip
        self.health = health
        self.clock = clock
        self.interval_s = interval_s
        self.ticks = 0
        self.actuations = 0
        self.conflicts = 0
        #: decision→publish→actuate latency of the last tick, seconds in
        #: the INJECTED clock domain (the end-to-end clock satellite)
        self.last_decision_latency_s = float("nan")
        self.last_decision: Optional[Decision] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def build(cls, tree: Any, *, store: PlacementStore,
              policy_config: Any, scheduler: Any = None,
              elastic: Any = None, health: Any = None,
              clock: Callable[[], float] = time.monotonic,
              learner_tenant: Optional[str] = None,
              interval_s: float = 1.0) -> "AutoscaleController":
        """The one-clock convenience constructor: build sampler + policy
        sharing ``clock`` (the ``CheckpointManager`` injection
        pattern) over an existing metrics tree."""
        signals = SignalSource(tree, clock=clock,
                               learner_tenant=learner_tenant)
        policy = AutoscalePolicy(policy_config, clock=clock)
        return cls(store=store, policy=policy, signals=signals,
                   scheduler=scheduler, elastic=elastic, health=health,
                   clock=clock, interval_s=interval_s)

    # -- placement synthesis -------------------------------------------------
    def _tenant_names(self) -> List[str]:
        if self.scheduler is None:
            return sorted(self.store.current().servables)
        return self.scheduler.tenants()

    def _layout(self, serving_chips: int) -> Dict[str, List[int]]:
        """Tenant -> chip set for a serving extent of ``serving_chips``:
        every servable spans the whole serving slice (chips
        ``[0, serving_chips)`` — the learner owns the top of the pool),
        the multi-tenant scheduler's shared-device posture; the WFQ
        layer, not the chip boundary, arbitrates between servables.  With
        a fleet-health view wired, declared-dead chips drop out of the
        slice — a tick landing mid-failover lays out onto
        the survivors, never back onto the corpse."""
        chips = list(range(serving_chips))
        if self.health is not None:
            down = set(self.health.down())
            live = [c for c in chips if c not in down]
            chips = live or chips
        return {name: chips for name in self._tenant_names()}

    # -- actuation -----------------------------------------------------------
    def _actuate(self, decision: Decision, pmap: PlacementMap) -> None:
        if self.scheduler is not None:
            self.scheduler.apply_placement(pmap)
            self._confirm_warm(pmap)
        if self.elastic is not None:
            self.elastic.request_resize(decision.learner_workers,
                                        reason=decision.reason)

    def _confirm_warm(self, pmap: PlacementMap) -> None:
        """Every placed tenant must be servable the moment traffic
        shifts onto its (re)grown chip set: confirm readiness against
        the registry.  For an admitted tenant this is a no-op read (its
        servable warmed at admission), and a not-yet-warm servable gets its warm-up here, OFF the dispatch
        path (the scheduler keeps serving the old placement
        meanwhile)."""
        registry = getattr(self.scheduler, "registry", None)
        if registry is None:
            return
        for name in pmap.servables:
            try:
                tenant = self.scheduler.tenant(name)
                deployed = registry.current(tenant.serve_name)
            except KeyError:
                continue        # placed but not admitted (yet): no-op
            servable = deployed.servable
            if not getattr(servable, "ready", True):
                servable.warm_up()

    # -- the loop body -------------------------------------------------------
    def tick(self) -> Decision:
        """One control iteration: sample -> decide -> publish ->
        actuate.  Always returns the decision (holds included); the
        tracer instant carries kind + reason either way."""
        from ..obs.trace import tracer
        from .placement import PlacementConflict

        t0 = self.clock()
        self.ticks += 1
        frame: SignalFrame = self.signals.sample()
        base = self.store.current()
        decision = self.policy.decide(
            frame, learner_workers=base.learner_workers)
        actuated = False
        if decision.actuates:
            try:
                pmap = self.store.publish(
                    self._layout(decision.serving_chips),
                    decision.learner_workers,
                    expected_generation=base.generation)
            except PlacementConflict:
                # a racing writer moved the map under us: skip this
                # tick's actuation and re-derive from the fresh map
                # next tick — never actuate a stale edit
                self.conflicts += 1
            else:
                self._actuate(decision, pmap)
                self.actuations += 1
                actuated = True
        self.last_decision = decision
        self.last_decision_latency_s = self.clock() - t0
        tracer.instant(
            "autoscale_decision", cat="autoscale",
            generation=self.store.current().generation,
            x_kind=decision.kind, x_reason=decision.reason,
            x_actuated=str(actuated),
            x_learner_workers=str(decision.learner_workers),
            x_serving_chips=str(decision.serving_chips))
        return decision

    # -- background thread ---------------------------------------------------
    def start(self) -> "AutoscaleController":
        if self._thread is not None:
            raise RuntimeError("controller already started")
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the control plane
                    pass           # must never kill the data plane
        self._thread = threading.Thread(
            target=loop, daemon=True, name="flink-ml-tpu-autoscale")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- observability -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """MetricsTree provider (``default_tree(autoscale=...)``):
        controller counters + the policy's decision ledger + the live
        placement — the control plane observes itself through the same
        tree it reads."""
        out: Dict[str, Any] = {
            "ticks": self.ticks,
            "actuations": self.actuations,
            "conflicts": self.conflicts,
            "decision_latency_s": self.last_decision_latency_s,
        }
        if self.last_decision is not None:
            out["last_kind"] = self.last_decision.kind
            out["last_reason"] = self.last_decision.reason
        for key, value in self.policy.snapshot().items():
            out[f"policy_{key}"] = value
        for key, value in self.store.snapshot().items():
            out[f"placement_{key}"] = value
        return out
