"""Serving fleet failover — chip-loss detection, re-placement, brownout.

A port of the JAX package's ``serving/failover.py`` (host code).  On one
card the fleet's chips are logical placement slots: the JAX package's
single-process harness (``lease_timeout_s=None``), where a seeded
``chip_down`` / ``chip_flap`` fault plays the chip loss.

- :class:`FleetHealth` — a lease table over serving **chips**:
  injectable clock, per-chip leases with deterministic expiry
  (``lease_timeout_s=None`` disables it), an
  ``epoch``/``transitions``/``counters`` audit surface, and a
  :meth:`FleetHealth.poll` that fires the ``serving.chip`` fault scope
  so seeded ``chip_down``/``chip_flap`` faults translate into
  deterministic, replayable chip transitions.
- :class:`FailoverDriver` — detection to recovery.  On a chip loss it
  re-places the dead chip's tenants onto survivors through the
  :class:`~flink_ml_tpu_torch.autoscale.placement.PlacementStore` CAS
  path (failover and the autoscaler share ONE placement generation
  stream, so a racing ``tick()`` resolves through one
  :class:`~flink_ml_tpu_torch.autoscale.placement.PlacementConflict`
  retry instead of a fight), re-admits moved tenants (the servable is
  already warm, so the re-placement publish builds nothing — and the
  generation bump is what lets an in-flight
  :class:`~flink_ml_tpu_torch.online.publish.DeltaPublisher` notice the
  move and re-anchor, its existing idempotent heal), and drives the
  **brownout ladder** while capacity is short.
- **Lossless in-flight requests.**  The ``chip_down``/``chip_flap``
  kinds raise at the scheduler's DISPATCH boundary
  (:data:`~flink_ml_tpu_torch.serving.scheduler.DISPATCH_SCOPE`), BEFORE
  the batch's predict runs; the scheduler requeues the picked requests
  at the front of their tenants' queues with their futures untouched.
  Scoring is idempotent and the batcher owns the request futures, so
  ZERO requests drop and every retried request is answered
  bit-identically to an unfailed run.  A requeued request already past
  its SLO deadline sheds with
  :class:`~flink_ml_tpu_torch.robustness.retry.DeadlineExceededError`
  (fatal-not-retryable) instead of burning survivor capacity.
- **SLO-aware brownout with hysteresis.**  Capacity-short operation
  extends shed-order-by-construction into a per-class ladder: level L
  sheds the bottom L SLO classes at admission (bulk first, interactive
  protected by the strict dispatch priority — the ladder maxes out at
  ``len(SLO_CLASSES) - 1``).  Raising the level is immediate; lowering
  waits ``hysteresis_s`` of stable fleet on the injected clock, and a
  recovered chip's placement is only restored after the same window —
  so a flapping chip costs at most one placement move per stability
  window, never a thrash.
- **N-way replication for high-SLO tenants.**
  :meth:`FailoverDriver.ensure_replicas` places a tenant on ``n`` chips;
  a replicated tenant keeps a surviving chip through any single loss
  and its failover window is ONE dispatch (no re-admission), while an
  unreplicated tenant pays the re-admission window.

Observability: fleet-health gauges under the ``failover`` metric group
(``chips_live``/``chips_down``/``brownout_level``/counters), and
``chip_lost``/``failover_complete``/``failover_restore`` tracer
instants carrying the correlation contract (``generation``, ``tenant``;
chip ids ride ``x_``-prefixed experiment keys).
"""

from __future__ import annotations

import threading
import time

from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

from ..obs.trace import tracer
from ..robustness.faults import (InjectedChipDown, InjectedChipFlap,
                                 fault_point)
from ..utils.metrics import MetricGroup
from .scheduler import DISPATCH_SCOPE, SLO_CLASSES

__all__ = ["CHIP_SCOPE", "DISPATCH_SCOPE", "ChipLease", "FleetHealth",
           "FailoverDriver", "FailoverReport"]

#: the health-poll fault seam: each :meth:`FleetHealth.poll` is one
#: invocation, so a seeded ``chip_down``/``chip_flap`` schedule maps to
#: deterministic poll indices (the ``elastic.membership`` idiom)
CHIP_SCOPE = "serving.chip"


@dataclass
class ChipLease:
    """One serving chip's lease: refreshed by :meth:`FleetHealth.\
heartbeat`, reaped by :meth:`FleetHealth.expire` once ``expires_at``
    passes (``None`` = expiry disabled).  ``order`` is the admission
    sequence — the LIFO victim order injected faults use, mirroring the
    elastic coordinator's preemption choice."""

    chip: int
    joined_at: float
    expires_at: Optional[float]
    order: int


class FleetHealth:
    """The serving-side lease table (the training fleet's lease idiom
    over chips).

    All transitions are deterministic functions of (clock, schedule):
    explicit :meth:`fail`/:meth:`recover`, lease :meth:`expire` on the
    injected clock, and :meth:`poll` — the periodic health boundary
    that fires :data:`CHIP_SCOPE` and translates injected
    ``chip_down``/``chip_flap`` faults into LIFO-victim deaths (a flap
    schedules its own recovery ``flap_recovery_polls`` polls later).
    ``transitions`` is the audit log chaos tests read; ``epoch`` bumps
    on every membership change so consumers can cheaply detect drift.
    """

    SCOPE = CHIP_SCOPE

    def __init__(self, chips: Iterable[int], *,
                 lease_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 flap_recovery_polls: int = 2):
        if lease_timeout_s is not None and lease_timeout_s <= 0:
            raise ValueError("lease_timeout_s must be positive (or None "
                             "to disable expiry)")
        if flap_recovery_polls < 1:
            raise ValueError("flap_recovery_polls must be >= 1")
        self.clock = clock
        self.lease_timeout_s = lease_timeout_s
        self.flap_recovery_polls = flap_recovery_polls
        self._lock = threading.Lock()
        self._leases: Dict[int, ChipLease] = {}
        #: chip -> clock stamp of its death (declared-dead set)
        self._down: Dict[int, float] = {}
        #: chip -> clock stamp it (re)joined — the hysteresis input
        self._live_since: Dict[int, float] = {}
        #: chip -> polls until a flap's scheduled recovery
        self._flap_pending: Dict[int, int] = {}
        self._order = 0
        self._epoch = 0
        self.transitions: List[Tuple[str, int, int]] = []
        self.counters: Dict[str, int] = {
            "deaths": 0, "flaps": 0, "expiries": 0, "recoveries": 0,
            "suppressed": 0, "polls": 0,
        }
        now = self.clock()
        for chip in sorted(int(c) for c in chips):
            if chip in self._leases:
                raise ValueError(f"chip {chip} admitted twice")
            self._leases[chip] = ChipLease(
                chip=chip, joined_at=now,
                expires_at=self._lease_deadline(now), order=self._order)
            self._live_since[chip] = now
            self._order += 1
        if not self._leases:
            raise ValueError("FleetHealth needs at least one chip")

    def _lease_deadline(self, now: float) -> Optional[float]:
        if self.lease_timeout_s is None:
            return None
        return now + self.lease_timeout_s

    # -- reads ---------------------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._epoch

    def live(self) -> List[int]:
        with self._lock:
            return sorted(self._leases)

    def down(self) -> List[int]:
        with self._lock:
            return sorted(self._down)

    def is_live(self, chip: int) -> bool:
        return chip in self._leases

    def live_since(self, chip: int) -> Optional[float]:
        """Clock stamp the chip last (re)joined — None while down."""
        with self._lock:
            if chip not in self._leases:
                return None
            return self._live_since.get(chip)

    # -- transitions ---------------------------------------------------------
    def _record(self, kind: str, chip: int) -> None:
        """Caller holds the lock."""
        self._epoch += 1
        self.transitions.append((kind, chip, self._epoch))

    def heartbeat(self, chip: int) -> bool:
        """Refresh ``chip``'s lease.  A heartbeat from a declared-dead
        chip is SUPPRESSED (counted, not honored) — a zombie must come
        back through :meth:`recover`, never by out-racing the reaper
        (the elastic coordinator's suppression stance)."""
        with self._lock:
            lease = self._leases.get(chip)
            if lease is None:
                self.counters["suppressed"] += 1
                self.transitions.append(("suppressed", chip, self._epoch))
                return False
            lease.expires_at = self._lease_deadline(self.clock())
            return True

    def fail(self, chip: int, *, flap: bool = False,
             cause: str = "injected") -> bool:
        """Declare ``chip`` dead.  ``flap=True`` schedules its recovery
        ``flap_recovery_polls`` polls from now (the deterministic flap
        model).  Returns False when the chip was already down."""
        with self._lock:
            if chip not in self._leases:
                return False
            del self._leases[chip]
            self._live_since.pop(chip, None)
            self._down[chip] = self.clock()
            self.counters["deaths"] += 1
            if flap:
                self.counters["flaps"] += 1
                self._flap_pending[chip] = self.flap_recovery_polls
            self._record("flap_down" if flap else "down", chip)
        tracer.instant("chip_lost", cat="serving", x_chip=str(chip),
                       x_cause=cause)
        return True

    def recover(self, chip: int) -> bool:
        """A dead chip rejoined: re-lease it.  ``live_since`` restarts —
        the driver's hysteresis window measures from here."""
        with self._lock:
            if chip in self._leases or chip not in self._down:
                return False
            del self._down[chip]
            self._flap_pending.pop(chip, None)
            now = self.clock()
            self._leases[chip] = ChipLease(
                chip=chip, joined_at=now,
                expires_at=self._lease_deadline(now), order=self._order)
            self._order += 1
            self._live_since[chip] = now
            self.counters["recoveries"] += 1
            self._record("up", chip)
        return True

    def expire(self) -> List[int]:
        """Reap chips whose leases lapsed (missed heartbeats past
        ``lease_timeout_s`` on the injected clock) — the detection path
        for silent deaths, deterministic under a fake clock."""
        if self.lease_timeout_s is None:
            return []
        now = self.clock()
        with self._lock:
            dead = [c for c, lease in self._leases.items()
                    if lease.expires_at is not None
                    and lease.expires_at <= now]
            for chip in dead:
                del self._leases[chip]
                self._live_since.pop(chip, None)
                self._down[chip] = now
                self.counters["expiries"] += 1
                self.counters["deaths"] += 1
                self._record("expired", chip)
        for chip in dead:
            tracer.instant("chip_lost", cat="serving", x_chip=str(chip),
                           x_cause="lease_expired")
        return sorted(dead)

    def _victim(self) -> Optional[int]:
        """LIFO victim for injected faults: the newest lease (the
        elastic coordinator's preemption order), deterministic."""
        with self._lock:
            if not self._leases:
                return None
            return max(self._leases.values(), key=lambda l: l.order).chip

    def poll(self) -> List[Tuple[str, int]]:
        """One health tick: fire the :data:`CHIP_SCOPE` fault seam
        (seeded ``chip_down``/``chip_flap`` schedules land here,
        raise-before-anything so the tick itself is lossless), advance
        pending flap recoveries, then reap expired leases.  Returns
        this tick's transitions as ``(kind, chip)`` — ``"down"`` /
        ``"up"`` — in deterministic order."""
        self.counters["polls"] += 1
        events: List[Tuple[str, int]] = []
        try:
            fault_point(self.SCOPE)
        except InjectedChipDown:
            victim = self._victim()
            if victim is not None and self.fail(victim, cause="chip_down"):
                events.append(("down", victim))
        except InjectedChipFlap:
            victim = self._victim()
            if victim is not None and self.fail(victim, flap=True,
                                                cause="chip_flap"):
                events.append(("down", victim))
        recovered: List[int] = []
        with self._lock:
            for chip in sorted(self._flap_pending):
                self._flap_pending[chip] -= 1
                if self._flap_pending[chip] <= 0:
                    recovered.append(chip)
        for chip in recovered:
            if self.recover(chip):
                events.append(("up", chip))
        for chip in self.expire():
            events.append(("down", chip))
        return events

    # -- observability -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "chips_live": len(self._leases),
                "chips_down": len(self._down),
                "epoch": self._epoch,
                **{k: int(v) for k, v in self.counters.items()},
            }

    def publish(self, group: MetricGroup) -> None:
        snap = self.snapshot()
        for key in ("chips_live", "chips_down", "epoch"):
            group.gauge(key).set(snap[key])


@dataclass(frozen=True)
class FailoverReport:
    """One failover, detection to recovery — the audit record chaos
    tests and ``chip_smoke.py`` read.  ``moved`` tenants lost every
    chip and paid the re-admission (re-warm) window; ``replicated``
    tenants kept a surviving replica, so their window was one dispatch.
    ``generation`` is the placement generation the re-placement
    published (-1 when the CAS retry also lost — the next tick
    re-derives)."""

    detected_at: float
    resolved_at: float
    dead_chips: Tuple[int, ...]
    generation: int
    moved: Tuple[str, ...]
    replicated: Tuple[str, ...]
    requeued: int
    conflicts: int
    cause: str

    @property
    def wall_s(self) -> float:
        return self.resolved_at - self.detected_at


class FailoverDriver:
    """Detection -> re-placement -> brownout, one driver per scheduler.

    Construction attaches the driver to the scheduler's dispatch
    boundary (:meth:`SharedScheduler.attach_failover`): an injected
    ``chip_down``/``chip_flap`` there requeues the in-flight batch and
    lands in :meth:`on_chip_fault`; lease expiries and health-poll
    faults land through :meth:`tick`.  Both paths converge on the same
    failover: evict the dead chips from the live
    :class:`~flink_ml_tpu_torch.autoscale.placement.PlacementMap`, publish
    via CAS on the shared generation stream (ONE retry on
    :class:`~flink_ml_tpu_torch.autoscale.placement.PlacementConflict` — a
    racing autoscale tick re-derives from the fresh map, neither side
    thrashes), apply to the scheduler, re-admit fully-evicted tenants
    (ready servable -> nothing built; the generation bump re-anchors
    in-flight delta publishers), and set the brownout level for the
    new capacity deficit.
    """

    def __init__(self, scheduler: Any, store: Any, *,
                 health: Optional[FleetHealth] = None,
                 chips: Optional[Iterable[int]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 lease_timeout_s: Optional[float] = None,
                 flap_recovery_polls: int = 2,
                 hysteresis_s: float = 0.0,
                 brownout_deficits: Sequence[float] = (1e-9, 0.5),
                 group: Optional[MetricGroup] = None):
        if hysteresis_s < 0:
            raise ValueError("hysteresis_s must be >= 0")
        if len(brownout_deficits) > len(SLO_CLASSES) - 1:
            raise ValueError(
                f"at most {len(SLO_CLASSES) - 1} brownout rungs: the "
                "highest class is protected by construction")
        if list(brownout_deficits) != sorted(brownout_deficits):
            raise ValueError("brownout_deficits must be non-decreasing")
        self.scheduler = scheduler
        self.store = store
        self.clock = clock
        self.hysteresis_s = hysteresis_s
        #: rung thresholds: crossing ``brownout_deficits[i]`` of the
        #: fleet down raises the brownout to level ``i + 1`` (level 1
        #: sheds bulk, level 2 sheds standard too; interactive never)
        self.brownout_deficits = tuple(float(d) for d in brownout_deficits)
        if health is None:
            if chips is None:
                current = store.current().serving_chips()
                chips = current or range(getattr(store, "total_chips", 1))
            health = FleetHealth(chips, lease_timeout_s=lease_timeout_s,
                                 clock=clock,
                                 flap_recovery_polls=flap_recovery_polls)
        self.health = health
        #: chip -> {tenant: its chip tuple before the eviction} — what
        #: a post-hysteresis restore puts back
        self._evicted: Dict[int, Dict[str, Tuple[int, ...]]] = {}
        self._level = 0
        #: pending LOWER level + since-when (raising is immediate;
        #: lowering dwells ``hysteresis_s`` so a flap can't thrash)
        self._pending_level: Optional[int] = None
        self._pending_since = 0.0
        self.reports: List[FailoverReport] = []

        self.group = group or MetricGroup("failover")
        self._failovers = self.group.counter("failovers")
        self._chips_lost = self.group.counter("chips_lost")
        self._requeued = self.group.counter("requeued_requests")
        self._conflicts = self.group.counter("placement_conflicts")
        self._restores = self.group.counter("restores")
        self._brownout_gauge = self.group.gauge("brownout_level")
        self._brownout_gauge.set(0)
        self._wall_gauge = self.group.gauge("last_failover_wall_s")
        self._wall_gauge.set(float("nan"))   # never failed over: absent
        self.health.publish(self.group)
        attach = getattr(scheduler, "attach_failover", None)
        if attach is not None:
            attach(self)

    @property
    def brownout_level(self) -> int:
        return self._level

    @property
    def conflicts(self) -> int:
        return int(self._conflicts.value)

    # -- entry points --------------------------------------------------------
    def on_chip_fault(self, exc: BaseException,
                      requeued: int = 0) -> Optional[FailoverReport]:
        """The scheduler's dispatch boundary caught an injected chip
        fault (the batch is already requeued, futures intact): pick the
        deterministic LIFO victim, declare it dead, and fail over."""
        victim = self.health._victim()
        if victim is None:
            return None
        flap = isinstance(exc, InjectedChipFlap)
        if not self.health.fail(victim, flap=flap,
                                cause="dispatch_fault"):
            return None
        return self._failover([victim], requeued=requeued,
                              cause="dispatch")

    def tick(self) -> Optional[FailoverReport]:
        """The periodic health boundary: poll the lease table (seeded
        faults + flap recoveries + lease expiry), fail over any new
        deaths, restore recovered chips past the hysteresis window, and
        settle the brownout level.  Returns this tick's report (None
        when nothing died)."""
        events = self.health.poll()
        dead = [chip for kind, chip in events if kind == "down"]
        report = None
        if dead:
            report = self._failover(dead, requeued=0, cause="poll")
        self._maybe_restore()
        self._settle_brownout()
        return report

    # -- the failover itself -------------------------------------------------
    def _evict(self, base: Any, dead: List[int]
               ) -> Tuple[Dict[str, List[int]], List[str], List[str]]:
        """The re-placement edit: drop ``dead`` from every tenant's chip
        set; a tenant left with survivors is ``replicated`` (its
        failover window is one dispatch), a tenant left with NOTHING is
        ``moved`` onto the least-loaded live chip (deterministic
        tiebreak by chip id) and pays the re-admission window."""
        dead_set = set(dead)
        live = [c for c in self.health.live() if c not in dead_set]
        servables = {name: list(chips)
                     for name, chips in base.servables.items()}
        moved: List[str] = []
        replicated: List[str] = []
        for name in sorted(servables):
            chips = servables[name]
            survivors = [c for c in chips if c not in dead_set]
            if survivors == chips:
                continue
            for chip in chips:
                if chip in dead_set:
                    self._evicted.setdefault(chip, {}).setdefault(
                        name, tuple(chips))
            if survivors:
                servables[name] = survivors
                replicated.append(name)
            else:
                target = self._least_loaded(live, servables)
                servables[name] = [target] if target is not None else []
                moved.append(name)
        return servables, moved, replicated

    @staticmethod
    def _least_loaded(live: List[int],
                      servables: Dict[str, List[int]]) -> Optional[int]:
        if not live:
            return None
        load = {c: 0 for c in live}
        for chips in servables.values():
            for c in chips:
                if c in load:
                    load[c] += 1
        return min(live, key=lambda c: (load[c], c))

    def _publish_cas(self, edit: Callable[[Any], Dict[str, List[int]]]
                     ) -> Tuple[Optional[Any], int]:
        """Publish ``edit(base)`` through the SHARED generation stream
        with compare-and-swap, retrying ONCE against a fresh map on
        :class:`PlacementConflict` (the racing writer is the autoscale
        tick; both sides re-derive, neither clobbers).  Returns
        ``(pmap_or_None, conflicts)``."""
        from ..autoscale.placement import PlacementConflict

        conflicts = 0
        for _ in range(2):
            base = self.store.current()
            try:
                return self.store.publish(
                    edit(base), base.learner_workers,
                    expected_generation=base.generation), conflicts
            except PlacementConflict:
                conflicts += 1
                self._conflicts.inc()
        return None, conflicts

    def _failover(self, dead: List[int], *, requeued: int,
                  cause: str) -> FailoverReport:
        t0 = self.clock()
        moved_out: List[str] = []
        replicated_out: List[str] = []

        def edit(base):
            moved_out.clear()
            replicated_out.clear()
            servables, moved, replicated = self._evict(base, dead)
            moved_out.extend(moved)
            replicated_out.extend(replicated)
            return servables

        pmap, conflicts = self._publish_cas(edit)
        if pmap is not None:
            self.scheduler.apply_placement(pmap)
            self._readmit(moved_out)
        # raising the brownout is immediate — capacity is short NOW
        self._settle_brownout()
        t1 = self.clock()
        report = FailoverReport(
            detected_at=t0, resolved_at=t1, dead_chips=tuple(dead),
            generation=pmap.generation if pmap is not None else -1,
            moved=tuple(moved_out), replicated=tuple(replicated_out),
            requeued=requeued, conflicts=conflicts, cause=cause)
        self.reports.append(report)
        self._failovers.inc()
        self._chips_lost.inc(len(dead))
        if requeued:
            self._requeued.inc(requeued)
        self._wall_gauge.set(report.wall_s)
        self.health.publish(self.group)
        tracer.instant(
            "failover_complete", cat="serving",
            generation=report.generation,
            x_dead=",".join(str(c) for c in dead), x_cause=cause,
            x_moved=str(len(moved_out)),
            x_replicated=str(len(replicated_out)),
            x_requeued=str(requeued), x_wall_s=f"{report.wall_s:.6f}")
        return report

    def _readmit(self, moved: List[str]) -> None:
        """Re-placement IS an admission: confirm each fully-evicted
        tenant's servable ready (it warmed at its admission, so this
        builds nothing — library loads and plan builds are counted in
        the tests) and stamp a fresh registry
        generation, so serving-side consumers — an in-flight
        :class:`DeltaPublisher` above all — observe the move and
        re-anchor onto the re-placed generation (their existing
        ``GenerationConflict`` heal, idempotent by construction)."""
        from .registry import GenerationConflict

        registry = getattr(self.scheduler, "registry", None)
        if registry is None:
            return
        done = set()
        for name in moved:
            try:
                tenant = self.scheduler.tenant(name)
            except KeyError:
                continue            # placed but not admitted: no-op
            if tenant.serve_name in done:
                continue            # shared servable: readmit ONCE
            done.add(tenant.serve_name)
            try:
                deployed = registry.current(tenant.serve_name)
            except KeyError:
                continue
            servable = deployed.servable
            if not getattr(servable, "ready", True):
                servable.warm_up()
            try:
                registry.publish_servable(
                    tenant.serve_name, servable,
                    source="<failover-readmit>", metrics=tenant.metrics,
                    mode="full",
                    expected_generation=deployed.generation)
            except GenerationConflict:
                # a concurrent publish already moved the generation —
                # the consumer will re-anchor onto THAT one; idempotent
                pass

    # -- recovery + hysteresis -----------------------------------------------
    def _maybe_restore(self) -> None:
        """Put a recovered chip's tenants back — but only once the chip
        has stayed live for ``hysteresis_s`` on the injected clock.  A
        flapping chip therefore costs at most ONE eviction per
        stability window and zero restores while it flaps."""
        now = self.clock()
        ready = []
        for chip in sorted(self._evicted):
            since = self.health.live_since(chip)
            if since is not None and now - since >= self.hysteresis_s:
                ready.append(chip)
        for chip in ready:
            record = self._evicted.pop(chip)

            def edit(base, record=record):
                servables = {name: list(chips)
                             for name, chips in base.servables.items()}
                for name, original in record.items():
                    if name not in servables:
                        continue
                    restored = [c for c in original
                                if self.health.is_live(c)]
                    if restored:
                        servables[name] = restored
                return servables

            pmap, _ = self._publish_cas(edit)
            if pmap is None:
                self._evicted[chip] = record    # retry next tick
                continue
            self.scheduler.apply_placement(pmap)
            self._restores.inc()
            tracer.instant("failover_restore", cat="serving",
                           generation=pmap.generation, x_chip=str(chip))

    def _settle_brownout(self) -> None:
        """Map the capacity deficit onto the ladder: raising is
        immediate, lowering dwells ``hysteresis_s`` of stable target on
        the injected clock."""
        snap = self.health.snapshot()
        total = snap["chips_live"] + snap["chips_down"]
        deficit = snap["chips_down"] / total if total else 0.0
        target = 0
        for rung, threshold in enumerate(self.brownout_deficits):
            if deficit >= threshold:
                target = rung + 1
        if target >= self._level:
            if target > self._level:
                self._apply_brownout(target)
            self._pending_level = None
            return
        now = self.clock()
        if self._pending_level != target:
            self._pending_level = target
            self._pending_since = now
            return
        if now - self._pending_since >= self.hysteresis_s:
            self._apply_brownout(target)
            self._pending_level = None

    def _apply_brownout(self, level: int) -> None:
        self._level = level
        set_brownout = getattr(self.scheduler, "set_brownout", None)
        if set_brownout is not None:
            set_brownout(level)
        self._brownout_gauge.set(level)
        tracer.instant("brownout", cat="serving", x_level=str(level))

    # -- replication ---------------------------------------------------------
    def ensure_replicas(self, name: str, n: int) -> Any:
        """Grow ``name``'s placement to ``n`` distinct live chips
        (least-loaded first, deterministic).  An added replica is
        placement bookkeeping only — and a replicated tenant survives
        any single chip loss with a surviving chip already placed: its
        failover window is one dispatch, never a re-warm.  Returns the
        published map (or the current one when already satisfied)."""
        if n < 1:
            raise ValueError("replica count must be >= 1")
        base = self.store.current()
        if len(base.chips_for(name)) >= n:
            return base

        def edit(base):
            servables = {tname: list(chips)
                         for tname, chips in base.servables.items()}
            chips = list(servables.get(name, ()))
            while len(chips) < n:
                live = [c for c in self.health.live() if c not in chips]
                target = self._least_loaded(live, servables)
                if target is None:
                    break           # fleet smaller than n: best effort
                chips.append(target)
                servables[name] = sorted(chips)
            return servables

        pmap, _ = self._publish_cas(edit)
        if pmap is None:
            return self.store.current()
        self.scheduler.apply_placement(pmap)
        tracer.instant("replica_placed", cat="serving", tenant=name,
                       generation=pmap.generation,
                       x_replicas=str(len(pmap.chips_for(name))))
        return pmap

    # -- observability -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """MetricsTree provider (``default_tree(failover=...)``): the
        driver's counters/gauges plus the lease table's fleet view."""
        self.health.publish(self.group)
        out = self.group.snapshot()
        out["health_epoch"] = self.health.epoch
        out["evicted_chips_pending_restore"] = len(self._evicted)
        return out
