"""Multi-tenant serving scheduler: one device, many models.

A port of the JAX package's ``serving/scheduler.py`` (host code).  A
per-model endpoint gives every model its own queue, batcher and serve
thread; :class:`SharedScheduler` replaces that with ONE admission and
placement layer over many servables on one device, for zipfian traffic
(a few hot tenants, a long tail) and mixed workloads (a human waiting on
a click next to a nightly bulk scorer):

- **Global micro-batching per (servable, bucket).**  Pending requests
  coalesce across every tenant mapped to the same servable, so a hot
  schema fills its power-of-two bucket faster than any per-endpoint
  queue could (tenants sharing one model ride one batch).
- **SLO classes with priority shedding.**  Every tenant is
  ``interactive`` / ``standard`` / ``bulk``.  Admission is one global
  queue budget with per-class thresholds: bulk admits only while the
  queue is under its (lowest) threshold, standard under its higher one,
  interactive up to full capacity — so under a load ramp, bulk is shed
  strictly before standard, and standard strictly before interactive
  ever sheds.  Classes are also strict dispatch priorities: the
  scheduler never forms a bulk batch while an interactive request is
  queued, and a coalescing wait on a lower class is PREEMPTED the moment
  a higher class goes pending.  The scheduler's ``health`` gauge flips
  ``SERVING`` -> ``DEGRADED`` while load is being shed and heals once
  the queue recedes below every class threshold.
- **Weighted fair queuing within a class.**  Each tenant carries a
  virtual-finish tag (start-time fair queuing): serving ``rows`` from a
  tenant advances its tag by ``rows / weight``, the scheduler always
  picks the lowest tag in the highest non-empty class, and a tenant
  going from idle to backlogged re-enters at the class's virtual time
  (no banked credit).  Backlogged same-class tenants therefore share
  throughput in proportion to their weights.
- **Admission adds no build.**  A tenant's servable runs its model's
  terminal kernel with params as arguments: admitting tenant N+1 whose
  model shares an already-served schema loads no kernel library and
  builds no plan beyond its own bind; its ``admission_report`` is the
  warm-up report.
- **Lossless chip faults.**  An injected ``chip_down`` / ``chip_flap``
  at the dispatch boundary (``DISPATCH_SCOPE``) requeues the formed
  batch at the front of its tenants' queues with futures intact and
  hands the fault to an attached failover driver (``serving/failover.py``);
  the retried dispatch answers them bit-identically.
- **Brownout and placement.**  While the failover driver has the fleet
  capacity-short, ``set_brownout(L)`` sheds the bottom L SLO classes at
  admission (interactive never); ``apply_placement`` adopts an autoscale
  placement map by scaling each tenant's WFQ weight with its chip count.
- **Continuous publishes.**  ``delta_publisher(name)`` binds the online
  publish protocol (``online/publish.py``) to one tenant's registry
  entry and metrics.

Observability: every tenant owns a full :class:`ServingMetrics` subtree
under ``scheduler.tenants.<name>.*``, the scheduler itself exports
class-labeled shed counters and the health gauge, and serving spans carry
the ``tenant`` correlation key (``obs.CORRELATION_KEYS``).

Threading model: ``submit`` from any number of client threads (with a
LOCK-FREE overload fast path — under saturation, shed decisions never
serialize on the queue lock); ONE scheduler thread runs the
pick → coalesce → dispatch loop, so per-servable execution is serial by
construction (the single-consumer contract the embedding-row cache
relies on, ``serving/embcache.py``).
"""

from __future__ import annotations

import logging
import threading
import time

from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

from ..data.table import Table
from ..obs.trace import tracer
from ..robustness.faults import (InjectedChipDown, InjectedChipFlap,
                                 fault_point)
from ..robustness.retry import DeadlineExceededError
from ..utils.metrics import MetricGroup
from .batcher import (ServingOverloadedError, ServingRequest,
                      concat_request_tables)
from .metrics import HEALTH_DEGRADED, HEALTH_SERVING, ServingMetrics
from .registry import ModelRegistry


log = logging.getLogger("flink_ml_tpu_torch.serving")


__all__ = [
    "DISPATCH_SCOPE",
    "SLO_BULK",
    "SLO_CLASSES",
    "SLO_INTERACTIVE",
    "SLO_STANDARD",
    "SharedScheduler",
    "Tenant",
]

#: the dispatch-boundary fault seam: fired at the TOP of
#: ``_dispatch``, BEFORE the batch's predict runs — an injected
#: ``chip_down``/``chip_flap`` there loses nothing (the picked requests
#: requeue at the front of their tenants' queues with futures intact)
#: and each dispatch is one deterministic invocation index, so seeded
#: schedules replay exactly.
DISPATCH_SCOPE = "serving.dispatch"


#: SLO classes in strict priority order (dispatch AND shed order: the
#: last class is shed first and served last).
SLO_INTERACTIVE = "interactive"
SLO_STANDARD = "standard"
SLO_BULK = "bulk"
SLO_CLASSES = (SLO_INTERACTIVE, SLO_STANDARD, SLO_BULK)


#: Default per-class admission thresholds as fractions of the global
#: queue capacity.  Interactive is pinned to 1.0 by construction — it
#: only sheds when the queue is FULL; the lower classes shed earlier,
#: which is what guarantees the shed order under a load ramp.
DEFAULT_ADMIT_FRACTIONS = {
    SLO_INTERACTIVE: 1.0,
    SLO_STANDARD: 0.8,
    SLO_BULK: 0.5,
}


class Tenant:
    """One admitted tenant: its registry entry, SLO class, WFQ weight,
    pending queue, and a full per-tenant :class:`ServingMetrics`
    subtree.  Constructed by :meth:`SharedScheduler.add_tenant`."""

    def __init__(self, name: str, serve_name: str, slo: str,
                 weight: float, metrics: ServingMetrics):
        self.name = name
        #: the registry key this tenant's requests are served from —
        #: equals ``name`` unless the tenant shares another tenant's
        #: servable (``servable_of``)
        self.serve_name = serve_name
        self.slo = slo
        self.weight = weight
        #: the admission-time weight — ``apply_placement`` rescales
        #: ``weight`` by the tenant's chip count RELATIVE to this, so
        #: placements compose instead of compounding
        self.base_weight = weight
        self.metrics = metrics
        self.pending: deque = deque()
        #: WFQ virtual-finish tag (rows served / weight, class-relative)
        self.vft = 0.0
        #: total rows served — the fairness-share evidence
        self.rows_served = 0
        #: the warm-up report of this tenant's admission (None for
        #: shared-servable tenants: nothing was deployed)
        self.admission_report: Optional[dict] = None
        #: the precision this tenant's servable scores at ("f32" /
        #: "int8") — shared-servable tenants inherit the sharing
        #: tenant's; mirrored as a per-tenant string gauge
        self.precision = "f32"


class SharedScheduler:
    """One admission/placement layer multiplexing many servables on one
    device (module doc).  ``add_tenant`` deploys + warms, ``start()``
    spawns the scheduler thread, ``submit``/``predict`` take the tenant
    name."""

    def __init__(self, registry: Optional[ModelRegistry] = None, *,
                 max_batch_rows: int = 256, max_wait_ms: float = 2.0,
                 queue_capacity: int = 1024,
                 admit_fractions: Optional[Dict[str, float]] = None,
                 bulk_batch_rows: Optional[int] = None,
                 request_deadline_ms: Optional[float] = None,
                 group: Optional[MetricGroup] = None,
                 busy_clock: Optional[Any] = None):
        if max_batch_rows <= 0:
            raise ValueError("max_batch_rows must be positive")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if queue_capacity <= 0:
            raise ValueError("queue_capacity must be positive")
        if request_deadline_ms is not None and request_deadline_ms <= 0:
            raise ValueError("request_deadline_ms must be positive "
                             "(or None to disable the deadline check)")
        self.registry = registry or ModelRegistry()
        self.max_batch_rows = max_batch_rows
        self.max_wait_s = max_wait_ms / 1e3
        self.queue_capacity = queue_capacity
        fractions = dict(DEFAULT_ADMIT_FRACTIONS)
        fractions.update(admit_fractions or {})
        if set(fractions) != set(SLO_CLASSES):
            raise ValueError(
                f"admit_fractions keys must be {SLO_CLASSES}, got "
                f"{tuple(sorted(fractions))}")
        last = 1.0 + 1e-9
        for slo in SLO_CLASSES:
            frac = fractions[slo]
            if not 0.0 < frac <= 1.0:
                raise ValueError(
                    f"admit fraction for {slo!r} must be in (0, 1], got "
                    f"{frac}")
            if frac > last:
                raise ValueError(
                    "admit fractions must be non-increasing in priority "
                    f"order {SLO_CLASSES} — a lower class admitting above "
                    "a higher one inverts the shed-order contract")
            last = frac
        #: per-class admission threshold in REQUESTS: a class sheds once
        #: the global queue depth reaches its limit
        self.admit_limits = {
            slo: max(1, int(round(queue_capacity * fractions[slo])))
            for slo in SLO_CLASSES}
        self.admit_limits[SLO_INTERACTIVE] = queue_capacity
        #: per-class batch-row cap.  A dispatched batch is not
        #: preemptible, so a FULL bulk batch is the worst head-of-line
        #: block an interactive arrival can hit — capping bulk batches
        #: at a quarter of the device batch (default; still a real
        #: bucket) bounds that block at ~1/4 of a batch service, a
        #: deliberate bulk-throughput-for-interactive-latency trade.
        #: Interactive/standard keep the full batch.
        if bulk_batch_rows is None:
            bulk_batch_rows = min(max_batch_rows,
                                  max(8, max_batch_rows // 4))
        if not 0 < bulk_batch_rows <= max_batch_rows:
            raise ValueError(
                f"bulk_batch_rows must be in (0, {max_batch_rows}], got "
                f"{bulk_batch_rows}")
        self.batch_rows = {SLO_INTERACTIVE: max_batch_rows,
                           SLO_STANDARD: max_batch_rows,
                           SLO_BULK: bulk_batch_rows}
        #: SLO deadline in seconds: a REQUEUED request (a
        #: chip died under its dispatch) already past this deadline
        #: sheds with :class:`DeadlineExceededError` instead of burning
        #: survivor capacity on an answer its caller stopped waiting
        #: for.  None = never expire (the default; first-dispatch
        #: requests are never deadline-checked — only the requeue path
        #: can make a request old enough to matter).
        self.request_deadline_s = (None if request_deadline_ms is None
                                   else request_deadline_ms / 1e3)

        self.group = group or MetricGroup("scheduler")
        self._batches = self.group.counter("batches")
        self._requests = self.group.counter("requests")
        self._queue_depth = self.group.gauge("queue_depth")
        self._queue_depth.set(0)
        self._health = self.group.gauge("health")
        self._health.set(HEALTH_SERVING)
        #: class-labeled shed counters — the shed-order evidence
        self._shed = {slo: self.group.counter(f"shed_{slo}")
                      for slo in SLO_CLASSES}
        #: requests put BACK at the head of their queues after an
        #: injected chip fault at the dispatch boundary (futures intact
        #: — the zero-drop evidence), and requests shed at requeue for
        #: blowing their SLO deadline
        self._requeued = self.group.counter("requeued_requests")
        self._deadline_shed = self.group.counter("deadline_shed")
        #: brownout: level L sheds the bottom L SLO classes at ADMISSION
        #: while failover has the fleet capacity-short — bulk first,
        #: interactive protected by construction (the ladder tops out
        #: below the highest class).  Plain int read by the lock-free
        #: submit path, written by ``set_brownout``.
        self._brownout = 0
        self._brownout_gauge = self.group.gauge("brownout_level")
        self._brownout_gauge.set(0)
        #: the attached failover driver (None until a FailoverDriver
        #: binds itself) — the dispatch seam hands it chip faults
        self._failover: Optional[Any] = None
        #: per-SLO-class queue depth gauges (the aggregate gauge hides
        #: the INTERACTIVE depth under a bulk flood)
        self._class_depth = {slo: self.group.gauge(f"queue_depth_{slo}")
                             for slo in SLO_CLASSES}
        for gauge in self._class_depth.values():
            gauge.set(0)
        #: tenants serving quantized: the capacity planner's
        #: models-per-chip arithmetic needs to know how many tenants
        #: ride the int8 footprint; the per-tenant ``precision`` string
        #: gauge says WHICH
        self._int8_tenants = self.group.gauge("int8_tenants")
        self._int8_tenants.set(0)
        #: chip-idle accounting: busy seconds accumulate
        #: around dispatch on ONE clock (``busy_clock``, injectable for
        #: tests), and ``chip_idle_fraction`` is windowed between
        #: snapshot() calls on that SAME clock — idle is
        #: 1 - busy/wall with both deltas from one domain, never a
        #: cross-clock ratio.  NaN until the first complete window
        #: (absent, not faked — the obs export stance).
        self._busy_clock = busy_clock or time.perf_counter
        self._busy_s = 0.0
        self._idle_window_start: Optional[float] = None
        self._idle_window_busy = 0.0
        self._idle_fraction = self.group.gauge("chip_idle_fraction")
        self._idle_fraction.set(float("nan"))
        #: the placement generation last applied via apply_placement —
        #: -1 until an autoscale controller or failover first moves it
        self._placement_generation = self.group.gauge(
            "placement_generation")
        self._placement_generation.set(-1)
        self._tenant_group = self.group.add_group("tenants")

        self._tenants: Dict[str, Tenant] = {}
        #: names mid-admission (reserved before their slow unlocked
        #: deploy so a concurrent same-name admit loses BEFORE it can
        #: leave an orphaned generation in the registry)
        self._admitting: set = set()
        self._cond = threading.Condition()
        #: total queued requests across every tenant.  Plain int: the
        #: submit fast path reads it WITHOUT the lock (a stale read can
        #: only mis-shed at the saturation boundary, where shedding is
        #: the correct behavior anyway); all writes happen under
        #: ``_cond``.
        self._depth = 0
        #: per-class virtual time: the largest finish tag served so far
        #: — an idle tenant re-enters here instead of replaying banked
        #: credit against the tenants that kept the device busy
        self._vclass = {slo: 0.0 for slo in SLO_CLASSES}
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # -- tenancy -------------------------------------------------------------
    def add_tenant(self, name: str, model: Any = None,
                   example: Optional[Table] = None, *,
                   slo: str = SLO_STANDARD, weight: float = 1.0,
                   servable_of: Optional[str] = None,
                   **servable_kwargs: Any) -> Tenant:
        """Admit a tenant: deploy ``model`` (instance or saved-stage
        path) under the tenant's name and warm it — or, with
        ``servable_of``, share an existing tenant's servable (traffic
        multi-tenancy: N tenants, one model, one batch stream).

        Admission happens OFF the serving path (warm-up runs on this
        thread while every admitted tenant keeps serving); the returned
        tenant's ``admission_report`` is its servable's warm-up
        report."""
        if slo not in SLO_CLASSES:
            raise ValueError(f"unknown SLO class {slo!r}; one of "
                             f"{SLO_CLASSES}")
        if weight <= 0:
            raise ValueError("weight must be positive")
        # RESERVE the name before the (slow, unlocked) deploy: two
        # concurrent admits of one name must not both reach the
        # registry — the loser's deploy would stay live and serve the
        # winner's traffic with the wrong model
        with self._cond:
            if name in self._tenants or name in self._admitting:
                raise ValueError(f"tenant {name!r} already admitted")
            self._admitting.add(name)
        try:
            # spaced expensive-gauge refresh: ONE loop drives every
            # tenant's metrics, so per-batch O(window) quantile work
            # would multiply by the tenant count and come straight out
            # of serving latency
            metrics = ServingMetrics(
                group=self._tenant_group.add_group(name),
                min_publish_interval_s=0.02)
            # the class label rides the tenant's own subtree so signal
            # consumers (autoscale) can group tenants per SLO from one
            # snapshot; a string gauge stays out of prometheus exports
            metrics.group.gauge("slo").set(slo)
            if servable_of is not None:
                if model is not None or example is not None:
                    raise ValueError(
                        "servable_of shares an existing servable — do "
                        "not pass model/example")
                sharing = self._tenants.get(servable_of)
                if sharing is None:
                    raise KeyError(f"servable_of={servable_of!r} is not "
                                   "an admitted tenant")
                serve_name = sharing.serve_name
                report = None
                precision = sharing.precision
            else:
                if model is None:
                    raise ValueError("admitting a tenant needs a model "
                                     "(or servable_of=)")
                serve_name = name
                servable_kwargs.setdefault("max_batch_rows",
                                           self.max_batch_rows)
                deployed = self.registry.deploy(
                    name, model, example, metrics=metrics,
                    **servable_kwargs)
                report = getattr(deployed.servable, "warmup_report", None)
                precision = getattr(deployed.servable, "precision",
                                    "f32")
            # the precision label rides the tenant subtree like the SLO
            # class (a string gauge stays out of prometheus exports)
            metrics.group.gauge("precision").set(precision)
            tenant = Tenant(name, serve_name, slo, weight, metrics)
            tenant.admission_report = report
            tenant.precision = precision
            with self._cond:
                self._tenants[name] = tenant
        finally:
            with self._cond:
                self._admitting.discard(name)
        tracer.instant("tenant_admitted", cat="serving", tenant=name,
                       op=slo)
        return tenant

    def tenant(self, name: str) -> Tenant:
        tenant = self._tenants.get(name)
        if tenant is None:
            raise KeyError(f"unknown tenant {name!r}; admitted: "
                           f"{sorted(self._tenants)}")
        return tenant

    def tenants(self) -> List[str]:
        with self._cond:
            return sorted(self._tenants)

    def delta_publisher(self, name: str):
        """A continuous-learning publisher bound to this tenant's
        registry entry and metrics — a delta push to one tenant swaps
        ONLY that tenant's generation; every other tenant's servable and
        latency accounting are untouched."""
        from ..online.publish import DeltaPublisher

        tenant = self.tenant(name)
        return DeltaPublisher(self.registry, tenant.serve_name,
                              metrics=tenant.metrics)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SharedScheduler":
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        for tenant in self._tenants.values():
            deployed = self.registry.current(tenant.serve_name)
            if not deployed.servable.ready:
                raise RuntimeError(
                    f"tenant {tenant.name!r} servable is not warmed — "
                    "add_tenant warms automatically; a custom deploy "
                    "must warm_up() before start()")
        self._thread = threading.Thread(
            target=self._serve_loop, daemon=True,
            name="flink-ml-tpu-torch-scheduler")
        self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting, drain queued requests, join the loop."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- request path --------------------------------------------------------
    def submit(self, name: str, table: Table) -> Future:
        """Enqueue one request for ``name``; sheds with
        :class:`ServingOverloadedError` once the global queue reaches
        the tenant's CLASS threshold (bulk first, interactive last).

        The overload check runs TWICE: a lock-free fast path on the
        plain depth counter — under saturation every shed returns
        without ever touching the queue lock, so admission control
        cannot serialize the very load spike it exists to absorb — and
        the authoritative re-check under the lock for admits near the
        boundary."""
        tenant = self.tenant(name)
        rows = table.num_rows
        if rows == 0:
            raise ValueError("cannot serve an empty (0-row) request")
        if rows > self.batch_rows[tenant.slo]:
            raise ValueError(
                f"request has {rows} rows > the {tenant.slo!r} class's "
                f"batch cap {self.batch_rows[tenant.slo]}; split it "
                "client-side")
        # brownout gate: while failover has the fleet capacity-short,
        # level L refuses the bottom L classes outright — lock-free like
        # the overload fast path, and accounted as a shed (it IS one,
        # just triggered by capacity instead of depth)
        brownout = self._brownout
        if (brownout > 0 and self._class_rank(tenant.slo)
                >= len(SLO_CLASSES) - brownout):
            raise self._brownout_error(tenant, brownout)
        limit = self.admit_limits[tenant.slo]
        if self._depth >= limit:          # lock-free fast path
            raise self._shed_error(tenant, self._depth, limit)
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self._depth >= limit:      # authoritative re-check
                raise self._shed_error(tenant, self._depth, limit)
            request = ServingRequest(table, rows)
            if not tenant.pending:
                # idle -> backlogged: re-enter at the class virtual time
                tenant.vft = max(tenant.vft, self._vclass[tenant.slo])
            tenant.pending.append(request)
            self._depth += 1
            self._cond.notify_all()
        tenant.metrics.on_submit(len(tenant.pending))
        return request.future

    def predict(self, name: str, table: Table,
                timeout: Optional[float] = 30.0) -> Table:
        return self.submit(name, table).result(timeout)

    def _account_shed(self, tenant: Tenant, **ids: str) -> None:
        """Account one shed (class counter, tenant metrics with the live
        generation stamped, health -> DEGRADED, tracer instant).
        Deliberately lock-free: counter bumps and the registry's unlocked
        generation read."""
        self._shed[tenant.slo].inc()
        generation = self.registry.live_generation(tenant.serve_name)
        tenant.metrics.on_shed(len(tenant.pending), generation=generation)
        self._health.set(HEALTH_DEGRADED)
        tracer.instant("shed", cat="serving", tenant=tenant.name,
                       generation=generation, **ids)

    def _shed_error(self, tenant: Tenant, depth: int,
                    limit: int) -> ServingOverloadedError:
        """Account an overload shed and build the admission-control
        error."""
        self._account_shed(tenant)
        return ServingOverloadedError(
            f"scheduler queue depth {depth} >= {limit} (class "
            f"{tenant.slo!r} threshold of capacity "
            f"{self.queue_capacity}); request shed — queue full for this "
            "class; retry with backoff or lower the offered load")

    def _brownout_error(self, tenant: Tenant,
                        level: int) -> ServingOverloadedError:
        """Account a brownout refusal exactly like an overload shed — the
        cause differs (capacity short, not queue full), the contract does
        not."""
        self._account_shed(tenant, x_brownout=str(level))
        return ServingOverloadedError(
            f"brownout level {level}: class {tenant.slo!r} is shed while "
            "the serving fleet is capacity-short after a chip loss; "
            "retry after the fleet recovers")

    # -- the scheduler loop --------------------------------------------------
    def _serve_loop(self) -> None:
        while True:
            try:
                formed = self._next_batch(timeout=0.05)
            except Exception:  # noqa: BLE001 — ONE loop serves every
                # tenant; it must survive anything batch formation throws
                log.exception("scheduler batch formation failed")
                continue
            if formed is not None:
                try:
                    self._dispatch(*formed)
                except Exception:  # noqa: BLE001 — futures are already
                    # resolved/failed by _dispatch; this guards the
                    # post-resolution accounting
                    log.exception("scheduler dispatch accounting failed")
            else:
                with self._cond:
                    if self._closed and self._depth == 0:
                        return

    def _class_rank(self, slo: str) -> int:
        return SLO_CLASSES.index(slo)

    def _pick_head(self) -> Optional[Tenant]:
        """Highest non-empty class, lowest virtual-finish tag (name as
        the deterministic tiebreak).  Caller holds the lock."""
        best: Optional[Tenant] = None
        for tenant in self._tenants.values():
            if not tenant.pending:
                continue
            if best is None:
                best = tenant
                continue
            rank, best_rank = (self._class_rank(tenant.slo),
                               self._class_rank(best.slo))
            if (rank, tenant.vft, tenant.name) < (best_rank, best.vft,
                                                  best.name):
                best = tenant
        return best

    def _drain_into(self, picked: List[Tuple[Tenant, ServingRequest]],
                    serve_name: str, slo: str, rows: int) -> int:
        """Coalesce pending same-class requests for ``serve_name`` in
        WFQ order while they fit the class's batch cap.  Caller holds
        the lock."""
        cap = self.batch_rows[slo]
        while True:
            cands = [t for t in self._tenants.values()
                     if t.slo == slo and t.serve_name == serve_name
                     and t.pending
                     and rows + t.pending[0].rows <= cap]
            if not cands:
                return rows
            tenant = min(cands, key=lambda t: (t.vft, t.name))
            request = tenant.pending.popleft()
            self._depth -= 1
            tenant.vft += request.rows / tenant.weight
            self._vclass[slo] = max(self._vclass[slo], tenant.vft)
            picked.append((tenant, request))
            rows += request.rows

    def _next_batch(self, timeout: Optional[float] = None):
        """Form the next micro-batch: pick the WFQ head in the highest
        pending class, then coalesce same-class arrivals for the same
        servable under the max-wait deadline — preempted early if a
        HIGHER class goes pending (its requests must never queue behind
        a lower class's coalescing window)."""
        with self._cond:
            if self._depth == 0:
                if self._closed:
                    return None
                self._cond.wait(timeout)
                if self._depth == 0:
                    return None
            head = self._pick_head()
            serve_name, slo = head.serve_name, head.slo
            picked: List[Tuple[Tenant, ServingRequest]] = []
            rows = 0
            deadline = time.perf_counter() + self.max_wait_s
            while True:
                rows = self._drain_into(picked, serve_name, slo, rows)
                if rows >= self.batch_rows[slo] or self._closed \
                        or self._depth > 0:
                    # full — or OTHER work is queued (a higher class, a
                    # different servable, a request that didn't fit):
                    # the coalescing deadline may hold the device only
                    # when it would otherwise idle, never while any
                    # request waits — ship now, re-pick next loop (a
                    # pending higher class preempts a lower batch's
                    # window here)
                    break
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            depth = self._depth
        self._queue_depth.set(depth)
        if not picked:
            return None
        return serve_name, picked

    # -- dispatch ------------------------------------------------------------
    def _requeue(self,
                 picked: List[Tuple[Tenant, ServingRequest]]) -> int:
        """Put a formed-but-undispatched batch BACK: each request
        returns to the FRONT of its tenant's queue (reversed, so the
        original order is restored), the WFQ tags and depth roll back,
        and the futures stay untouched — the retried dispatch answers
        them bit-identically, so a chip death drops ZERO requests.  A
        requeued request already past its SLO deadline sheds with
        :class:`DeadlineExceededError` instead (futures failed OUTSIDE
        the lock).  Returns the number requeued."""
        deadline_s = self.request_deadline_s
        now = time.perf_counter() if deadline_s is not None else 0.0
        expired: List[Tuple[Tenant, ServingRequest]] = []
        requeued: Dict[str, int] = {}
        with self._cond:
            for tenant, request in reversed(picked):
                # roll the WFQ advance back first — it happened in
                # _drain_into for every picked request, served or not
                tenant.vft -= request.rows / tenant.weight
                if (deadline_s is not None
                        and now - request.submitted_at > deadline_s):
                    expired.append((tenant, request))
                    continue
                tenant.pending.appendleft(request)
                self._depth += 1
                requeued[tenant.name] = requeued.get(tenant.name, 0) + 1
            if requeued:
                self._cond.notify_all()
        n = sum(requeued.values())
        if n:
            self._requeued.inc(n)
        for name, count in requeued.items():
            self._tenants[name].metrics.on_requeue(count)
        for tenant, request in expired:
            self._deadline_shed.inc()
            self._shed[tenant.slo].inc()
            generation = self.registry.live_generation(tenant.serve_name)
            tenant.metrics.on_shed(len(tenant.pending),
                                   generation=generation)
            tracer.instant("deadline_shed", cat="serving",
                           tenant=tenant.name, generation=generation,
                           request_id=request.request_id)
            request.future.set_exception(DeadlineExceededError(
                f"request for tenant {tenant.name!r} requeued after a "
                f"chip fault is already {now - request.submitted_at:.3f}s"
                f" old > the {deadline_s:.3f}s SLO deadline; shed "
                "instead of burning survivor capacity"))
        return n

    def _dispatch(self, serve_name: str,
                  picked: List[Tuple[Tenant, ServingRequest]]) -> None:
        # the chip-fault seam: fired BEFORE anything else — an injected
        # chip_down/chip_flap here requeues the batch with futures intact
        # (lossless by construction) and hands the fault to the attached
        # FailoverDriver, which re-places; the next loop retries it
        try:
            fault_point(DISPATCH_SCOPE)
        except (InjectedChipDown, InjectedChipFlap) as exc:
            requeued = self._requeue(picked)
            driver = self._failover
            if driver is not None:
                driver.on_chip_fault(exc, requeued=requeued)
            return
        # ONE registry capture per batch — the hot-swap atomicity point
        # (every request in the batch runs on one fully-warmed version).
        # Any failure before the futures resolve is delivered TO them:
        # a caller must never hang on a batch the loop gave up on.
        try:
            deployed = self.registry.current(serve_name)
        except BaseException as exc:  # noqa: BLE001 — e.g. undeployed
            for _, request in picked:
                request.future.set_exception(exc)
            return
        servable = deployed.servable
        rows = sum(r.rows for _, r in picked)
        batch_tenants = ",".join(sorted({t.name for t, _ in picked}))
        if tracer.enabled:
            formed = time.perf_counter()
            for tenant, request in picked:
                tracer.add("queue_wait", request.submitted_at, formed,
                           cat="serving", request_id=request.request_id,
                           generation=deployed.generation,
                           tenant=tenant.name)
        busy_t0 = self._busy_clock()
        try:
            with tracer.span("serve_batch", cat="serving",
                             generation=deployed.generation,
                             bucket=servable.bucket_for(rows),
                             tenant=batch_tenants):
                for _, request in picked:
                    servable.check_schema(request.table)
                table = concat_request_tables(
                    [r.table for _, r in picked])
                out = servable.predict(table)
        except BaseException as exc:  # noqa: BLE001 — delivered per-request
            for _, request in picked:
                request.future.set_exception(exc)
            return
        finally:
            # device-busy accounting: even a failed dispatch occupied
            # the chip — idle means NOTHING dispatched, not "nothing
            # succeeded"
            self._busy_s += self._busy_clock() - busy_t0
        offset = 0
        now = time.perf_counter()
        per_tenant: Dict[str, List] = {}
        for tenant, request in picked:
            if tracer.enabled:
                # committed BEFORE the future resolves (a woken caller
                # can already see its own span)
                tracer.add("request", request.submitted_at, now,
                           cat="serving", request_id=request.request_id,
                           generation=deployed.generation,
                           tenant=tenant.name)
            request.future.set_result(
                out.slice(offset, offset + request.rows))
            offset += request.rows
            bucket_n, bucket_rows_, lats = per_tenant.setdefault(
                tenant.name, [0, 0, []])
            per_tenant[tenant.name] = [
                bucket_n + 1, bucket_rows_ + request.rows,
                lats + [now - request.submitted_at]]
        bucket = servable.bucket_for(rows)
        for name, (n_requests, t_rows, latencies) in per_tenant.items():
            tenant = self._tenants[name]
            tenant.rows_served += t_rows
            tenant.metrics.on_batch(
                n_requests=n_requests, rows=t_rows, bucket=bucket,
                latencies_s=latencies, queue_depth=len(tenant.pending),
                generation=deployed.generation)
        self._batches.inc()
        self._requests.inc(len(picked))
        depth = self._depth
        self._queue_depth.set(depth)
        # heal: once the queue recedes below EVERY class threshold,
        # nothing is being shed anymore — degradation is over.  An
        # active brownout blocks the heal: admission is still refusing
        # whole classes, so the scheduler IS degraded however shallow
        # the queue looks
        if (self._health.value != HEALTH_SERVING
                and depth < min(self.admit_limits.values())
                and self._brownout == 0):
            self._health.set(HEALTH_SERVING)

    # -- placement -----------------------------------------------------------
    def apply_placement(self, pmap: Any) -> Dict[str, float]:
        """Adopt an autoscale :class:`~flink_ml_tpu_torch.autoscale.\
placement.PlacementMap`: every placed tenant's WFQ weight becomes
        ``base_weight * chip_count`` — capacity share tracks the chip
        share the controller granted — and unplaced tenants keep their
        admission weight.  Pure bookkeeping on this (single-device)
        scheduler: no queue is touched, no batch re-formed; in-flight
        requests are unaffected.  Returns the applied name -> weight
        map (the actuation receipt the controller logs)."""
        with self._cond:
            applied: Dict[str, float] = {}
            for tenant in self._tenants.values():
                chips = len(pmap.chips_for(tenant.name))
                if chips > 0:
                    tenant.weight = tenant.base_weight * chips
                    applied[tenant.name] = tenant.weight
                else:
                    tenant.weight = tenant.base_weight
            self._placement_generation.set(pmap.generation)
        tracer.instant("placement_applied", cat="serving",
                       generation=pmap.generation,
                       x_tenants=str(len(applied)))
        return applied

    # -- failover ------------------------------------------------------------
    def attach_failover(self, driver: Any) -> None:
        """Bind the :class:`~flink_ml_tpu_torch.serving.failover.\
FailoverDriver`: the dispatch seam hands it injected chip faults
        (after requeueing the batch) and it drives ``set_brownout``."""
        self._failover = driver

    def set_brownout(self, level: int) -> int:
        """Set the brownout ladder rung: level L sheds the bottom L SLO
        classes at admission (0 = none).  Clamped so the highest class
        can NEVER be browned out — interactive protection is by
        construction, not configuration.  Lowering to 0 re-checks the
        heal condition (brownout blocks it while active)."""
        level = max(0, min(int(level), len(SLO_CLASSES) - 1))
        self._brownout = level
        self._brownout_gauge.set(level)
        if level > 0:
            self._health.set(HEALTH_DEGRADED)
        elif (self._health.value != HEALTH_SERVING
                and self._depth < min(self.admit_limits.values())):
            self._health.set(HEALTH_SERVING)
        return level

    @property
    def brownout_level(self) -> int:
        return self._brownout

    # -- observability -------------------------------------------------------
    @property
    def health(self) -> str:
        return self._health.value

    def shed_counts(self) -> Dict[str, int]:
        return {slo: c.value for slo, c in self._shed.items()}

    def _refresh_gauges(self) -> None:
        """Export-time gauge refresh: per-class queue depths (summed
        under the lock — the dispatch path never pays for them) and the
        windowed chip-idle fraction, both deltas on ``_busy_clock``."""
        with self._cond:
            depths = {slo: 0 for slo in SLO_CLASSES}
            int8_tenants = 0
            for tenant in self._tenants.values():
                depths[tenant.slo] += len(tenant.pending)
                int8_tenants += tenant.precision == "int8"
            busy = self._busy_s
        for slo, depth in depths.items():
            self._class_depth[slo].set(depth)
        self._int8_tenants.set(int8_tenants)
        now = self._busy_clock()
        if self._idle_window_start is not None:
            wall = now - self._idle_window_start
            if wall > 0:
                frac = 1.0 - (busy - self._idle_window_busy) / wall
                self._idle_fraction.set(min(1.0, max(0.0, frac)))
        self._idle_window_start = now
        self._idle_window_busy = busy

    def snapshot(self) -> Dict[str, Any]:
        """The scheduler's full metric subtree (scheduler gauges +
        per-tenant ServingMetrics) — a MetricsTree provider.  Tenant
        bundles space their expensive gauge refresh between batches
        (``min_publish_interval_s``), so the export path force-publishes
        each one first — exports never read interval-stale quantiles
        (the ``ServingMetrics.snapshot`` contract, kept here because
        this provider reads the shared group directly)."""
        with self._cond:
            tenants = list(self._tenants.values())
        for tenant in tenants:
            tenant.metrics.publish(force=True)
        self._refresh_gauges()
        return self.group.snapshot()
