"""Elastic data-parallel membership: the fleet as a runtime input.

A port of the JAX package's ``parallel/elastic.py``.  The meshes of the
fits are frozen at ``fit()`` time; this module makes the **dcn axis of a
``(dcn, data)`` mesh grow and shrink between chunk boundaries**:

- :class:`ElasticCoordinator`: a heartbeat **lease table** over live
  workers with an injected clock (``clock=``), so lease expiry is a
  deterministic event.  Each worker owns ``chips_per_worker`` seats of a
  fixed pool; the current fleet is a ``(dcn, data)`` mesh over the live
  workers' seats.
- Membership churn is **injectable through the fault seams**: the
  streamed fit calls :meth:`ElasticCoordinator.poll` once per chunk
  boundary, which fires the ``elastic.membership`` fault scope; a
  scheduled ``"join"`` / ``"preempt"`` fault
  (:mod:`..robustness.faults`) becomes a join / leave transition.
- A **resize is a restore onto a different mesh**: when ``poll`` reports
  a changed fleet the fit cuts a chunk-boundary checkpoint (carrying
  mesh-shape metadata) and raises :class:`ResizeRequested`;
  ``resilient_fit(elastic=...)`` rebuilds the mesh and re-runs with
  ``resume=True``, and the restore re-shards the reducer state through
  :func:`~.grad_reduce.reshard_state`.

**Seats are ranks.**  In the JAX package the pool is the devices of one
process.  The port runs one process a device, so the pool is the ranks of
a ``torch.distributed`` world (``devices=``, default every rank of the
initialized group): spawn ``max_workers * chips_per_worker`` ranks and
run the same supervised fit, with an identically built coordinator, on
every one of them.  The coordinator is replicated: it changes only
through its calls, its injected clock and the fault schedules, so every
rank holds the same table.  :meth:`ElasticCoordinator.mesh` is the mesh
of the live workers' ranks (:func:`~.mesh.fleet_mesh`; every rank of the
world makes its groups, in the same order).  A rank outside the fleet
makes no collective of the fleet's: the supervisor parks it in
:meth:`ElasticCoordinator.idle`, which follows the fleet's chunk
boundaries (one small broadcast a boundary over the world, so that every
rank polls the membership seam and fires its schedule alike) until the
fleet's rank 0 ends the attempt (:meth:`ElasticCoordinator.end_attempt`).
A schedule of another fault scope fires on the ranks that reach its seam;
keep such schedules on seams every rank of the fleet reaches together
(a source pull, a boundary), as the JAX package's chaos tests do.

Exactness contract (the JAX package's): a resize at a chunk boundary is
bit-exact against a fixed fleet of the new size restoring the same cut
(same reduce order: both sides route through the same reshard mapping and
the same code).  A worker death in mid-chunk degrades to the crash path:
the supervisor revokes the victim's lease (:meth:`on_failure`) and
recovery resumes from the newest valid cut onto the surviving fleet.  The
mesh lists the fleet's ranks ascending, the order torch numbers a group's
ranks in; the JAX package lists devices in join order, which is the same
order wherever seats are taken lowest-first and given back newest-first.
"""

from __future__ import annotations

import threading
import time

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["ElasticCoordinator", "FleetView", "ResizeRequested",
           "WorkerLease", "MEMBERSHIP_SCOPE"]

#: The fault scope :meth:`ElasticCoordinator.poll` fires once per chunk
#: boundary: schedule ``"preempt"`` / ``"join"`` faults against it to drive
#: deterministic membership churn (indices count chunk boundaries across
#: the whole supervised run, attempts included).
MEMBERSHIP_SCOPE = "elastic.membership"


class ResizeRequested(RuntimeError):
    """Raised by an elastic fit at a chunk boundary AFTER the boundary
    checkpoint is durable: membership changed, so training must restore
    onto the new fleet's mesh.  Handled by ``resilient_fit(elastic=...)``;
    reaching user code means a fit ran with ``membership=`` but without
    an elastic supervisor."""

    def __init__(self, *, step: int, fleet_size: int,
                 membership_epoch: int):
        super().__init__(
            f"fleet changed to {fleet_size} worker(s) (membership epoch "
            f"{membership_epoch}) at step {step}; restore onto the new "
            "mesh")
        self.step = step
        self.fleet_size = fleet_size
        self.membership_epoch = membership_epoch


@dataclass
class WorkerLease:
    """One worker's seat in the fleet: the ranks it contributes
    (``devices``, the JAX package's name) and the heartbeat lease that
    keeps it alive.  ``expires_at`` is in the coordinator's injected clock
    domain; ``order`` is the join order (the LIFO victim rule keys on
    it)."""

    worker_id: str
    devices: Tuple[Any, ...]
    joined_at: float
    expires_at: float
    order: int


@dataclass(frozen=True)
class FleetView:
    """An immutable snapshot of membership: what :meth:`mesh` was built
    from, and what the obs gauges export."""

    epoch: int
    workers: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.workers)


def _world() -> Tuple[int, int]:
    """(this rank, world size): (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ElasticCoordinator:
    """Heartbeat lease table + mesh factory for an elastic dcn fleet.

    Workers own ``chips_per_worker`` seats (ranks) of ``devices`` (default
    every rank of the world), assigned lowest-free-first so the fleet's
    layout, and so the mesh and the numerics, is a pure function of the
    transition history.  The mesh is ``{dcn_axis: fleet_size, data_axis:
    chips_per_worker}`` over the live workers' ranks.

    Transitions: :meth:`register` / :meth:`leave` (planned join and
    leave), :meth:`fail` (unplanned death), :meth:`expire` (a lease that
    lapsed past ``lease_timeout_s`` on the injected clock; ``None``
    disables expiry).  Every transition bumps ``membership_epoch`` and
    appends to ``transitions``.  ``min_workers`` / ``max_workers`` bound
    the fleet: a transition that would cross a bound is suppressed and
    counted (``suppressed``), never raised.  Replicated on every rank, the
    clock must read alike on every rank (an injected clock, or no lease
    timeout)."""

    SCOPE = MEMBERSHIP_SCOPE

    def __init__(self, *, chips_per_worker: int = 1,
                 initial_workers: Optional[int] = None,
                 min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 lease_timeout_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 devices: Optional[List[Any]] = None,
                 dcn_axis: str = "dcn", data_axis: str = "data"):
        if chips_per_worker < 1:
            raise ValueError("chips_per_worker must be >= 1")
        self._pool: List[int] = (
            [int(d) for d in devices] if devices is not None
            else list(range(_world()[1])))
        pool_max = len(self._pool) // chips_per_worker
        if pool_max < 1:
            raise ValueError(
                f"device pool of {len(self._pool)} cannot seat one worker "
                f"of {chips_per_worker} chip(s)")
        self.chips_per_worker = int(chips_per_worker)
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers if max_workers is not None
                               else pool_max)
        self.max_workers = min(self.max_workers, pool_max)
        if not 1 <= self.min_workers <= self.max_workers:
            raise ValueError(
                f"need 1 <= min_workers ({self.min_workers}) <= "
                f"max_workers ({self.max_workers})")
        self.lease_timeout_s = lease_timeout_s
        self.clock = clock
        self.dcn_axis = dcn_axis
        self.data_axis = data_axis
        self._lock = threading.RLock()
        self._leases: Dict[str, WorkerLease] = {}
        self._epoch = 0            # membership epoch: bumps per transition
        self._built_epoch = -1     # epoch the last mesh() materialized
        self._next_id = 0
        self._next_order = 0
        #: the ranks of the fleet the last mesh() was built over: the
        #: attempt's fleet (its lowest rank leads the idle ranks)
        self._attempt_ranks: Tuple[int, ...] = ()
        #: audit log: (kind, worker_id, membership_epoch) per transition,
        #: kinds join/leave/preempt/death/expire/suppressed
        self.transitions: List[Tuple[str, str, int]] = []
        self.counters: Dict[str, int] = {
            "joins": 0, "leaves": 0, "preemptions": 0, "deaths": 0,
            "expirations": 0, "suppressed": 0, "resizes": 0,
            "controller_requests": 0,
        }
        #: controller-initiated resize pending application at a chunk
        #: boundary: (target_workers, at_boundary, reason)
        self._pending_resize: Optional[Tuple[int, Optional[int], str]] = None
        #: chunk boundaries seen so far: one per :meth:`poll` call, the
        #: same index space FaultPlan schedules against
        self._boundary_polls = 0
        n0 = initial_workers if initial_workers is not None else pool_max
        if not self.min_workers <= n0 <= self.max_workers:
            raise ValueError(
                f"initial_workers={n0} outside "
                f"[{self.min_workers}, {self.max_workers}]")
        for _ in range(n0):
            self.register()
        # the initial fleet is the baseline, not a pending resize
        self.transitions.clear()
        self.counters["joins"] = 0
        self._epoch = 0
        self._built_epoch = 0

    # -- lease table -------------------------------------------------------

    def _expiry(self, now: float) -> float:
        if self.lease_timeout_s is None:
            return float("inf")
        return now + self.lease_timeout_s

    def _free_devices(self) -> List[int]:
        held = {d for lease in self._leases.values() for d in lease.devices}
        return [d for d in self._pool if d not in held]

    def _record(self, kind: str, worker_id: str) -> None:
        self._epoch += 1
        self.transitions.append((kind, worker_id, self._epoch))
        from ..obs.trace import tracer

        tracer.instant("membership", cat="train", x_kind=kind,
                       x_worker=worker_id, x_fleet=len(self._leases))

    def register(self, worker_id: Optional[str] = None) -> Optional[str]:
        """A worker joins: seat it on the next free ranks (lowest pool
        index first).  Returns the worker id, or ``None`` when the join
        was suppressed (fleet already at ``max_workers``)."""
        with self._lock:
            if len(self._leases) >= self.max_workers:
                self.counters["suppressed"] += 1
                self.transitions.append(
                    ("suppressed", worker_id or "<join>", self._epoch))
                return None
            devs = tuple(self._free_devices()[:self.chips_per_worker])
            if worker_id is None:
                worker_id = f"w{self._next_id}"
            self._next_id += 1
            if worker_id in self._leases:
                raise ValueError(f"worker {worker_id!r} already registered")
            now = self.clock()
            self._leases[worker_id] = WorkerLease(
                worker_id=worker_id, devices=devs, joined_at=now,
                expires_at=self._expiry(now), order=self._next_order)
            self._next_order += 1
            self.counters["joins"] += 1
            self._record("join", worker_id)
            return worker_id

    def heartbeat(self, worker_id: str) -> None:
        """Renew a worker's lease (no membership change)."""
        with self._lock:
            lease = self._leases.get(worker_id)
            if lease is None:
                raise KeyError(f"no live lease for worker {worker_id!r}")
            lease.expires_at = self._expiry(self.clock())

    def _remove(self, worker_id: str, kind: str) -> bool:
        if worker_id not in self._leases:
            raise KeyError(f"no live lease for worker {worker_id!r}")
        if len(self._leases) <= self.min_workers:
            self.counters["suppressed"] += 1
            self.transitions.append(("suppressed", worker_id, self._epoch))
            return False
        del self._leases[worker_id]
        self.counters[{"leave": "leaves", "preempt": "preemptions",
                       "death": "deaths", "expire": "expirations"}[kind]] += 1
        self._record(kind, worker_id)
        return True

    def leave(self, worker_id: str) -> bool:
        """Planned departure (drained at the next chunk boundary)."""
        with self._lock:
            return self._remove(worker_id, "leave")

    def fail(self, worker_id: str) -> bool:
        """Unplanned death: the lease is revoked immediately."""
        with self._lock:
            return self._remove(worker_id, "death")

    def expire(self) -> List[str]:
        """Clock-driven reaping: every worker whose lease lapsed is
        declared dead.  Returns the expired worker ids."""
        with self._lock:
            now = self.clock()
            lapsed = [w for w, lease in self._leases.items()
                      if lease.expires_at < now]
            return [w for w in lapsed if self._remove(w, "expire")]

    def _newest(self) -> Optional[str]:
        if not self._leases:
            return None
        return max(self._leases.values(), key=lambda l: l.order).worker_id

    def preempt(self) -> Optional[str]:
        """The injected-``"preempt"`` transition: remove the newest live
        worker (LIFO, so a seeded schedule always removes the same
        seat)."""
        with self._lock:
            victim = self._newest()
            if victim is not None and self._remove(victim, "preempt"):
                return victim
            return None

    # -- fleet views -------------------------------------------------------

    @property
    def fleet_size(self) -> int:
        with self._lock:
            return len(self._leases)

    @property
    def membership_epoch(self) -> int:
        with self._lock:
            return self._epoch

    def live_workers(self) -> Tuple[str, ...]:
        """Live worker ids in join order."""
        with self._lock:
            return tuple(sorted(self._leases,
                                key=lambda w: self._leases[w].order))

    def fleet(self) -> FleetView:
        with self._lock:
            return FleetView(epoch=self._epoch, workers=self.live_workers())

    def fleet_ranks(self) -> Tuple[int, ...]:
        """The live workers' ranks, ascending: the mesh's order."""
        with self._lock:
            return tuple(sorted(d for w in self._leases.values()
                                for d in w.devices))

    def mesh(self):
        """The CURRENT fleet as a ``(dcn, data)`` mesh over the live
        workers' ranks (:func:`~.mesh.fleet_mesh`; every rank of the world
        must call it at the same point), marking that fleet consumed, so
        :meth:`poll` reports ``True`` only for membership the training
        mesh has not absorbed yet.  A rank outside the fleet gets the
        mesh without a group (:meth:`is_member` is False there)."""
        from .mesh import fleet_mesh

        with self._lock:
            ranks = self.fleet_ranks()
            shape = {self.dcn_axis: len(self._leases),
                     self.data_axis: self.chips_per_worker}
            self._built_epoch = self._epoch
            self._attempt_ranks = ranks
        return fleet_mesh(ranks, shape)

    def is_member(self) -> bool:
        """Whether this rank is a seat of the fleet the last :meth:`mesh`
        was built over."""
        return _world()[0] in self._attempt_ranks

    # -- the ranks outside the fleet ---------------------------------------

    def _idle_ranks(self) -> bool:
        """Whether the world holds ranks outside the attempt's fleet (they
        follow its boundaries and its end through :meth:`_signal`)."""
        return len(self._attempt_ranks) < _world()[1]

    def _signal(self, message):
        """The fleet's rank 0's ``message`` on every rank of the world (one
        broadcast over the world; every rank calls it alike)."""
        import torch.distributed as dist

        box = [message]
        dist.broadcast_object_list(box, src=min(self._attempt_ranks))
        return box[0]

    def idle(self):
        """Park a rank outside the fleet for one attempt: poll the
        membership seam at each of the fleet's chunk boundaries (so its
        table and its fault schedule move as the fleet's do) and return
        the attempt's outcome when the fleet's rank 0 ends it
        (:meth:`end_attempt`).  A fault the seam raises here is the
        fleet's to handle: its outcome follows."""
        while True:
            message = self._signal(None)
            if message == "poll":
                try:
                    self._poll_local()
                except Exception:  # noqa: BLE001 — the fleet reports it
                    pass
                continue
            return message[1]

    def end_attempt(self, outcome):
        """The fleet's end of an attempt: its rank 0's ``outcome`` reaches
        every rank of the world (the ranks in :meth:`idle` return it).
        Returns that outcome; without ranks outside the fleet, ``outcome``
        itself."""
        if not self._idle_ranks():
            return outcome
        return self._signal(("end", outcome))[1]

    # -- controller-initiated transitions ----------------------------------

    def request_resize(self, target_workers: int, *,
                       at_boundary: Optional[int] = None,
                       reason: str = "controller") -> int:
        """Ask the fleet to become ``target_workers`` at a chunk boundary
        (the autoscale controller's training actuator).  Not applied here:
        :meth:`poll` applies it, walking the fleet toward the target
        through the same :meth:`register` / :meth:`preempt` transitions
        the injected fault seam uses.  ``at_boundary`` pins it to a
        boundary index (the FaultPlan index space: poll invocations
        across the run), ``None`` meaning the next boundary.  The target
        is clamped to ``[min_workers, max_workers]``; a later request
        replaces a pending one.  Returns the clamped target."""
        target = max(self.min_workers,
                     min(int(target_workers), self.max_workers))
        with self._lock:
            self._pending_resize = (target, at_boundary, str(reason))
            self.counters["controller_requests"] += 1
        from ..obs.trace import tracer

        tracer.instant("resize_requested", cat="train",
                       x_target=target, x_reason=str(reason))
        return target

    def _apply_pending_resize(self) -> None:
        """Walk the fleet to a due pending target: called from
        :meth:`poll` only, AFTER the fault seam."""
        with self._lock:
            if self._pending_resize is None:
                return
            target, at_boundary, _reason = self._pending_resize
            if at_boundary is not None \
                    and self._boundary_polls <= at_boundary:
                return
            self._pending_resize = None
        while True:
            with self._lock:
                n = len(self._leases)
            if n < target:
                if self.register() is None:
                    return      # suppressed at the bound: stop walking
            elif n > target:
                if self.preempt() is None:
                    return
            else:
                return

    # -- the chunk-boundary seam ------------------------------------------

    def poll(self, step: Optional[int] = None) -> bool:
        """The fits' once-per-chunk-boundary membership check.

        Fires the ``elastic.membership`` fault seam (one invocation per
        boundary), translating an injected ``"join"`` into
        :meth:`register` and an injected ``"preempt"`` into
        :meth:`preempt`; any other injected kind (e.g. ``"crash"``)
        propagates like a crash at any other seam.  Then applies a due
        controller request, reaps lapsed leases and reports whether
        membership moved past the fleet the current mesh was built from:
        ``True`` means the caller must cut a boundary checkpoint and raise
        :class:`ResizeRequested`.  Where the world holds ranks outside the
        fleet, every rank of the fleet calls it alike (one broadcast tells
        the idle ranks to poll too)."""
        if self._attempt_ranks and self._idle_ranks():
            self._signal("poll")
        return self._poll_local()

    def _poll_local(self) -> bool:
        from ..robustness.faults import (
            InjectedJoin,
            InjectedPreemption,
            fault_point,
        )

        with self._lock:
            self._boundary_polls += 1
        try:
            fault_point(self.SCOPE)
        except InjectedPreemption:
            self.preempt()
        except InjectedJoin:
            self.register()
        self._apply_pending_resize()
        self.expire()
        with self._lock:
            return self._epoch != self._built_epoch

    @staticmethod
    def worker_loss(exc: Optional[BaseException]) -> bool:
        """Whether a failure is worker-loss-shaped (an injected crash or a
        lost-peer connection or timeout): the failures
        :meth:`on_failure` may evict a seat for."""
        from ..robustness.faults import InjectedCrash

        return exc is None or isinstance(
            exc, (InjectedCrash, ConnectionError, TimeoutError))

    def on_failure(self, exc: Optional[BaseException] = None, *,
                   worker_loss: Optional[bool] = None) -> Optional[str]:
        """The supervisor's crash hook: first reap lapsed leases (a real
        worker death surfaces as silence); if none had lapsed AND the
        failure is worker-loss-shaped (:meth:`worker_loss`, or
        ``worker_loss`` as the fleet's rank 0 classified it; a disk-full
        or corrupt-state error is not a dead worker), revoke the newest
        worker's lease, bounded by ``min_workers``.  Returns the removed
        worker id, or ``None`` when the fleet stayed put (plain crash
        recovery on the same mesh)."""
        expired = self.expire()
        if expired:
            return expired[0]
        if worker_loss is None:
            worker_loss = self.worker_loss(exc)
        if not worker_loss:
            return None
        with self._lock:
            victim = self._newest()
            if (victim is not None
                    and len(self._leases) > self.min_workers
                    and self._remove(victim, "death")):
                return victim
            return None

    def note_resize(self) -> None:
        """Supervisor hook: count a completed resize transition."""
        with self._lock:
            self.counters["resizes"] += 1

    # -- observability -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Fleet-state snapshot for a :class:`~..obs.tree.MetricsTree`
        (``default_tree(elastic=...)``)."""
        with self._lock:
            pending = self._pending_resize
            return {
                "fleet_size": len(self._leases),
                "membership_epoch": self._epoch,
                "workers": list(self.live_workers()),
                "chips_per_worker": self.chips_per_worker,
                "min_workers": self.min_workers,
                "max_workers": self.max_workers,
                "boundary_polls": self._boundary_polls,
                "pending_resize_target": (pending[0] if pending is not None
                                          else -1),
                **{k: int(v) for k, v in self.counters.items()},
            }

    def publish(self, group) -> None:
        """Export the fleet gauges into a ``MetricGroup`` subtree
        (``elastic.fleet_size`` etc.)."""
        sub = group.add_group("elastic")
        snap = self.snapshot()
        for key in ("fleet_size", "membership_epoch", "chips_per_worker",
                    "min_workers", "max_workers"):
            sub.gauge(key).set(snap[key])
        for key in ("joins", "leaves", "preemptions", "deaths",
                    "expirations", "suppressed", "resizes",
                    "controller_requests"):
            sub.gauge(key).set(snap[key])
