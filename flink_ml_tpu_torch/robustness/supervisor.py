"""Self-healing training supervision.

:func:`resilient_fit` supervises any checkpointing fit — the streaming
``sgd_fit_outofcore`` and the hosted ``iterate`` both speak the same
``(checkpoint=..., resume=...)`` keywords — and turns a recoverable crash
into an automatic restore-and-continue instead of a dead process:

1. run the fit; on a recoverable failure (injected crash, I/O error),
2. back off (classified, deterministic schedule — :class:`~.retry
   .RetryPolicy` arithmetic), then
3. re-run with ``resume=True``: the fit restores from the newest VALID
   checkpoint (``CheckpointManager.latest()`` quarantines corrupt or
   partial cuts and falls back — :mod:`.durability`), re-seeks or
   replays its source past the cursor, and continues as if never
   interrupted.

Because restore and replay are deterministic, the supervised run's final
state is **bit for bit** the uninterrupted run's, also when the newest
checkpoint is corrupt and the fallback path restores an older one.

The per-restart :class:`RecoveryEvent` records the time to recover
(detect -> restore complete, which is where training resumes) against
the manager's restore timestamp.

With ``elastic=`` (an :class:`~flink_ml_tpu_torch.parallel.elastic.\
ElasticCoordinator`) the fleet is a runtime input: planned resizes at
chunk boundaries and recovery onto the surviving workers share this one
loop.

A port of the JAX package's ``robustness/supervisor.py``.
"""

from __future__ import annotations

import time

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from ..obs.trace import tracer
from .faults import InjectedCrash
from .retry import RetryPolicy

__all__ = ["RecoveryEvent", "RecoveryReport", "resilient_fit",
           "default_recoverable"]


def default_recoverable(exc: BaseException) -> bool:
    """Can a restore-and-replay heal this?  Crashes and I/O failures
    yes; logic errors (bad config, schema mismatch, corrupt *input*
    data raising ValueError) no — re-running those burns restarts on a
    deterministic failure."""
    return isinstance(exc, (InjectedCrash, OSError, IOError,
                            ConnectionError, TimeoutError))


@dataclass
class RecoveryEvent:
    """One detected failure and the recovery that followed.  ``kind`` is
    ``"crash"``, or ``"resize"`` for a planned resize of an elastic fleet
    (its ``mttr_s`` is the resize pause: detect -> restore on the new
    fleet); ``fleet_size`` is the fleet recovery resumed on (None without
    an elastic fleet)."""
    error: str
    detected_at: float
    backoff_s: float = 0.0
    restored_step: Optional[int] = None
    mttr_s: Optional[float] = None   # detect -> restore complete
    kind: str = "crash"
    fleet_size: Optional[int] = None


@dataclass
class RecoveryReport:
    """Filled in place by :func:`resilient_fit` (pass ``report=``):
    ``restarts`` counts recoveries, ``resizes`` the elastic fleet's planned
    resizes."""
    restarts: int = 0
    resizes: int = 0
    recovered: bool = False
    events: List[RecoveryEvent] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "restarts": self.restarts,
            "resizes": self.resizes,
            "recovered": self.recovered,
            "events": [{
                "error": e.error,
                "kind": e.kind,
                "fleet_size": e.fleet_size,
                "backoff_s": round(e.backoff_s, 4),
                "restored_step": e.restored_step,
                "mttr_s": (round(e.mttr_s, 4)
                           if e.mttr_s is not None else None),
            } for e in self.events],
        }


def resilient_fit(fit: Callable, *args: Any,
                  checkpoint: Any,
                  max_restarts: int = 3,
                  backoff: Optional[RetryPolicy] = None,
                  recoverable: Callable[[BaseException], bool]
                  = default_recoverable,
                  report: Optional[RecoveryReport] = None,
                  clock: Callable[[], float] = time.perf_counter,
                  elastic: Any = None,
                  max_resizes: int = 64,
                  **kwargs: Any) -> Any:
    """Run ``fit(*args, checkpoint=manager, resume=..., **kwargs)`` under
    supervision; returns whatever ``fit`` returns.

    ``fit`` is any callable taking ``checkpoint``/``resume`` keywords —
    ``sgd_fit_outofcore``, ``iterate``, ``fit_outofcore``, or a closure
    that rebuilds per-attempt state before delegating.  The first attempt
    runs with ``resume=kwargs.get("resume", False)``; every restart
    forces ``resume=True`` so recovery restores from the newest valid cut
    and replays forward.

    ``checkpoint`` (a ``CheckpointConfig`` or ``CheckpointManager``) is
    normalized to ONE manager shared across attempts, so quarantine
    decisions and save-slot history persist through restarts.  Restarts
    back off on the policy's deterministic schedule (attempt i sleeps
    ``backoff.delay(i)``); a failure that ``recoverable`` rejects — or
    restart ``max_restarts + 1`` — re-raises immediately.

    **Elastic fleets** (``elastic=``, an
    :class:`~flink_ml_tpu_torch.parallel.elastic.ElasticCoordinator`):
    run the same call on every rank of the world.  The fit must accept
    ``membership=``/``mesh=`` (``sgd_fit_outofcore`` does): both are
    injected per attempt, the mesh rebuilt from the coordinator's current
    fleet.  A rank outside the fleet sits the attempt out
    (:meth:`~.ElasticCoordinator.idle`) and learns its outcome from the
    fleet's rank 0 (:meth:`~.ElasticCoordinator.end_attempt`), so every
    rank takes the same branch below:

    - *planned elasticity*: the fit raises ``ResizeRequested`` at a chunk
      boundary after cutting a checkpoint; a ``kind="resize"`` event is
      recorded (no backoff, no restart budget consumed) and the fit re-runs
      with ``resume=True`` on the new mesh, which restores and re-shards
      the carry there.  ``max_resizes`` bounds a churn loop.
    - *crash elasticity*: a recoverable failure also asks the coordinator
      for the post-crash fleet (:meth:`~.ElasticCoordinator.on_failure`),
      so recovery resumes onto the surviving fleet through the same
      restore-and-reshard path.

    A rank outside the fleet returns the fleet's result, and raises a
    ``RuntimeError`` naming the fleet's error where the fleet raises."""
    # local import: checkpoint.py imports robustness.durability, so a
    # top-level import here would cycle through the package __init__
    from ..iteration.checkpoint import CheckpointConfig, CheckpointManager
    from ..parallel.elastic import ResizeRequested

    manager = (CheckpointManager(checkpoint)
               if isinstance(checkpoint, CheckpointConfig) else checkpoint)
    if not isinstance(manager, CheckpointManager):
        raise TypeError(
            "resilient_fit needs a CheckpointConfig/CheckpointManager "
            f"(got {type(checkpoint).__name__}): without durable cuts "
            "there is nothing to recover from")
    # the time to recover subtracts the manager's restore stamp from this
    # supervisor's detect stamp: both must come from the SAME clock
    manager.clock = clock
    backoff = backoff or RetryPolicy(max_attempts=max_restarts + 1)
    rep = report if report is not None else RecoveryReport()
    resume = bool(kwargs.pop("resume", False))
    restarts = 0
    resizes = 0
    while True:
        if elastic is not None:
            kwargs["membership"] = elastic
            kwargs["mesh"] = elastic.mesh()
        event: Optional[RecoveryEvent] = None
        if rep.events and rep.events[-1].mttr_s is None:
            event = rep.events[-1]
        exc: Optional[BaseException] = None
        if elastic is not None and not elastic.is_member():
            outcome = elastic.idle()
        else:
            try:
                outcome = ("done", fit(*args, checkpoint=manager,
                                       resume=resume, **kwargs))
            except ResizeRequested as err:
                exc = err
                outcome = ("resize", repr(err)[:200], err.step)
            except Exception as err:  # noqa: BLE001 — classified below
                exc = err
                worker_loss = (elastic.worker_loss(err)
                               if elastic is not None else False)
                outcome = ("crash", repr(err)[:200], recoverable(err),
                           worker_loss)
            if elastic is not None:
                outcome = elastic.end_attempt(outcome)
        _close_event(event, manager, clock)
        kind = outcome[0]
        if kind == "done":
            rep.recovered = restarts > 0
            return outcome[1]
        if kind == "resize":
            if elastic is None:
                # a fit ran with membership= but nobody owns the resize
                raise exc
            if resizes >= max_resizes:
                raise RuntimeError(
                    f"fleet resized {resizes} times without the fit "
                    "completing (max_resizes) — membership is churning "
                    "faster than training progresses") from exc
            resizes += 1
            rep.resizes = resizes
            elastic.note_resize()
            rep.events.append(RecoveryEvent(
                error=outcome[1], detected_at=clock(), kind="resize",
                fleet_size=elastic.fleet_size))
            tracer.instant("fleet_resize", cat="train",
                           x_fleet=elastic.fleet_size, x_step=outcome[2])
            resume = True
            continue
        _, error, can_recover, worker_loss = outcome
        if restarts >= max_restarts or not can_recover:
            if exc is None:
                raise RuntimeError(f"the fleet's fit failed: {error}")
            raise exc
        restarts += 1
        rep.restarts = restarts
        pause = backoff.delay(restarts - 1)
        fleet_size = None
        if elastic is not None:
            # worker death: recovery resumes onto the surviving fleet
            elastic.on_failure(exc, worker_loss=worker_loss)
            fleet_size = elastic.fleet_size
        rep.events.append(RecoveryEvent(
            error=error, detected_at=clock(), backoff_s=pause,
            fleet_size=fleet_size))
        tracer.instant("recovery_restart", cat="train", x_error=error[:80])
        backoff.sleep(pause)
        resume = True


def _close_event(event: Optional[RecoveryEvent], manager: Any,
                 clock: Callable[[], float]) -> None:
    """Stamp the open recovery event with the restore the just-finished
    attempt performed (``manager.last_restore_at`` is set by
    ``latest()``; training resumes the moment it returns)."""
    if event is None:
        return
    restore_at = getattr(manager, "last_restore_at", None)
    if restore_at is not None and restore_at >= event.detected_at:
        event.mttr_s = restore_at - event.detected_at
        event.restored_step = getattr(manager, "last_restored_step", None)
        if event.kind == "resize":
            # the resize-pause span: detect -> restore complete, where
            # training resumes on the new fleet
            tracer.add("resize_pause", event.detected_at, restore_at,
                       cat="train", x_fleet=event.fleet_size,
                       step=event.restored_step)
    else:
        # no checkpoint existed yet: recovery was a cold re-run
        event.mttr_s = clock() - event.detected_at
