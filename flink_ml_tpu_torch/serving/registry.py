"""Model registry with atomic hot-swap.

A port of the JAX package's ``serving/registry.py``.  Versions load from
the framework's persistence layout (``utils/persist.py`` —
``{path}/metadata`` + ``{path}/data``, the JAX package's layout, so a
stage that package saved deploys here; load failures surface as
diagnosable ``IOError``\\s naming the path and the stored class name),
adapt through :func:`~.executor.make_servable`, and warm up OFF the
serving path: the deploying thread runs every bucket while the previous
version keeps answering traffic.  Only then does the
new version publish, as ONE reference assignment under the registry lock
tagged with a monotonically increasing **generation**.

Atomicity contract: a reader (the endpoint's serve loop) takes
``current(name)`` exactly once per micro-batch, so every request in a
batch runs on one fully-warmed version; in-flight batches keep their
(old) servable alive by plain reference and finish on it.  No request can
ever observe a half-loaded model, because nothing is published before
``warm_up`` returns.

Self-healing: ``deploy(..., rollback=True)`` turns a
failed load/warm-up — corrupt model directory, injected fault, any
exception before the publish point — into a ROLLBACK: the incumbent
generation stays live (it was never unpublished, so zero requests are
dropped), the health gauge flips SERVING -> DEGRADED and the rollback
counter increments (``serving/metrics.py``), and the incumbent is
returned so callers observe which generation is actually serving.  A
``retry_policy`` additionally retries classified-transient *load*
failures before declaring the deploy failed.
"""

from __future__ import annotations

import logging
import threading
import time

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..data.table import Table
from ..obs.trace import tracer
from ..robustness.faults import fault_point
from ..utils import persist
from .executor import ServableModel, make_servable

__all__ = ["DeployedModel", "GenerationConflict", "ModelRegistry"]


class GenerationConflict(RuntimeError):
    """A conditional publish lost the race to a concurrent deploy: the
    live generation is not the one the caller validated against."""

log = logging.getLogger("flink_ml_tpu_torch.robustness")


@dataclass(frozen=True)
class DeployedModel:
    """One published version: immutable, so a reference captured at batch
    formation stays internally consistent for the batch's lifetime."""
    name: str
    servable: ServableModel
    generation: int
    source: str
    deployed_at: float


class ModelRegistry:
    """name -> live :class:`DeployedModel`, swapped atomically.
    ``device`` is where a model loaded from a saved-stage path runs
    (default the card); a model object passed in keeps its own."""

    def __init__(self, servable_factory: Optional[Callable] = None,
                 metrics: Optional[Any] = None,
                 retry_policy: Optional[Any] = None, *,
                 device: Any = "cuda"):
        self._factory = servable_factory or make_servable
        self._live: Dict[str, DeployedModel] = {}
        self._lock = threading.Lock()
        #: a serving.metrics.ServingMetrics — health/rollback accounting
        self.metrics = metrics
        #: a robustness.retry.RetryPolicy for transient LOAD failures
        self._retry = retry_policy
        self.device = device

    def _load(self, path: str):
        fault_point("serving.load")
        return persist.load_stage(path, device=self.device)

    def deploy(self, name: str, model: Any,
               example: Optional[Table] = None,
               rollback: bool = False,
               metrics: Optional[Any] = None,
               **servable_kwargs: Any) -> DeployedModel:
        """Load (if ``model`` is a saved-stage path), adapt, warm up, then
        atomically publish as the next generation of ``name``.  On a
        re-deploy, ``example`` (and servable config) may be omitted to
        inherit the incumbent's.

        ``rollback=True``: a failure anywhere before the publish point
        (unloadable/corrupt directory, warm-up crash) keeps the incumbent
        generation live and RETURNS it instead of raising — health flips
        to DEGRADED and the rollback counter increments when a
        ``ServingMetrics`` is attached.  With no incumbent there is
        nothing to roll back to, so the failure raises either way.

        ``metrics`` overrides the registry-level ``ServingMetrics`` for
        THIS deploy — with several endpoints sharing one registry, each
        hot-swap accounts health/rollback on the endpoint that asked for
        it, not on whichever endpoint touched the registry first."""
        metrics = metrics if metrics is not None else self.metrics
        try:
            if isinstance(model, str):
                source = model
                model = (self._retry.call(self._load, model)
                         if self._retry is not None else self._load(model))
            else:
                source = f"<memory:{type(model).__name__}>"
            incumbent = self._live.get(name)
            if example is None:
                if incumbent is None:
                    raise ValueError(
                        f"first deploy of {name!r} needs an example Table "
                        "(the request schema warm-up tiles over)")
                example = incumbent.servable.example
                if not servable_kwargs:
                    servable_kwargs = {
                        "max_batch_rows": incumbent.servable.max_batch_rows,
                        "min_bucket": incumbent.servable.min_bucket,
                        "output_cols": incumbent.servable.output_cols,
                    }
            servable = self._factory(model, example, **servable_kwargs)
            servable.warm_up()   # off the serving path: old version live
            rep = getattr(servable, "warmup_report", None)
            if rep:
                # the cold-start one-liner: how long readiness took
                log.info("warm-up of %r: %d buckets in %.3fs", name,
                         len(rep["buckets"]), rep["wall_s"])
        except Exception as exc:  # noqa: BLE001 — rollback decision below
            with self._lock:
                incumbent = self._live.get(name)
            if not rollback or incumbent is None:
                raise
            # ROLLBACK: nothing was ever published, so the incumbent kept
            # serving throughout — zero dropped requests by construction.
            log.warning(
                "hot-swap of %r failed (%r); rolled back to generation "
                "%d (%s)", name, exc, incumbent.generation,
                incumbent.source)
            if metrics is not None:
                metrics.on_rollback()
            return incumbent
        with self._lock:
            previous = self._live.get(name)
            generation = (previous.generation + 1) if previous else 1
            deployed = DeployedModel(name=name, servable=servable,
                                     generation=generation, source=source,
                                     deployed_at=time.time())
            self._live[name] = deployed   # THE swap: one dict assignment
        tracer.instant("deploy", cat="publish", generation=generation)
        if metrics is not None:
            metrics.on_deploy(generation)
        return deployed

    def publish_servable(self, name: str, servable: ServableModel, *,
                         source: str = "<publish>",
                         metrics: Optional[Any] = None,
                         mode: str = "delta",
                         payload_bytes: Optional[int] = None,
                         expected_generation: Optional[int] = None
                         ) -> DeployedModel:
        """Swap an already-READY servable in as the next generation of
        ``name`` — the continuous-learning publish fast path.  Unlike
        :meth:`deploy` there is no load and no warm-up here: the caller
        rebound a live servable around same-shape params
        (:meth:`~.executor.ServableModel.rebind`), so every shape it can
        reach has already run.  The swap itself is the
        same single reference assignment under the registry lock, so the
        atomicity contract (in-flight batches finish on their captured
        version; no request ever sees a half-published model) is
        identical to a full deploy.

        ``mode``/``payload_bytes`` flow to
        ``ServingMetrics.on_publish`` for the delta-vs-full counters and
        the staleness gauge.

        ``expected_generation`` makes the swap CONDITIONAL: if the live
        generation moved past it (a concurrent external deploy landed
        between the caller's read and this swap), the publish is
        refused with :class:`GenerationConflict` instead of silently
        clobbering the newer model — the compare-and-swap the publish
        protocol's validation-then-swap sequence needs."""
        if not servable.ready:
            raise RuntimeError(
                f"publish_servable({name!r}): servable is not ready — "
                "rebind() preserves readiness; anything else must "
                "warm_up() first (or go through deploy())")
        # chaos seam: the chunk-boundary publish is a crash site the
        # exactly-once tests exercise (crash BEFORE the swap => the old
        # generation keeps serving; the replayed cut republishes)
        fault_point("serving.publish")
        metrics = metrics if metrics is not None else self.metrics
        with self._lock:
            previous = self._live.get(name)
            if (expected_generation is not None and previous is not None
                    and previous.generation != expected_generation):
                raise GenerationConflict(
                    f"publish of {name!r} expected generation "
                    f"{expected_generation} but {previous.generation} is "
                    "live (a concurrent deploy landed); re-validate "
                    "against the new generation and retry")
            generation = (previous.generation + 1) if previous else 1
            deployed = DeployedModel(name=name, servable=servable,
                                     generation=generation, source=source,
                                     deployed_at=time.time())
            self._live[name] = deployed   # THE swap: one dict assignment
        tracer.instant("publish_swap", cat="publish",
                       generation=generation)
        if metrics is not None:
            if hasattr(metrics, "on_publish"):
                metrics.on_publish(generation, mode=mode,
                                   payload_bytes=payload_bytes)
            else:
                metrics.on_deploy(generation)
        return deployed

    def live_generation(self, name: str) -> Optional[int]:
        """LOCK-FREE best-effort read of the live generation (None when
        nothing is deployed).  The shed paths stamp their events with
        this — under saturation thousands of sheds per second must not
        serialize on the registry lock the serve loops and deploys
        contend on.  Safe: the dict read is GIL-atomic and the held
        ``DeployedModel`` is immutable."""
        deployed = self._live.get(name)
        return deployed.generation if deployed is not None else None

    def current(self, name: str) -> DeployedModel:
        """The live version — one atomic read; callers serving a batch
        call this ONCE and use the returned reference throughout."""
        with self._lock:
            deployed = self._live.get(name)
        if deployed is None:
            raise KeyError(
                f"no model deployed under {name!r}; call deploy() first "
                f"(deployed: {self.names()})")
        return deployed

    def generation(self, name: str) -> int:
        return self.current(name).generation

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._live)

    def undeploy(self, name: str) -> None:
        with self._lock:
            self._live.pop(name, None)
