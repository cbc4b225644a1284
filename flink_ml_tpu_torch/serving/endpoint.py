"""The serving endpoint: queue -> micro-batcher -> executor.

One background serve thread per endpoint drives the loop:

1. ``next_batch`` coalesces concurrent requests under the max-wait
   deadline (``batcher.py``),
2. the live :class:`~.registry.DeployedModel` is captured ONCE for the
   batch (hot-swap atomicity: every request in a batch runs on one fully
   warmed version; later batches pick up a swapped version on their next
   capture),
3. request tables concatenate into one batch table, the executor pads it
   to the power-of-two bucket and runs the warmed predict,
4. each request's Future resolves to ITS slice of the output rows.

Backpressure is the batcher's bounded queue (shed-on-full with
:class:`~.batcher.ServingOverloadedError`); per-endpoint gauges/counters
(queue depth, batch fill ratio, p50/p99 latency, requests/sec, shed
count) live in a ``utils.metrics.MetricGroup`` via
:class:`~.metrics.ServingMetrics`.

A port of the JAX package's ``serving/endpoint.py`` (host code around
the executor's device work).
"""

from __future__ import annotations

import threading
import time

from concurrent.futures import Future
from typing import Any, List, Optional

from ..data.table import Table
from ..obs.trace import tracer
from ..robustness.faults import (InjectedChipDown, InjectedChipFlap,
                                 fault_point)
from .batcher import (MicroBatcher, ServingOverloadedError,
                      ServingRequest, concat_request_tables)
from .metrics import ServingMetrics
from .registry import ModelRegistry
from .scheduler import DISPATCH_SCOPE


__all__ = ["ServingEndpoint", "serve_model"]


class ServingEndpoint:
    """Serve one registry entry.  ``submit`` returns a Future resolving to
    the output Table for exactly the submitted rows; ``predict`` is the
    blocking convenience.  Construct, then ``start()`` once the model is
    deployed and warmed — ``start`` refuses to serve an unwarmed model,
    so readiness implies every serving shape has run once."""

    def __init__(self, registry: ModelRegistry, name: str = "default", *,
                 max_batch_rows: int = 256, max_wait_ms: float = 2.0,
                 queue_capacity: int = 1024,
                 metrics: Optional[ServingMetrics] = None):
        self._registry = registry
        self._name = name
        self._batcher = MicroBatcher(max_batch_rows=max_batch_rows,
                                     max_wait_ms=max_wait_ms,
                                     queue_capacity=queue_capacity)
        self.metrics = metrics or ServingMetrics()
        self._thread: Optional[threading.Thread] = None

    @property
    def registry(self) -> ModelRegistry:
        """The backing registry — hot-swap via
        ``endpoint.registry.deploy(name, new_version)``."""
        return self._registry

    def delta_publisher(self):
        """A :class:`~flink_ml_tpu_torch.online.publish.DeltaPublisher`
        bound to this endpoint's registry entry and metrics — the
        serving-side half of the continuous-learning publish protocol.
        Publishes account (delta/full counters, staleness gauge) on THIS
        endpoint."""
        from ..online.publish import DeltaPublisher

        return DeltaPublisher(self._registry, self._name,
                              metrics=self.metrics)

    def hot_swap(self, model, **deploy_kwargs):
        """Self-healing hot-swap: deploy ``model`` as the next generation
        with ``rollback=True`` — a failed load/warm-up (corrupt
        directory, injected fault) keeps the live generation serving,
        flips THIS endpoint's health gauge to DEGRADED and bumps its
        rollback counter, and returns the incumbent.  In-flight and
        concurrent requests are untouched either way (the publish point
        is one reference assignment that never happens on failure)."""
        return self._registry.deploy(self._name, model, rollback=True,
                                     metrics=self.metrics, **deploy_kwargs)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ServingEndpoint":
        deployed = self._registry.current(self._name)   # raises if absent
        if not deployed.servable.ready:
            raise RuntimeError(
                f"model {self._name!r} (gen {deployed.generation}) is not "
                "warmed up; deploy() warms automatically — a custom "
                "servable must warm_up() before the endpoint starts")
        if self._thread is not None:
            raise RuntimeError("endpoint already started")
        self._thread = threading.Thread(
            target=self._serve_loop, daemon=True,
            name=f"flink-ml-tpu-torch-serve-{self._name}")
        self._thread.start()
        return self

    @property
    def ready(self) -> bool:
        if self._thread is None or not self._thread.is_alive():
            return False
        try:
            return self._registry.current(self._name).servable.ready
        except KeyError:
            return False

    @property
    def warmup_report(self) -> Optional[dict]:
        """The live servable's readiness accounting: wall time to ready
        and each bucket's warm-up ms — None before the first deploy (or
        for custom servables that skip the standard warm-up)."""
        try:
            servable = self._registry.current(self._name).servable
        except KeyError:
            return None
        return getattr(servable, "warmup_report", None)

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting, drain queued requests, join the serve loop."""
        self._batcher.close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- request path -------------------------------------------------------
    def submit(self, table: Table) -> Future:
        """Enqueue one request; sheds with ``ServingOverloadedError`` when
        the bounded queue is full.  A shed is stamped with the LIVE
        generation serving at the time (gauge + tracer instant), so an
        overload correlated with a publish — e.g. a warm-up stealing
        cycles from the serve loop — is attributable in the trace
        instead of an anonymous counter bump."""
        try:
            request = self._batcher.submit(table)
        except ServingOverloadedError:
            # lock-free generation read: the shed path must not
            # serialize on the registry lock under the very saturation
            # it exists to absorb
            generation = self._registry.live_generation(self._name)
            self.metrics.on_shed(self._batcher.queue_depth,
                                 generation=generation)
            tracer.instant("shed", cat="serving", generation=generation)
            raise
        self.metrics.on_submit(self._batcher.queue_depth)
        return request.future

    def predict(self, table: Table, timeout: Optional[float] = 30.0
                ) -> Table:
        return self.submit(table).result(timeout)

    # -- serve loop ---------------------------------------------------------
    def _serve_loop(self) -> None:
        while True:
            batch = self._batcher.next_batch(timeout=0.05)
            if batch:
                self._process(batch)
            elif self._batcher.closed and self._batcher.empty:
                return

    def _process(self, batch: List[ServingRequest]) -> None:
        # the chip-fault seam: same dispatch-boundary
        # contract as the shared scheduler — an injected chip fault
        # fires BEFORE the predict, the batch goes back to the queue
        # head with futures intact, the retried dispatch answers them
        # bit-identically.  The single-endpoint topology has no
        # failover driver; losslessness alone is the contract here.
        try:
            fault_point(DISPATCH_SCOPE)
        except (InjectedChipDown, InjectedChipFlap):
            self._batcher.requeue(batch)
            self.metrics.on_requeue(len(batch))
            return
        # ONE capture per batch: the hot-swap atomicity point.  Every
        # request below runs on this (immutable, fully warmed) version
        # even if a deploy publishes mid-predict.
        deployed = self._registry.current(self._name)
        servable = deployed.servable
        rows = sum(r.rows for r in batch)
        if tracer.enabled:
            # queue-wait is recorded RETROACTIVELY from the request's
            # submit stamp — the submit path itself never touches the
            # tracer (no lock, no clock read, under load)
            formed = time.perf_counter()
            for request in batch:
                tracer.add("queue_wait", request.submitted_at, formed,
                           cat="serving", request_id=request.request_id,
                           generation=deployed.generation)
        try:
            with tracer.span("batch_assembly", cat="serving",
                             generation=deployed.generation):
                for request in batch:
                    servable.check_schema(request.table)
                table = concat_request_tables([r.table for r in batch])
            with tracer.span("serve_batch", cat="serving",
                             generation=deployed.generation,
                             bucket=servable.bucket_for(rows)):
                # nested inside: bucket_pad -> device_execute (the
                # kernel-servable path instruments those in api/chain.py)
                out = servable.predict(table)
        except BaseException as exc:  # noqa: BLE001 — delivered per-request
            for request in batch:
                request.future.set_exception(exc)
            return
        offset = 0
        now = time.perf_counter()
        latencies = []
        for request in batch:
            if tracer.enabled:
                # committed BEFORE the future resolves, so a caller woken
                # by predict() can already see its own request span
                tracer.add("request", request.submitted_at, now,
                           cat="serving", request_id=request.request_id,
                           generation=deployed.generation)
            request.future.set_result(
                out.slice(offset, offset + request.rows))
            offset += request.rows
            latencies.append(now - request.submitted_at)
        self.metrics.on_batch(
            n_requests=len(batch), rows=rows,
            bucket=servable.bucket_for(rows), latencies_s=latencies,
            queue_depth=self._batcher.queue_depth,
            generation=deployed.generation)


def serve_model(model: Any, example: Table, *, name: str = "default",
                max_batch_rows: int = 256, max_wait_ms: float = 2.0,
                queue_capacity: int = 1024,
                **servable_kwargs: Any) -> ServingEndpoint:
    """One-call serving for a single fitted model: build a registry,
    deploy + warm the model, start the endpoint.  Hot-swap later versions
    with ``endpoint.registry.deploy(name, new_model)``."""
    metrics = ServingMetrics()
    registry = ModelRegistry(metrics=metrics)
    registry.deploy(name, model, example,
                    max_batch_rows=max_batch_rows, **servable_kwargs)
    endpoint = ServingEndpoint(registry, name,
                               max_batch_rows=max_batch_rows,
                               max_wait_ms=max_wait_ms,
                               queue_capacity=queue_capacity,
                               metrics=metrics)
    return endpoint.start()
