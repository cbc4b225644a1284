"""Serving observability: per-endpoint latency quantiles + throughput.

A port of the JAX package's ``serving/metrics.py`` (host code).  An
endpoint's gauges live in a :class:`~flink_ml_tpu_torch.utils.metrics.\
MetricGroup`, so they flatten into the same ``snapshot()`` namespace as
training metrics.  The latency quantiles come from a bounded ring buffer:
O(window) memory for a process-lifetime endpoint, quantiles over the
most recent ``window`` requests.  The ``kernels.*`` subtree re-exports
the kernel registry's counters (``KernelStats.publish``: the JAX
package's gauges plus each kernel's launches).
"""

from __future__ import annotations

import threading
import time

from typing import Dict, List, Optional

import numpy as np

from ..utils.metrics import MetricGroup

__all__ = ["LatencyTracker", "ServingMetrics", "HEALTH_SERVING",
           "HEALTH_DEGRADED"]

#: Endpoint health states (the ``health`` gauge).  SERVING = the live
#: generation is the intended one; DEGRADED = the newest deploy failed
#: and traffic is riding the rolled-back previous generation — correct
#: answers, stale model, page the operator.
HEALTH_SERVING = "SERVING"
HEALTH_DEGRADED = "DEGRADED"


class LatencyTracker:
    """Ring buffer of the most recent ``window`` request latencies
    (seconds); thread-safe, constant memory."""

    def __init__(self, window: int = 4096):
        if window <= 0:
            raise ValueError("window must be positive")
        self._buf = np.zeros((window,), np.float64)
        self._idx = 0
        self._count = 0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._idx] = seconds
            self._idx = (self._idx + 1) % self._buf.shape[0]
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def quantile(self, q: float) -> float:
        """Latency quantile in SECONDS over the retained window (0.0 when
        nothing recorded yet)."""
        return self.quantiles((q,))[0]

    def quantiles(self, qs) -> List[float]:
        """Several quantiles under ONE lock acquisition / ring copy (the
        p50+p99 publish pair)."""
        with self._lock:
            n = min(self._count, self._buf.shape[0])
            if n == 0:
                return [0.0 for _ in qs]
            vals = np.quantile(self._buf[:n], list(qs))
        return [float(v) for v in vals]


class ServingMetrics:
    """The per-endpoint metric bundle: queue depth, batch fill ratio,
    p50/p99 latency, requests/sec, shed count — all living in one
    ``MetricGroup`` subtree so ``group.snapshot()`` exports them next to
    every other framework metric."""

    def __init__(self, group: Optional[MetricGroup] = None,
                 latency_window: int = 4096,
                 min_publish_interval_s: float = 0.0):
        #: minimum spacing between the EXPENSIVE publish work (the
        #: O(window) quantile pass + the kernel-gauge republish).  The
        #: default 0.0 keeps the classic refresh-per-batch behavior;
        #: the multi-tenant scheduler sets a small interval on its
        #: per-tenant bundles — ONE serve loop drives every tenant's
        #: metrics, so per-batch O(window) work there multiplies by the
        #: tenant count and comes straight out of serving latency.
        #: Counters/gauges on the request path are always live; only
        #: the derived quantile/kernel gauges are spaced, and
        #: ``snapshot()`` forces a refresh so exports never read stale.
        self._min_publish_interval = min_publish_interval_s
        self._last_expensive_publish = 0.0
        self.group = group or MetricGroup("serving")
        self.requests = self.group.counter("requests")
        self.batches = self.group.counter("batches")
        self.shed = self.group.counter("shed")
        #: requests returned to the queue head after a chip fault at
        #: the dispatch boundary — futures intact, answered
        #: by the retried dispatch; a nonzero count with zero drops is
        #: the failover losslessness receipt
        self.requeued = self.group.counter("requeued")
        #: failed hot-swaps healed by rolling back to the live generation
        self.rollbacks = self.group.counter("rollbacks")
        #: continuous-learning publish accounting: how the live
        #: generation last changed — device-resident delta swaps vs full
        #: load->warm->swap deploys — plus model freshness
        self.publishes_delta = self.group.counter("publishes_delta")
        self.publishes_full = self.group.counter("publishes_full")
        self._staleness = self.group.gauge("model_staleness_seconds")
        #: never-published = NaN (absent in exports), never a fake age
        self._staleness.set(float("nan"))
        self._publish_rate = self.group.gauge("publishes_per_sec")
        self._publish_bytes = self.group.gauge("last_publish_bytes")
        self._last_publish_at: Optional[float] = None
        self._publish_rate_value = 0.0
        self._health = self.group.gauge("health")
        self._health.set(HEALTH_SERVING)
        #: generation live at the most recent shed (NaN = never shed —
        #: absent in exports, the staleness-gauge stance)
        self._shed_generation = self.group.gauge("last_shed_generation")
        self._shed_generation.set(float("nan"))
        self._queue_depth = self.group.gauge("queue_depth")
        self._fill = self.group.gauge("batch_fill_ratio")
        self._p50 = self.group.gauge("latency_p50_ms")
        self._p99 = self.group.gauge("latency_p99_ms")
        #: retrieval quality: sampled-query recall@k against
        #: an exact scan (``retrieval/metrics.py::RecallProbe``); NaN =
        #: no probe has published — absent in exports, never a fake 1.0
        self._recall_probe = self.group.gauge("recall_probe")
        self._recall_probe.set(float("nan"))
        self._rate = self.group.gauge("requests_per_sec")
        self._generation = self.group.gauge("model_generation")
        self.latency = LatencyTracker(latency_window)
        self._rate_lock = threading.Lock()
        self._rate_t: Optional[float] = None
        self._rate_value = 0.0
        self._published_count = 0    # nothing recorded -> nothing to publish
        #: the process-wide dispatch and launch counters, re-exported into
        #: this endpoint's subtree (``kernels.dispatches``,
        #: ``kernels.launches.<kernel>``)
        self._kernel_group = self.group.add_group("kernels")
        self._kernel_published: Optional[dict] = None

    def on_requeue(self, n: int = 1) -> None:
        """``n`` of this tenant's in-flight requests went back to the
        queue head after a chip fault (see ``requeued`` counter doc)."""
        self.requeued.inc(n)

    def on_shed(self, queue_depth: int,
                generation: Optional[int] = None) -> None:
        """One shed (admission control dropped a request).  ``generation``
        stamps the live model generation serving at the time — the
        publish-correlation hook (never-shed endpoints read NaN, the
        absent-in-exports sentinel, like staleness)."""
        self.shed.inc()
        self._queue_depth.set(queue_depth)
        if generation is not None:
            self._shed_generation.set(generation)

    @property
    def health(self) -> str:
        return self._health.value

    def on_rollback(self) -> None:
        """A hot-swap failed load/warm-up and the registry rolled back:
        the endpoint keeps serving the previous generation (no dropped
        requests) but the intended model never went live — DEGRADED
        until a deploy succeeds."""
        self.rollbacks.inc()
        self._health.set(HEALTH_DEGRADED)

    def on_deploy(self, generation: int) -> None:
        """A deploy published: record the live generation and (re)assert
        SERVING — a successful swap heals a DEGRADED endpoint."""
        self._generation.set(generation)
        self._health.set(HEALTH_SERVING)

    def on_publish(self, generation: int, *, mode: str = "full",
                   payload_bytes: Optional[int] = None,
                   now: Optional[float] = None) -> None:
        """A continuous-learning publish landed (``mode`` "delta" for a
        device-resident buffer swap, anything else counts as full).
        Resets the staleness gauge and feeds the publishes/sec EWMA (the
        on_batch requests/sec stance)."""
        self.on_deploy(generation)
        (self.publishes_delta if mode == "delta"
         else self.publishes_full).inc()
        if payload_bytes is not None:
            self._publish_bytes.set(int(payload_bytes))
        now = time.time() if now is None else now
        with self._rate_lock:
            if self._last_publish_at is not None:
                inst = 1.0 / max(now - self._last_publish_at, 1e-9)
                self._publish_rate_value = (
                    0.8 * self._publish_rate_value + 0.2 * inst
                    if self._publish_rate_value else inst)
                self._publish_rate.set(round(self._publish_rate_value, 3))
            self._last_publish_at = now
        self._staleness.set(0.0)

    def touch_staleness(self, now: Optional[float] = None) -> None:
        """Refresh the model-staleness gauge (seconds since the last
        publish).  Called from the serve loop per batch — one
        ``time.time()`` — so the gauge stays live between publishes; a
        never-published endpoint reads NaN (unknown, not fresh: snapshot
        consumers and the Prometheus writer emit ABSENT instead of a fake
        negative age)."""
        if self._last_publish_at is None:
            self._staleness.set(float("nan"))
            return
        now = time.time() if now is None else now
        self._staleness.set(round(now - self._last_publish_at, 3))

    @property
    def staleness_seconds(self) -> float:
        return self._staleness.value

    def on_recall_probe(self, value: float) -> None:
        """A retrieval recall probe published its running mean (see
        ``retrieval/metrics.py::RecallProbe.publish``)."""
        self._recall_probe.set(float(value))

    @property
    def recall_probe(self) -> float:
        return self._recall_probe.value

    def on_submit(self, queue_depth: int) -> None:
        self._queue_depth.set(queue_depth)

    def on_batch(self, *, n_requests: int, rows: int, bucket: int,
                 latencies_s: List[float], queue_depth: int,
                 generation: Optional[int] = None) -> None:
        """Record one served micro-batch.  ``bucket`` is the padded batch
        size the executor ran — ``rows / bucket`` is the fill
        ratio (1.0 = the padding overhead was zero)."""
        now = time.perf_counter()
        self.batches.inc()
        self.requests.inc(n_requests)
        for lat in latencies_s:
            self.latency.record(lat)
        self._queue_depth.set(queue_depth)
        self._fill.set(round(rows / max(bucket, 1), 4))
        self.touch_staleness(time.time())
        self.publish()
        if generation is not None:
            self._generation.set(generation)
        with self._rate_lock:
            if self._rate_t is not None:
                dt = max(now - self._rate_t, 1e-9)
                inst = n_requests / dt
                # EWMA over batches: smooth enough to gauge, cheap enough
                # to update on every batch
                self._rate_value = (0.8 * self._rate_value + 0.2 * inst
                                    if self._rate_value else inst)
                self._rate.set(round(self._rate_value, 2))
            self._rate_t = now

    def publish(self, force: bool = False) -> None:
        """Refresh the p50/p99 gauges from the latency ring (ONE
        np.quantile pass for both), skipped when no new samples arrived
        since the last publish, or when ``min_publish_interval_s`` hasn't
        elapsed (``force``, the snapshot path, overrides).  The kernel
        counter gauges refresh on the same cadence, skipped while the
        counters are unchanged."""
        from ..obs.tree import kernel_stats

        if self._min_publish_interval and not force:
            now = time.monotonic()
            if now - self._last_expensive_publish \
                    < self._min_publish_interval:
                return
            self._last_expensive_publish = now
        stats = kernel_stats()
        if stats != self._kernel_published:
            from ..kernels.registry import kernel_stats as registry_stats

            registry_stats.publish(self._kernel_group)
            self._kernel_published = stats
        count = self.latency.count
        if count == self._published_count:
            return
        p50, p99 = self.latency.quantiles((0.50, 0.99))
        self._p50.set(round(1e3 * p50, 3))
        self._p99.set(round(1e3 * p99, 3))
        self._published_count = count

    def snapshot(self) -> Dict[str, object]:
        self.publish(force=True)    # exports never read interval-stale
        return self.group.snapshot()
