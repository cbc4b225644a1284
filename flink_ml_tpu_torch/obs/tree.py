"""One metrics tree: every observability surface behind one snapshot.

A port of the JAX package's ``obs/tree.py`` (host code).
:class:`MetricsTree` merges the surfaces: providers register under a
name, ``snapshot()`` returns ONE nested dict (JSON-clean: numpy scalars
and arrays normalized), and two writers hang off it:

- :func:`prometheus_text`: the Prometheus text exposition format
  (``# TYPE`` + ``name value`` lines).  Only finite numeric scalars
  export; a NaN gauge is **absent**, never a fake number (the
  never-published ``model_staleness_seconds`` reads NaN).
- :class:`ObsSampler`: an optional background thread appending one JSON
  line per tick to a time-series file.  Appends are line-framed and
  fsynced; a torn tail from a crash is detected and dropped by
  :func:`read_samples` (the WAL-tail stance, ``data/wal.py``).

The ``kernels`` provider is :func:`kernel_stats`: the kernel registry's
ledger (``kernels/registry.py::kernel_stats``: dispatches, compiles and
cache hits, the library cache's ``aot`` block, tuned ops), with each
CUDA kernel's launches beside it.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time

from typing import Any, Callable, Dict, List, Optional

__all__ = ["MetricsTree", "default_tree", "kernel_stats", "prometheus_text",
           "ObsSampler", "read_samples"]


def kernel_stats() -> Dict[str, Any]:
    """The kernel registry's ledger as one snapshot
    (``KernelStats.snapshot``): ``dispatches`` (segment and single-stage
    runs), ``compiles`` / ``cache_hits``, dispatch latency, the ``aot``
    block, ``tuned_ops``, ``per_op`` and ``launches`` (each CUDA kernel's
    launches since its module's last ``reset_launch_counts``)."""
    from ..kernels.registry import kernel_stats as stats

    return stats.snapshot()


def _jsonable(value: Any) -> Any:
    """Normalize numpy scalars/arrays (and nested containers) to plain
    Python so the snapshot serializes and diffs cleanly."""
    import numpy as np

    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, np.ndarray):
        return [_jsonable(v) for v in value.tolist()]
    if isinstance(value, np.generic):
        return value.item()
    return value


class MetricsTree:
    """name -> provider registry; ``snapshot()`` is the one nested dict.

    A provider is anything snapshot-shaped: a zero-arg callable returning
    a dict, a ``MetricGroup`` / ``ServingMetrics`` / ``SharedScheduler``
    (their ``snapshot()`` is used), or a plain dict (captured by
    REFERENCE: a live ``stream_info`` keeps updating).  A provider
    returning ``None`` is omitted from that snapshot (e.g.
    ``warmup_report`` before the first deploy)."""

    def __init__(self):
        self._providers: Dict[str, Callable[[], Any]] = {}
        self._lock = threading.Lock()

    def register(self, name: str, source: Any) -> "MetricsTree":
        if callable(source) and not hasattr(source, "snapshot"):
            provider = source
        elif hasattr(source, "snapshot"):
            provider = source.snapshot
        elif isinstance(source, dict):
            provider = lambda d=source: d          # noqa: E731 — live ref
        else:
            raise TypeError(
                f"unsnapshotable provider {type(source).__name__}: pass "
                "a callable, a dict, or an object with .snapshot()")
        with self._lock:
            self._providers[name] = provider
        return self

    def unregister(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._providers)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            providers = dict(self._providers)
        out: Dict[str, Any] = {}
        for name in sorted(providers):
            value = providers[name]()
            if value is None:
                continue
            out[name] = _jsonable(value)
        return out


def default_tree(*, endpoint: Any = None, serving: Any = None,
                 scheduler: Any = None, recovery: Any = None,
                 stream_info: Any = None, iteration_result: Any = None,
                 tracer: Any = None, autoscale: Any = None,
                 failover: Any = None, elastic: Any = None) -> MetricsTree:
    """A :class:`MetricsTree` pre-wired to every standard surface that
    exists in this process:

    - ``kernels``: :func:`kernel_stats`, always registered;
    - ``serving``: ``endpoint.metrics`` (or a bare ``ServingMetrics`` via
      ``serving=``), with its ``kernels.*`` re-export and the
      publish/staleness gauges;
    - ``scheduler``: a :class:`~flink_ml_tpu_torch.serving.scheduler.\
SharedScheduler`'s subtree (class-labeled shed counters, health, and
      every tenant's own ServingMetrics under ``tenants.<name>.*``);
    - ``warmup``: the live servable's readiness accounting (absent until
      the first deploy);
    - ``recovery``: a ``RecoveryReport`` (restarts / MTTR events);
    - ``training``: a live ``stream_info`` dict of a streamed fit;
    - ``iteration``: an ``IterationResult``'s ``side``;
    - ``trace``: span-tracer volume counters (never the spans themselves:
      those export through the tracer's own writers);
    - ``autoscale``: an :class:`~flink_ml_tpu_torch.autoscale.controller.\
AutoscaleController`'s self-view (ticks, actuations, decision latency,
      the policy's decision ledger, the live placement generation);
    - ``failover``: a :class:`~flink_ml_tpu_torch.serving.failover.\
FailoverDriver`'s fleet view (chips live/down, brownout level,
      failover/requeue/conflict counters, last failover wall);
    - ``elastic``: an :class:`~flink_ml_tpu_torch.parallel.elastic.\
ElasticCoordinator`'s fleet snapshot (fleet size, membership epoch,
      workers, join/leave/preempt/death/expiry/resize counters).
    """
    tree = MetricsTree()
    tree.register("kernels", kernel_stats)
    metrics = serving
    if endpoint is not None and metrics is None:
        metrics = endpoint.metrics
    if metrics is not None:
        tree.register("serving", metrics)
    if scheduler is not None:
        tree.register("scheduler", scheduler)
    if endpoint is not None:
        tree.register("warmup", lambda: endpoint.warmup_report)
    if recovery is not None:
        tree.register("recovery", recovery.as_dict)
    if stream_info is not None:
        tree.register("training", stream_info)
    if iteration_result is not None:
        tree.register("iteration", lambda: iteration_result.side)
    if tracer is not None:
        tree.register("trace", lambda: {
            "enabled": tracer.enabled, "spans": tracer.count,
            "dropped": tracer.dropped})
    if autoscale is not None:
        tree.register("autoscale", autoscale)
    if failover is not None:
        tree.register("failover", failover)
    if elastic is not None:
        tree.register("elastic", elastic)
    return tree


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(parts: List[str], prefix: str) -> str:
    name = "_".join([prefix] + parts) if prefix else "_".join(parts)
    name = _NAME_OK.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _flatten(tree: Dict[str, Any], parts: List[str],
             out: List[tuple]) -> None:
    for key in sorted(tree):
        value = tree[key]
        # dotted MetricGroup keys split into path segments so serving's
        # "kernels.dispatches" and a nested dict spell the same name
        sub = parts + [p for p in str(key).split(".") if p]
        if isinstance(value, dict):
            _flatten(value, sub, out)
        else:
            out.append((sub, value))


def prometheus_text(tree: Dict[str, Any], *,
                    prefix: str = "flink_ml_tpu") -> str:
    """Render a :meth:`MetricsTree.snapshot` (or any nested dict) in the
    Prometheus text exposition format, one gauge per finite numeric
    leaf.  Non-numeric leaves (strings, lists) are skipped: the nested
    snapshot is the full-fidelity export, this is the scrape surface.
    NaN/inf leaves are ABSENT.  The default prefix is the JAX package's,
    so a dashboard reads either package's exports."""
    leaves: List[tuple] = []
    _flatten(tree, [], leaves)
    lines: List[str] = []
    seen = set()
    for parts, value in leaves:
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            continue
        if not math.isfinite(value):
            continue
        name = _metric_name(parts, prefix)
        if name in seen:        # a collision keeps the first writer
            continue
        seen.add(name)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# background sampler: JSONL time series
# ---------------------------------------------------------------------------

class ObsSampler:
    """Append one ``{"t": ..., <tree snapshot>}`` JSON line per tick.

    The file is an append-only time series: every line is written whole
    and fsynced before the next tick, so the only crash artifact is a
    torn FINAL line, which :func:`read_samples` detects and drops.
    ``start()`` spawns a daemon thread; ``sample()`` is also callable
    directly for tick-on-demand use."""

    def __init__(self, tree: MetricsTree, path: str, *,
                 interval_s: float = 1.0,
                 clock: Callable[[], float] = time.time):
        if interval_s <= 0:
            raise ValueError("interval_s must be positive")
        self._tree = tree
        self._path = path
        self._interval = interval_s
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_written = 0

    def sample(self) -> Dict[str, Any]:
        """Take one snapshot and append it durably; returns the line's
        dict."""
        record = {"t": self._clock()}
        record.update(self._tree.snapshot())
        line = json.dumps(record) + "\n"
        # line-framed durable append: the whole line lands in ONE write +
        # fsync, so a crash tears at most the final line (a tmp ->
        # os.replace of the whole series per tick would be O(n^2))
        with open(self._path, "a") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())
        self.samples_written += 1
        return record

    # -- background thread --------------------------------------------------
    def start(self) -> "ObsSampler":
        if self._thread is not None:
            raise RuntimeError("sampler already started")
        self._stop.clear()

        def loop():
            while not self._stop.wait(self._interval):
                try:
                    self.sample()
                except Exception:   # noqa: BLE001 — sampling must never
                    pass            # kill the host process it observes

        self._thread = threading.Thread(
            target=loop, daemon=True, name="flink-ml-tpu-torch-obs-sampler")
        self._thread.start()
        return self

    def stop(self, *, final_sample: bool = True,
             timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if final_sample:
            self.sample()


def read_samples(path: str) -> List[Dict[str, Any]]:
    """Parse an :class:`ObsSampler` JSONL series, dropping a torn final
    line (crash mid-append).  A malformed NON-final line raises: like the
    WAL, mid-stream corruption is never silently skipped."""
    samples: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return samples
    with open(path) as f:
        lines = f.read().split("\n")
    # a clean file ends with "\n" -> trailing "" element; anything else in
    # the final slot is a torn tail, dropped
    for i, line in enumerate(lines[:-1]):
        if not line:
            continue
        try:
            samples.append(json.loads(line))
        except json.JSONDecodeError as exc:
            raise ValueError(
                f"sample {i} of {path!r} is corrupt ({exc}) but is not "
                "the tail — refusing to silently drop mid-series data"
            ) from exc
    return samples
