"""Metrics: counters and gauges in nested groups, and per-epoch iteration
metrics.

A port of the JAX package's ``utils/metrics.py`` (host code).  A
``MetricGroup`` is a plain nested registry (the analog of Flink's metric
groups), and ``IterationMetricsListener`` hooks the hosted epoch loop
(``iteration/core.py``) to record wall time, records/sec and any scalar
epoch outputs.
"""

from __future__ import annotations

import logging
import time

from typing import Any, Dict, List, Optional

import numpy as np

from ..iteration.body import EpochContext, IterationListener

__all__ = ["MetricGroup", "Counter", "Gauge", "IterationMetricsListener"]

logger = logging.getLogger("flink_ml_tpu_torch")


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, amount: int = 1) -> None:
        self.value += amount


class Gauge:
    __slots__ = ("value",)

    def __init__(self, value: Any = None) -> None:
        self.value = value

    def set(self, value: Any) -> None:
        self.value = value


class MetricGroup:
    """Nested name -> metric registry (``group.add_group("epoch").counter(
    "records")`` mirrors Flink's ``getMetricGroup().addGroup(...)``)."""

    def __init__(self, name: str = "root"):
        self.name = name
        self._groups: Dict[str, "MetricGroup"] = {}
        self._metrics: Dict[str, Any] = {}

    def add_group(self, name: str) -> "MetricGroup":
        return self._groups.setdefault(name, MetricGroup(name))

    def counter(self, name: str) -> Counter:
        return self._metrics.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._metrics.setdefault(name, Gauge())

    def snapshot(self, prefix: str = "") -> Dict[str, Any]:
        """Flatten to {dotted.name: value}."""
        out: Dict[str, Any] = {}
        for name, metric in self._metrics.items():
            out[f"{prefix}{name}"] = metric.value
        for name, group in self._groups.items():
            out.update(group.snapshot(f"{prefix}{name}."))
        return out


class IterationMetricsListener(IterationListener):
    """Per-epoch wall-clock + throughput recorder for hosted iterations.

    ``records_per_epoch`` (if given) yields records/sec; scalar epoch
    outputs are kept in ``epoch_metrics``.  ``log_every`` INFO-logs
    progress every that many epochs.
    """

    def __init__(self, records_per_epoch: Optional[int] = None,
                 log_every: int = 0,
                 group: Optional[MetricGroup] = None):
        self.group = group or MetricGroup("iteration")
        self.records_per_epoch = records_per_epoch
        self.log_every = log_every
        self.epoch_seconds: List[float] = []
        self.epoch_metrics: List[float] = []
        self._last = time.perf_counter()
        self._epochs = self.group.counter("epochs")
        self._records = self.group.counter("records")
        self._rate = self.group.gauge("records_per_sec")

    def on_epoch_watermark_incremented(self, epoch: int,
                                       context: EpochContext) -> None:
        now = time.perf_counter()
        elapsed = now - self._last
        self._last = now
        self.epoch_seconds.append(elapsed)
        self._epochs.inc()
        if self.records_per_epoch:
            self._records.inc(self.records_per_epoch)
            self._rate.set(self.records_per_epoch / max(elapsed, 1e-9))
        if context.outputs is not None and np.ndim(context.outputs) == 0:
            self.epoch_metrics.append(float(context.outputs))
        if self.log_every and (epoch + 1) % self.log_every == 0:
            logger.info(
                "epoch %d: %.4fs/epoch%s%s", epoch, elapsed,
                (f", {self._rate.value:.0f} rec/s" if self.records_per_epoch
                 else ""),
                (f", metric={self.epoch_metrics[-1]:.6g}"
                 if self.epoch_metrics else ""))

    def on_iteration_terminated(self, context: EpochContext) -> None:
        total = sum(self.epoch_seconds)
        self.group.gauge("total_seconds").set(total)
        if self.log_every:
            logger.info("iteration finished: %d epochs in %.3fs",
                        len(self.epoch_seconds), total)
