"""Observability: span tracing with correlation ids (:mod:`.trace`), the
per-step :class:`~.probe.StepProbe` of the streamed fits, and one metrics
tree over every surface with its Prometheus and JSONL writers
(:mod:`.tree`)."""

from .probe import StepProbe
from .trace import CORRELATION_KEYS, Span, SpanTracer, tracer
from .tree import (MetricsTree, ObsSampler, default_tree, kernel_stats,
                   prometheus_text, read_samples)

__all__ = ["CORRELATION_KEYS", "MetricsTree", "ObsSampler", "Span",
           "SpanTracer", "StepProbe", "default_tree", "kernel_stats",
           "prometheus_text", "read_samples", "tracer"]
