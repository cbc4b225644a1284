"""Observability: span tracing with correlation ids (:mod:`.trace`) and
the per-step :class:`~.probe.StepProbe` of the streamed fits."""

from .probe import StepProbe
from .trace import CORRELATION_KEYS, Span, SpanTracer, tracer

__all__ = ["CORRELATION_KEYS", "Span", "SpanTracer", "StepProbe", "tracer"]
