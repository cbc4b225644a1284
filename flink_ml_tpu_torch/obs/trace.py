"""Span tracing: ring-buffered spans with correlation ids, on the host's
clock and, while a ``torch.profiler`` session records, on the profiler's.

:class:`SpanTracer` records spans that carry correlation ids, so one
exported trace shows "checkpoint cut T -> chunk -> epoch" or "fit ->
epoch -> step -> Adam" as nested or adjacent events on a shared timeline.

- **One switch.**  The tracer records while :attr:`SpanTracer.recording`:
  it is enabled (:meth:`SpanTracer.enable`), or a ``torch.profiler``
  session is recording.  A span recorded under the profiler also enters
  ``torch.profiler.record_function(name)``, so it is a
  ``user_annotation`` in the profiler's own trace, on its clock, with
  the device work the profiler ties to it; the ring holds it as well.
  Retroactive :meth:`SpanTracer.add` and :meth:`SpanTracer.instant`
  record only while enabled.
- **Off by default, near-free when off.**  Not recording, ``span()``
  returns one shared no-op context manager: no allocation, no lock, no
  clock read.  A site that opens spans in a loop takes
  :meth:`SpanTracer.recorder` once, so that each iteration skips even the
  profiler test.
- **Stream time without a fence.**  ``span(..., device=d)`` on a CUDA
  device ``d`` records a timing ``torch.cuda.Event`` on the current
  stream at entry and another at exit, while recording only.  The span's
  ``stream_s`` (the stream's time between the two) is resolved when the
  spans are read or exported; nothing synchronizes inside the traced
  code, whose own host reads are the fence.  It counts every wait of
  the stream for the host inside the span: the card's busy time under a
  span is the profiler's (the kernels it ties to the annotation).
- **Bounded memory.**  Completed spans land in a preallocated ring
  (default 64 Ki spans); the lock is held only for the slot bump +
  assignment — never across a clock read or an export.
- **Correlation ids, not parent pointers.**  Spans carry a small dict
  of well-known keys (:data:`CORRELATION_KEYS`); viewers nest by
  (tid, time) containment, and cross-thread causality rides the shared
  ids.

Exports: Chrome-trace JSON (the ``traceEvents`` array Perfetto and
``chrome://tracing`` load directly) and JSONL (one span per line).  Both
writes are crash-atomic (tmp -> ``os.replace``).

Recorded on the process-wide :data:`tracer`: the checkpoint manager
(``checkpoint_write``), the supervisor (``recovery_restart``), the WAL,
serving and the streamed fit (``train_chunk``, ``train_epoch``); the
in-memory ``WideDeep.fit`` and ``KMeans.fit`` (``widedeep.*``,
``kmeans.*``), fused ``iterate`` (``iterate.epoch``), the Wide&Deep step
(``wd_step``, ``wd_step.*``) and the KMeans stats kernel
(``kmeans.stats``).
"""

from __future__ import annotations

import json
import os
import threading
import time

from typing import Any, Dict, Iterator, List, Optional

import torch

__all__ = ["Span", "SpanTracer", "tracer", "null_span", "CORRELATION_KEYS"]

#: whether a ``torch.profiler`` session records (about 0.1 us a call)
_profiling = torch._C._autograd._profiler_enabled

#: the correlation-id contract: instrumentation sites only attach these
#: keys (plus free-form strings prefixed ``x_`` for experiments), so a
#: trace consumer can join spans across threads/subsystems without
#: guessing.  ``request_id`` = one serving request; ``generation`` = the
#: live model generation; ``step`` = the trainer's global step (a
#: checkpoint cut and its publish share it); ``window`` = the WAL
#: window index; ``epoch``/``op``/``bucket`` label loops and dispatch;
#: ``tenant`` = a multi-tenant scheduler's tenant name.
CORRELATION_KEYS = ("request_id", "generation", "step", "window",
                    "epoch", "op", "bucket", "tenant")


class Span:
    """One completed (or instant) event: wall interval on this host's
    ``perf_counter`` timebase plus the correlation-id dict, and for a span
    timed on a CUDA stream its :attr:`stream_s`."""

    __slots__ = ("name", "cat", "t0", "dur", "tid", "ph", "ids", "_device")

    def __init__(self, name: str, cat: str, t0: float, dur: float,
                 tid: int, ph: str, ids: Dict[str, Any], device=None):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.dur = dur
        self.tid = tid
        self.ph = ph            # "X" complete | "i" instant
        self.ids = ids
        self._device = device   # None | (start, end) CUDA events | seconds

    @property
    def stream_s(self) -> Optional[float]:
        """Seconds on the device's stream between the span's entry and
        exit events, waits for the host included (None for a span not
        timed on a device).  The first read waits for the exit event and
        keeps the number."""
        d = self._device
        if isinstance(d, tuple):
            start, end = d
            end.synchronize()
            d = self._device = start.elapsed_time(end) * 1e-3
        return d

    def as_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "cat": self.cat,
               "t0_s": self.t0, "dur_s": self.dur,
               "tid": self.tid, "ph": self.ph}
        if self._device is not None:
            out["stream_s"] = self.stream_s
        out.update(self.ids)
        return out


class _NullSpan:
    """The shared disabled-path context manager: every method is a no-op
    and ``note`` chains, so instrumentation sites never branch."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **ids) -> "_NullSpan":
        return self


_NULL = _NullSpan()


def null_span(name: str, cat: str = "host", *, device=None, **ids):
    """What :meth:`SpanTracer.recorder` returns off the recording path:
    ``span()``'s signature, always the shared no-op."""
    return _NULL


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _stream_event(device):
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


class _LiveSpan:
    """One in-flight span; ``note(**ids)`` attaches correlation ids
    discovered mid-span (e.g. the generation captured after the batch
    formed).  ``annotate``: also a ``record_function`` range (a profiler
    session records); ``device``: a CUDA device whose current stream the
    span times with two events."""

    __slots__ = ("_tracer", "name", "cat", "ids", "_t0", "_annotation",
                 "_device", "_start")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 ids: Dict[str, Any], annotate: bool = False, device=None):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.ids = ids
        self._t0 = 0.0
        self._annotation = (torch.profiler.record_function(name)
                            if annotate else None)
        self._device = device if _on_card(device) else None
        self._start = None

    # the clock reads bracket the annotation, so that the ring's span
    # holds whatever the profiler's range holds (its own pauses included)
    def __enter__(self) -> "_LiveSpan":
        self._t0 = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__enter__()
        if self._device is not None:
            self._start = _stream_event(self._device)
        return self

    def __exit__(self, *exc) -> bool:
        events = (None if self._start is None else
                  (self._start, _stream_event(self._device)))
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        t1 = time.perf_counter()
        self._tracer._commit(Span(self.name, self.cat, self._t0,
                                  max(t1 - self._t0, 0.0),
                                  threading.get_ident(), "X", self.ids,
                                  events))
        return False

    def note(self, **ids) -> "_LiveSpan":
        self.ids.update(ids)
        return self


class SpanTracer:
    """Ring-buffered span recorder (module doc).  One process-wide
    instance lives at :data:`tracer`; tests and benches may construct
    private ones."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.enabled = False
        self._capacity = capacity
        self._buf: List[Optional[Span]] = [None] * capacity
        self._n = 0              # monotonic commit counter
        self._dropped = 0        # spans overwritten by the ring wrap
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()   # export-time origin

    # -- lifecycle ----------------------------------------------------------
    def enable(self, capacity: Optional[int] = None) -> "SpanTracer":
        """Clear and start recording (``capacity`` resizes the ring)."""
        with self._lock:
            if capacity is not None and capacity != self._capacity:
                if capacity <= 0:
                    raise ValueError("capacity must be positive")
                self._capacity = capacity
            self._buf = [None] * self._capacity
            self._n = 0
            self._dropped = 0
            self._epoch = time.perf_counter()
            self.enabled = True
        return self

    def disable(self) -> "SpanTracer":
        """Stop recording; already-captured spans stay exportable.  (A
        ``torch.profiler`` session still records spans.)"""
        self.enabled = False
        return self

    @property
    def recording(self) -> bool:
        """Enabled, or a ``torch.profiler`` session records."""
        return self.enabled or _profiling()

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self._capacity
            self._n = 0
            self._dropped = 0

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "host", *, device=None, **ids):
        """Context manager timing a code region.  Not :attr:`recording`
        -> the shared no-op (no allocation); recording -> a live span
        committed to the ring at exit, under a profiler session also a
        ``record_function`` range.  ``device``: the device the region's
        work runs on; on a CUDA device the span also gets ``stream_s``
        (two timing events on its current stream)."""
        return self.recorder()(name, cat, device=device, **ids)

    def recorder(self):
        """:meth:`span` with the recording test made now, for a site that
        opens spans in a loop (a fit's steps): read once, the result
        opens each span with no further test.  Not recording ->
        :func:`null_span`."""
        annotate = _profiling()
        if not (self.enabled or annotate):
            return null_span

        def span(name: str, cat: str = "host", *, device=None, **ids):
            return _LiveSpan(self, name, cat, ids, annotate, device)

        return span

    def add(self, name: str, t0: float, t1: float, *, cat: str = "host",
            tid: Optional[int] = None, **ids) -> None:
        """Commit a RETROACTIVE span measured by the caller (``t0``/``t1``
        on the ``perf_counter`` timebase) — how queue-wait is recorded:
        the serve loop stamps it from the request's submit timestamp
        once the batch forms, no tracer work on the submit path."""
        if not self.enabled:
            return
        self._commit(Span(name, cat, t0, max(t1 - t0, 0.0),
                          tid if tid is not None else
                          threading.get_ident(), "X", ids))

    def instant(self, name: str, cat: str = "host", **ids) -> None:
        """Zero-duration marker event (e.g. a shed, a rollback)."""
        if not self.enabled:
            return
        self._commit(Span(name, cat, time.perf_counter(), 0.0,
                          threading.get_ident(), "i", ids))

    def _commit(self, span: Span) -> None:
        # lock-cheap: the lock covers only the slot bump + assignment
        with self._lock:
            idx = self._n % self._capacity
            if self._buf[idx] is not None:
                self._dropped += 1
            self._buf[idx] = span
            self._n += 1

    # -- reading ------------------------------------------------------------
    @property
    def count(self) -> int:
        """Spans committed since enable (monotonic — includes spans the
        ring has since overwritten)."""
        return self._n

    @property
    def dropped(self) -> int:
        return self._dropped

    def spans(self) -> List[Span]:
        """Retained spans, oldest first (ring order)."""
        with self._lock:
            n, cap = self._n, self._capacity
            if n <= cap:
                return [s for s in self._buf[:n] if s is not None]
            head = n % cap
            return [s for s in self._buf[head:] + self._buf[:head]
                    if s is not None]

    def find(self, name: Optional[str] = None, **ids) -> Iterator[Span]:
        """Retained spans matching ``name`` and every given id."""
        for span in self.spans():
            if name is not None and span.name != name:
                continue
            if all(span.ids.get(k) == v for k, v in ids.items()):
                yield span

    # -- export -------------------------------------------------------------
    def _us(self, t: float) -> float:
        return (t - self._epoch) * 1e6

    def chrome_events(self) -> List[Dict[str, Any]]:
        """The Chrome-trace ``traceEvents`` array (what Perfetto /
        ``chrome://tracing`` load): ``ph: "X"`` complete events with
        microsecond ``ts``/``dur`` relative to the tracer's enable
        point, correlation ids under ``args``."""
        pid = os.getpid()
        events = []
        for s in self.spans():
            ev: Dict[str, Any] = {
                "name": s.name, "cat": s.cat, "ph": s.ph,
                "ts": round(self._us(s.t0), 3), "pid": pid, "tid": s.tid,
                "args": dict(s.ids),
            }
            if s.ph == "X":
                ev["dur"] = round(s.dur * 1e6, 3)
                if s.stream_s is not None:
                    ev["args"]["stream_s"] = s.stream_s
            else:
                ev["s"] = "t"          # instant scope: thread
            events.append(ev)
        return events

    def export_chrome(self, path: str) -> int:
        """Write Chrome-trace JSON (atomic: tmp -> ``os.replace``).
        Returns the event count."""
        events = self.chrome_events()
        payload = {"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"dropped_spans": self._dropped}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return len(events)

    def export_jsonl(self, path: str) -> int:
        """One span per line (machine-diffable; atomic full rewrite)."""
        spans = self.spans()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for s in spans:
                f.write(json.dumps(s.as_dict()) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return len(spans)


#: THE process-wide tracer every instrumentation site records into.
tracer = SpanTracer()
