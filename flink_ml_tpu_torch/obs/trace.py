"""Span tracing: ring-buffered host spans with correlation ids.

:class:`SpanTracer` records spans that carry correlation ids, so one
exported trace shows "checkpoint cut T -> chunk -> epoch" as nested or
adjacent events on a shared timeline.

- **Off by default, near-free when off.**  Every instrumentation site
  goes through :meth:`SpanTracer.span` (or guards on
  :attr:`SpanTracer.enabled`); disabled, ``span()`` returns one shared
  no-op context manager — no allocation, no lock, no clock read.
- **Bounded memory.**  Completed spans land in a preallocated ring
  (default 64 Ki spans); the lock is held only for the slot bump +
  assignment — never across a clock read or an export.
- **Correlation ids, not parent pointers.**  Spans carry a small dict
  of well-known keys (:data:`CORRELATION_KEYS`); viewers nest by
  (tid, time) containment, and cross-thread causality rides the shared
  ids.
- **Host clock only.**  A span that covers device work ends where the
  host fenced it (a device-to-host read); nothing here synchronizes the
  device.

Exports: Chrome-trace JSON (the ``traceEvents`` array Perfetto and
``chrome://tracing`` load directly) and JSONL (one span per line).  Both
writes are crash-atomic (tmp -> ``os.replace``).

A copy of the JAX package's ``obs/trace.py`` (host-only).  The checkpoint
manager (``checkpoint_write``) and the supervisor (``recovery_restart``)
record on the process-wide :data:`tracer`, as do the streamed fit's
``train_chunk`` and ``train_epoch`` spans.
"""

from __future__ import annotations

import json
import os
import threading
import time

from typing import Any, Dict, Iterator, List, Optional

__all__ = ["Span", "SpanTracer", "tracer", "CORRELATION_KEYS"]

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
    ``perf_counter`` timebase plus the correlation-id dict."""

    __slots__ = ("name", "cat", "t0", "dur", "tid", "ph", "ids")

    def __init__(self, name: str, cat: str, t0: float, dur: float,
                 tid: int, ph: str, ids: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.dur = dur
        self.tid = tid
        self.ph = ph            # "X" complete | "i" instant
        self.ids = ids

    def as_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "cat": self.cat,
               "t0_s": self.t0, "dur_s": self.dur,
               "tid": self.tid, "ph": self.ph}
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


class _LiveSpan:
    """One in-flight span; ``note(**ids)`` attaches correlation ids
    discovered mid-span (e.g. the generation captured after the batch
    formed)."""

    __slots__ = ("_tracer", "name", "cat", "ids", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 ids: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.ids = ids
        self._t0 = 0.0

    def __enter__(self) -> "_LiveSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer.add(self.name, self._t0, time.perf_counter(),
                         cat=self.cat, **self.ids)
        return False

    def note(self, **ids) -> "_LiveSpan":
        self.ids.update(ids)
        return self


class SpanTracer:
    """Ring-buffered host span recorder (module doc).  One process-wide
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
        """Stop recording; already-captured spans stay exportable."""
        self.enabled = False
        return self

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self._capacity
            self._n = 0
            self._dropped = 0

    # -- recording ----------------------------------------------------------
    def span(self, name: str, cat: str = "host", **ids):
        """Context manager timing a code region.  Disabled -> the shared
        no-op (no allocation); enabled -> a live span committed to the
        ring at exit."""
        if not self.enabled:
            return _NULL
        return _LiveSpan(self, name, cat, ids)

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
