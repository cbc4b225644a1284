"""Request queue + dynamic micro-batcher.

The serving problem on an accelerator is the inverse of the training
problem: traffic arrives as many SMALL concurrent requests (single rows to
a few dozen), but the device only earns its keep on large fixed-shape
batches.  The micro-batcher closes that gap: concurrent requests coalesce
into one batch under a **max-wait deadline** — the first request of a
batch never waits longer than ``max_wait_ms`` for company — and the batch
then pads to a power-of-two bucket downstream (``utils/padding.py``) so
the executor runs one of a bounded set of warmed shapes.

Admission control is the bounded queue: when ``queue_capacity`` requests
are already pending the submit is SHED with :class:`ServingOverloadedError`
(the documented backpressure signal — callers retry with jitter or spill
to a replica) instead of growing an unbounded latency tail.

Threading model: ``submit`` is called from any number of client threads;
``next_batch`` is called by exactly one consumer (the endpoint's serve
loop).  One condition variable covers both sides.

A copy of the JAX package's ``serving/batcher.py`` (host code).
"""

from __future__ import annotations

import itertools
import threading
import time

from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..data.table import Table

__all__ = ["MicroBatcher", "ServingRequest", "ServingOverloadedError",
           "concat_request_tables"]


def concat_request_tables(tables) -> Table:
    """One batch Table from the requests' tables, in batch order — THE
    shared micro-batch assembly (endpoint serve loop + multi-tenant
    scheduler): column-aligned concat, zero copies for a single-request
    batch."""
    if len(tables) == 1:
        return tables[0]
    names = tables[0].column_names
    return Table({
        name: np.concatenate([t[name] for t in tables], axis=0)
        for name in names})

#: process-wide request-id source — THE ``request_id`` correlation id of
#: the span-tracing contract (``obs/trace.py``): assigned at submit,
#: carried by the request through queue-wait/serve spans, unique across
#: every endpoint in the process so one exported trace never aliases
#: two requests
_REQUEST_IDS = itertools.count(1)


class ServingOverloadedError(RuntimeError):
    """The serving queue is full; this request was shed (admission
    control).  The request was NOT enqueued — retry later or route to
    another replica."""


@dataclass
class ServingRequest:
    """One in-flight request: the input rows, the Future the caller awaits
    (resolves to the output Table slice for exactly these rows), and the
    submit timestamp the latency metrics are measured from."""
    table: Table
    rows: int
    future: Future = field(default_factory=Future)
    submitted_at: float = field(default_factory=time.perf_counter)
    request_id: int = field(default_factory=lambda: next(_REQUEST_IDS))


class MicroBatcher:
    """Bounded request queue with deadline-coalescing batch formation.

    ``next_batch`` drains pending requests into one batch while the total
    row count fits ``max_batch_rows``, waiting up to ``max_wait_ms`` (from
    the moment the first request is seen) for more arrivals; a request
    that would overflow the batch stays queued for the next one.  Requests
    are never split across batches, so a single request may hold at most
    ``max_batch_rows`` rows (validated at submit).
    """

    def __init__(self, *, max_batch_rows: int = 256,
                 max_wait_ms: float = 2.0,
                 queue_capacity: int = 1024):
        if max_batch_rows <= 0:
            raise ValueError("max_batch_rows must be positive")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if queue_capacity <= 0:
            raise ValueError("queue_capacity must be positive")
        self.max_batch_rows = max_batch_rows
        self.max_wait_s = max_wait_ms / 1e3
        self.queue_capacity = queue_capacity
        self._pending: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        #: lock-free shed fast path: when True (the default), a submit
        #: against an already-full queue sheds on ONE unlocked read of
        #: the queue length — under saturation, thousands of shed
        #: decisions per second must not serialize on the hot queue lock
        #: they would otherwise all contend for.  The read is racy by
        #: design: it can only fire when the queue is AT capacity, where
        #: a concurrent drain making one slot free means at worst one
        #: spurious shed at the saturation boundary — admission
        #: control's documented semantics either way.  The authoritative
        #: check under the lock still guards every admit.  (False takes
        #: the locked path, for an A/B of the two.)
        self.fast_shed = True

    def _shed_error(self) -> ServingOverloadedError:
        return ServingOverloadedError(
            f"serving queue full ({self.queue_capacity} requests "
            "pending); request shed — retry with backoff or route "
            "to another replica")

    # -- producer side ------------------------------------------------------
    def submit(self, table: Table) -> ServingRequest:
        rows = table.num_rows
        if rows == 0:
            raise ValueError("cannot serve an empty (0-row) request")
        if rows > self.max_batch_rows:
            raise ValueError(
                f"request has {rows} rows > max_batch_rows="
                f"{self.max_batch_rows}; split it client-side")
        # len(deque) is a single atomic read under the GIL — no lock
        if self.fast_shed and len(self._pending) >= self.queue_capacity \
                and not self._closed:
            raise self._shed_error()
        with self._cond:
            if self._closed:
                raise RuntimeError("serving endpoint is closed")
            if len(self._pending) >= self.queue_capacity:
                raise self._shed_error()
            request = ServingRequest(table, rows)
            self._pending.append(request)
            self._cond.notify_all()
        return request

    # -- consumer side ------------------------------------------------------
    def next_batch(self, timeout: Optional[float] = None
                   ) -> Optional[List[ServingRequest]]:
        """Form the next micro-batch.  Blocks up to ``timeout`` seconds for
        a first request (None = forever); returns None when nothing
        arrived (or the batcher is closed and drained).  Once a first
        request is in hand, coalesces arrivals until the batch is full or
        ``max_wait_ms`` has elapsed."""
        with self._cond:
            if not self._pending:
                if self._closed:
                    return None
                self._cond.wait(timeout)
                if not self._pending:
                    return None
            batch: List[ServingRequest] = []
            rows = 0
            deadline = time.perf_counter() + self.max_wait_s
            while True:
                while (self._pending
                       and rows + self._pending[0].rows
                       <= self.max_batch_rows):
                    request = self._pending.popleft()
                    batch.append(request)
                    rows += request.rows
                if rows >= self.max_batch_rows or self._pending \
                        or self._closed:
                    # full, or the next request doesn't fit, or closing:
                    # ship what we have
                    break
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            return batch

    def requeue(self, batch: List[ServingRequest]) -> int:
        """Put a formed-but-undispatched batch BACK at the FRONT of the
        queue (reversed, restoring the original order), futures and
        request ids untouched — the chip-fault path: the
        retried dispatch answers the same futures bit-identically, so
        a chip death at the dispatch boundary drops ZERO requests.
        Deliberately bypasses the capacity check: these requests were
        already admitted once, and bouncing them now WOULD be a drop."""
        with self._cond:
            for request in reversed(batch):
                self._pending.appendleft(request)
            if batch:
                self._cond.notify_all()
        return len(batch)

    # -- lifecycle ----------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def empty(self) -> bool:
        return not self._pending

    def close(self) -> None:
        """Stop admitting; already-queued requests still drain through
        ``next_batch``."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
