"""Unbounded-stream substrate: windowed sources shared by every online
estimator.

The reference makes unbounded iteration a first-class entry point
(``Iterations.iterateUnboundedStreams``, ``Iterations.java:118-127``) and
windows bounded streams with ``EndOfStreamWindows``
(``common/datastream/EndOfStreamWindows.java:36-71``).  Here a bounded
stream is a Table, an unbounded stream is an iterator of Tables, and
*windowing* is this module: one shared implementation of count/event-time
tumbling windows with watermark-style close and a snapshot/restore cursor,
instead of each online model reimplementing its own batching.

Consumers: OnlineLogisticRegression and OnlineKMeans go through
:func:`windows_of`; the cursor protocol is what ``iterate``'s
checkpointing expects of a data source (the ``DataCacheReader`` surface:
``snapshot()``/``restore()``).

A copy of the JAX package's ``data/stream.py`` (host-only).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np

from .table import Table

__all__ = ["CountWindows", "EventTimeWindows", "cursor_adapter",
           "ensure_cursor_source", "windows_of"]


class CountWindows:
    """Tumbling count windows over a stream of rows.

    ``source`` is a Table (bounded: rows are windowed in order and the final
    partial window flushes at end-of-stream — the ``EndOfStreamWindows``
    close) or an iterable of Tables (unbounded feed: incoming tables are
    re-chunked to exactly ``window_rows``, buffering across table
    boundaries; whatever remains when the feed ends flushes as the last
    window).
    """

    def __init__(self, source: Any, window_rows: int):
        if window_rows <= 0:
            raise ValueError(f"window_rows must be positive, got {window_rows}")
        self.window_rows = window_rows
        self._table = source if isinstance(source, Table) else None
        self._feed = None if self._table is not None else source
        self._cursor = 0          # rows (table) / windows emitted (feed)
        self._skip = 0            # feed windows to discard after restore

    # -- iteration -----------------------------------------------------------
    def __iter__(self) -> Iterator[Table]:
        if self._table is not None:
            yield from self._iter_table()
        else:
            yield from self._iter_feed(skip=self._skip)

    def _iter_table(self) -> Iterator[Table]:
        n = self._table.num_rows
        while self._cursor < n:
            end = min(self._cursor + self.window_rows, n)
            window = self._table.slice(self._cursor, end)
            self._cursor = end
            yield window

    def _iter_feed(self, skip: int) -> Iterator[Table]:
        pending: Optional[Table] = None
        emitted = 0

        def emit(window: Table):
            nonlocal emitted
            emitted += 1
            self._cursor = emitted
            return window

        for t in self._feed:
            pending = t if pending is None else pending.concat(t)
            while pending.num_rows >= self.window_rows:
                window = pending.take(self.window_rows)
                pending = pending.slice(self.window_rows, pending.num_rows)
                if emitted < skip:
                    emitted += 1
                    continue
                yield emit(window)
        if pending is not None and pending.num_rows > 0 and emitted >= skip:
            yield emit(pending)   # end-of-stream watermark: flush the tail

    # -- cursor protocol -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {"cursor": self._cursor}

    def restore(self, snap: Dict[str, Any]) -> None:
        cursor = int(snap["cursor"])
        if self._table is not None:
            if not 0 <= cursor <= self._table.num_rows:
                raise ValueError(f"cursor {cursor} out of range")
            self._cursor = cursor
        else:
            # feed cursors fast-forward by re-windowing and discarding —
            # exact for replayable feeds; live feeds need a WindowLog tee
            # (data/wal.py) for loss-free restore
            self._skip = cursor


class EventTimeWindows:
    """Tumbling event-time windows: each row joins the window
    ``[k*size, (k+1)*size)`` holding its timestamp; a window closes when the
    watermark — the max timestamp seen minus ``allowed_lateness`` — passes
    its end (rows later than that are dropped, the streaming-engine late-data
    rule).  All still-open windows flush in time order at end-of-stream.

    ``source`` is a Table or an iterable of Tables carrying ``time_col``.

    Cursor caveat: ``snapshot``/``restore`` count EMITTED windows and
    fast-forward by re-iterating the source — exact only when the source
    replays deterministically from the start (a Table, a file, a cache).
    For a genuinely live feed, wrap the window stream in
    :class:`flink_ml_tpu_torch.data.wal.WindowLog`, whose write-ahead log
    replays consumed-but-uncheckpointed windows without touching the
    source (the ``Checkpoints.java`` analog).
    """

    def __init__(self, source: Any, time_col: str, window_size: float,
                 allowed_lateness: float = 0.0):
        if window_size <= 0:
            raise ValueError("window_size must be positive")
        self._source = [source] if isinstance(source, Table) else source
        self.time_col = time_col
        self.window_size = float(window_size)
        self.allowed_lateness = float(allowed_lateness)
        self._emitted = 0

    def _window_key(self, ts: np.ndarray) -> np.ndarray:
        return np.floor(ts / self.window_size).astype(np.int64)

    def __iter__(self) -> Iterator[Table]:
        open_windows: Dict[int, Table] = {}
        watermark = -np.inf
        emitted = 0
        skip = self._emitted

        def close_ready():
            nonlocal emitted
            for key in sorted(open_windows):
                if (key + 1) * self.window_size <= watermark:
                    window = open_windows.pop(key)
                    emitted += 1
                    if emitted > skip:
                        self._emitted = emitted
                        yield window
                else:
                    break  # later windows end even later

        for t in self._source:
            ts = np.asarray(t[self.time_col], np.float64)
            if len(ts) == 0:
                continue
            keys = self._window_key(ts)
            # a row is late iff its window ALREADY closed (window end behind
            # the watermark); rows for still-open windows always join them
            live = (keys + 1) * self.window_size > watermark
            for key in np.unique(keys[live]):
                rows = Table({c: np.asarray(t[c])[live & (keys == key)]
                              for c in t.column_names})
                open_windows[key] = (rows if key not in open_windows
                                     else open_windows[key].concat(rows))
            watermark = max(watermark,
                            float(ts.max()) - self.allowed_lateness)
            yield from close_ready()
        # end of stream: the watermark jumps to +inf, closing everything
        watermark = np.inf
        yield from close_ready()

    def snapshot(self) -> Dict[str, Any]:
        return {"emitted": self._emitted}

    def restore(self, snap: Dict[str, Any]) -> None:
        self._emitted = int(snap["emitted"])


def windows_of(source: Any, window_rows: int) -> Iterator[Table]:
    """THE shared online-model ingest: a Table is count-windowed into
    ``window_rows`` chunks; an iterable of Tables passes through AS-IS (a
    live feed's framing IS its windowing — each yielded Table is one
    window); a Count/EventTimeWindows is consumed as-is, so callers can hand
    a re-chunked or time-windowed stream straight to any online
    estimator."""
    if isinstance(source, Table):
        return iter(CountWindows(source, window_rows))
    return iter(source)


def ensure_cursor_source(source: Any, window_rows: int):
    """THE checkpoint-source preparation shared by the online estimators:
    a bare Table auto-wraps in :class:`CountWindows` (it has no cursor of
    its own), and anything without ``snapshot``/``restore`` is rejected —
    resume would otherwise silently re-train already-consumed windows."""
    if isinstance(source, Table):
        source = CountWindows(source, window_rows)
    if not (hasattr(source, "snapshot") and hasattr(source, "restore")):
        raise ValueError(
            "checkpointed streaming fit needs a source with a cursor "
            "(snapshot/restore): resume would otherwise silently re-train "
            "already-consumed windows.  Use CountWindows / "
            "EventTimeWindows / DataCacheReader, or wrap a live feed in "
            "flink_ml_tpu_torch.data.wal.WindowLog")
    return source


def cursor_adapter(source: Any, payloads):
    """Iterable whose items come from ``payloads()`` (a zero-arg generator
    factory) while ``snapshot``/``restore`` delegate to ``source`` — THE
    shim the checkpointed online estimators hand to ``iterate`` so the
    stream cursor rides the checkpoint (one copy; OnlineLogisticRegression
    and OnlineKMeans both route through it)."""

    class _CursorAdapter:
        def __iter__(self):
            return payloads()

        def __getattr__(self, name):
            if name in ("snapshot", "restore"):
                return getattr(source, name)  # AttributeError if absent
            raise AttributeError(name)

    return _CursorAdapter()
