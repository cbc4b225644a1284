"""Write-ahead window log — exactly-once ingest for LIVE (non-replayable)
unbounded feeds.

The reference logs in-flight feedback records into each pending checkpoint
so a restore loses nothing even mid-superstep
(``flink-ml-iteration/.../checkpoint/Checkpoints.java:43-211``).  The
port's iteration has no feedback channel to log — but a live feed has
the same exposure at the INGEST edge: windows consumed between the last
checkpoint cut and a crash are gone, because a true live source cannot be
re-iterated.  :class:`WindowLog` closes that hole at window granularity:

- every window pulled from the live source is persisted (atomic
  write-then-rename) BEFORE it is handed to the consumer;
- ``snapshot()`` returns the count of windows consumed — the cursor the
  iteration checkpoint stores (`iteration/core.py` feed envelopes);
- on restore, windows logged beyond the cursor replay FIRST (in order),
  then the live source resumes.  A crash with no checkpoint at all simply
  replays the whole log — the no-cut case heals too.

The irreducible race is a crash between pulling a window from the source
and the rename making it durable: that window is lost (the source moved
on).  The reference has the same exposure for records in flight between
the feedback channel and ``Checkpoints.append``; both designs make the
vulnerable span a few microseconds rather than a whole checkpoint
interval.

Storage: ``win-{i:08d}.npz`` per window under ``directory``; older
entries are truncated on snapshot once they fall behind the
``keep_snapshots`` most recent cuts (every kept cut must still be able to
restore).

Durability cost: one file fsync and one directory fsync per window.
``chip_smoke.py`` (phase 24) measures the windows/s of a streamed FTRL
fit over a log on the card host's local disk.

A copy of the JAX package's ``data/wal.py`` over the port's ``obs.trace``,
``robustness.durability`` and ``robustness.faults``.
"""

from __future__ import annotations

import logging
import os
import tempfile
import zipfile

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .table import Table
from ..obs.trace import tracer
from ..robustness.durability import CorruptStateError
from ..robustness.faults import fault_point

__all__ = ["WindowLog", "WindowBatchReader"]

log = logging.getLogger("flink_ml_tpu_torch.robustness")


def _win_name(i: int) -> str:
    return f"win-{i:08d}.npz"


class WindowLog:
    """Durable tee over an iterable of window Tables (see module doc).

    One directory belongs to ONE logical stream: pointing a fresh run at a
    dirty directory replays the leftover windows (that is the crash-heal
    path; for a genuinely new stream, use a new directory).
    """

    def __init__(self, source: Any, directory: str, *,
                 keep_snapshots: int = 2, retry_policy: Optional[Any] = None):
        if keep_snapshots < 1:
            raise ValueError("keep_snapshots must be >= 1")
        self._source = source
        self._dir = directory
        self._keep = keep_snapshots
        #: a robustness.retry.RetryPolicy: transient append failures
        #: (flaky NFS, injected faults) cost a backoff sleep, not the run
        self._retry = retry_policy
        os.makedirs(directory, exist_ok=True)
        self._consumed = 0           # windows handed to the consumer
        self._start = 0              # restore position
        self._snap_positions: List[int] = []
        # next log index = 1 + highest persisted window (gaps below come
        # from truncation; a stale tmp file from a mid-write crash is
        # ignored and overwritten)
        existing = [int(name[4:-4]) for name in os.listdir(directory)
                    if name.startswith("win-") and name.endswith(".npz")]
        self._next_log = max(existing) + 1 if existing else 0

    # -- iteration ---------------------------------------------------------
    def __iter__(self) -> Iterator[Table]:
        i = self._start
        # replay phase: logged-but-unacknowledged windows
        while i < self._next_log:
            path = os.path.join(self._dir, _win_name(i))
            if not os.path.exists(path):
                raise ValueError(
                    f"window {i} missing from log {self._dir!r}: the "
                    "restore cursor predates the truncation horizon "
                    "(keep_snapshots too small for this checkpoint lag)")
            try:
                with np.load(path, allow_pickle=True) as data:
                    window = Table({k: data[k] for k in data.files})
            except (zipfile.BadZipFile, EOFError, OSError,
                    ValueError, KeyError) as exc:
                if i == self._next_log - 1:
                    # torn TAIL entry: the crash hit mid-append, so this
                    # window never reached the consumer — drop it and
                    # resume live exactly where the log truly ends (the
                    # same few-microsecond exposure as the module doc's
                    # pull-to-rename race, now detected instead of fatal)
                    log.warning(
                        "window log %s: truncating torn tail entry %d "
                        "(%r)", self._dir, i, exc)
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    self._next_log = i
                    break
                raise CorruptStateError(
                    f"window {i} of log {self._dir!r} is corrupt ({exc!r}) "
                    "but is NOT the tail — windows beyond it were already "
                    "consumed, so truncating would silently drop data; "
                    "restore from a checkpoint past this window or start "
                    "a fresh log directory") from exc
            i += 1
            self._consumed = i
            yield window
        # live phase: write-ahead, then hand over
        for window in self._source:
            with tracer.span("wal_append", cat="train",
                             window=self._next_log):
                if self._retry is not None:
                    self._retry.call(self._persist, self._next_log, window)
                else:
                    self._persist(self._next_log, window)
            self._next_log += 1
            self._consumed = self._next_log
            yield window

    def _persist(self, i: int, window: Table) -> None:
        cols = {k: np.asarray(window[k]) for k in window.column_names}
        fd, tmp = tempfile.mkstemp(dir=self._dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **cols)
                f.flush()
                os.fsync(f.fileno())   # durable BEFORE the consumer sees it
            # fault seam: control faults (transient -> retried by the
            # policy above, ENOSPC -> fatal) raise here; data faults
            # damage tmp so the rename commits a torn tail entry — the
            # case the replay-side truncation above exists for
            fault_point("wal.append", tmp)
            os.replace(tmp, os.path.join(self._dir, _win_name(i)))
            dirfd = os.open(self._dir, os.O_RDONLY)
            try:
                os.fsync(dirfd)        # the rename itself must survive too
            finally:
                os.close(dirfd)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- cursor protocol (what iterate()'s checkpoint stores) --------------
    def snapshot(self) -> Dict[str, Any]:
        pos = self._consumed
        self._snap_positions.append(pos)
        if len(self._snap_positions) > self._keep:
            horizon = self._snap_positions[-self._keep]
            self._truncate_below(horizon)
        return {"consumed": pos}

    def restore(self, snap: Dict[str, Any]) -> None:
        self._consumed = self._start = int(snap["consumed"])

    def _truncate_below(self, horizon: int) -> None:
        for name in os.listdir(self._dir):
            if (name.startswith("win-") and name.endswith(".npz")
                    and int(name[4:-4]) < horizon):
                try:
                    os.unlink(os.path.join(self._dir, name))
                except OSError:
                    pass


class WindowBatchReader:
    """Adapts a :class:`WindowLog` (or any iterable of window Tables)
    into the ``sgd_fit_outofcore`` reader protocol for CONTINUOUS
    training: one window = one optimizer batch, every window carrying
    exactly ``batch_rows`` rows (the training-stream contract — a ragged
    window raises instead of silently padding, because the WAL replay
    and the offline-equivalence acceptance both assume a fixed grid).

    Speaks the checkpoint fast-forward half of the cursor protocol
    (``seek`` + ``batch_rows``): ``seek(k * batch_rows)`` maps the row
    cursor back onto the log's WINDOW cursor via ``WindowLog.restore``,
    so a resumed fit replays exactly the logged-but-unacknowledged
    windows past its restored step — the exactly-once ingest edge of the
    train-while-serve loop (``online/driver.py``).  It does
    NOT claim ``total_rows``: the stream is unbounded, so the decoded
    replay cache must never engage.

    ``max_windows`` bounds the run (benches/tests); the bound is an
    ABSOLUTE window index, so a resumed reader still stops at the same
    stream position.
    """

    def __init__(self, log: Any, batch_rows: int, *,
                 max_windows: Optional[int] = None):
        if batch_rows < 1:
            raise ValueError("batch_rows must be >= 1")
        self._log = log
        self.batch_rows = int(batch_rows)
        self._max = max_windows
        self._start = 0
        self._stream: Optional[Iterator[Any]] = None

    def _plain_stream(self) -> Iterator[Any]:
        """ONE cached iterator over a non-restorable source: seek and
        iteration must share it — discarding from a throwaway
        ``iter()`` of a re-iterable (list/tuple) source would lose the
        position silently and re-train old windows under shifted
        indices."""
        if self._stream is None:
            self._stream = iter(self._log)
        return self._stream

    def seek(self, rows: int) -> None:
        if rows % self.batch_rows:
            raise ValueError(
                f"seek({rows}) is not a multiple of batch_rows="
                f"{self.batch_rows}: window-granular streams only "
                "reposition at window boundaries")
        idx = rows // self.batch_rows
        if hasattr(self._log, "restore"):
            self._log.restore({"consumed": idx})
        else:
            # plain iterable: discard-to-position on the SHARED stream
            # (a live source's consumed windows are gone regardless);
            # seeking backward cannot be honored — fail loudly
            if idx < self._start:
                raise ValueError(
                    f"seek({rows}) rewinds a non-restorable source "
                    f"(position {self._start * self.batch_rows}); wrap "
                    "the feed in a WindowLog for replayable resume")
            it = self._plain_stream()
            for _ in range(idx - self._start):
                if next(it, None) is None:
                    break
        self._start = idx

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        pos = self._start
        src = (self._log if hasattr(self._log, "restore")
               else self._plain_stream())
        for window in src:
            if self._max is not None and pos >= self._max:
                return
            if window.num_rows != self.batch_rows:
                raise ValueError(
                    f"window {pos} carries {window.num_rows} rows, the "
                    f"training stream is pinned to batch_rows="
                    f"{self.batch_rows}; continuous fits need a fixed "
                    "window grid (re-window the source)")
            pos += 1
            yield window.to_dict()