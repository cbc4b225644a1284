"""Host-side segmented epoch cache — out-of-core data for iterations.

Capability mirror of the reference's data cache (SURVEY §2.7):
- ``DataCacheWriter`` (``datacache/nonkeyed/DataCacheWriter.java:36-145``):
  append-only segmented log, here of **columnar array batches** instead of
  serialized records — batches land on disk as raw column byte ranges so a
  reader hands zero-copy memmap slices to the decode and the transfer.
- ``DataCacheReader`` (``DataCacheReader.java:35-139``): an iterator over
  fixed-size row batches, resumable from a cursor (the reference's
  ``(segmentIdx, offset)`` becomes a global row position), with native
  readahead of the next batch (posix_fadvise via native/datacache.cpp) so
  the device does not wait on disk.
- ``DataCacheSnapshot`` (``DataCacheSnapshot.java:50-224``): persists either
  segment paths (shared filesystem) or embedded bytes into a checkpoint
  directory; ``recover`` rebuilds local segments from embedded bytes.

The native library loads through :mod:`flink_ml_tpu_torch.utils.native_lib`
(``native/build/libdatacache.so``, shared with the JAX package); every
operation falls back to pure numpy/memmap when it is unavailable.  A copy
of the JAX package's ``data/datacache.py`` (host-only): a cache written by
either package reads batch for batch in the other.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.native_lib import load_native_lib

__all__ = ["DataCacheWriter", "DataCacheReader", "DataCacheSnapshot", "Segment"]


def _col_filename(name: str) -> str:
    """THE column file naming scheme — writer, reader and snapshot all
    resolve through here."""
    return f"col.{name}.bin"

_LIB = None
_LIB_TRIED = False


def _native_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native IO library; None -> fallback."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    lib = load_native_lib("datacache")
    if lib is not None:
        lib.dc_read.restype = ctypes.c_int64
        lib.dc_read.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_void_p]
        lib.dc_write.restype = ctypes.c_int64
        lib.dc_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int]
        lib.dc_file_size.restype = ctypes.c_int64
        lib.dc_file_size.argtypes = [ctypes.c_char_p]
        lib.dc_prefetch.restype = None
        lib.dc_prefetch.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64]
        lib.dc_prefetch_drain.restype = None
        lib.dc_prefetch_pending.restype = ctypes.c_int64
    _LIB = lib
    return _LIB


class Segment:
    """One on-disk segment: a directory of per-column raw binary files +
    rows count (the analog of ``Segment(path, count, size)``,
    ``datacache/nonkeyed/Segment.java``)."""

    def __init__(self, directory: str, rows: int,
                 schema: Dict[str, Tuple[Tuple[int, ...], str]]):
        self.directory = directory
        self.rows = rows
        self.schema = schema  # name -> (row_shape, dtype_str)

    def column_path(self, name: str) -> str:
        return os.path.join(self.directory, _col_filename(name))

    def nbytes(self) -> int:
        total = 0
        for name, (shape, dtype) in self.schema.items():
            row = int(np.prod(shape, dtype=np.int64)) if shape else 1
            total += self.rows * row * np.dtype(dtype).itemsize
        return total

    def to_json(self) -> Dict[str, Any]:
        return {"directory": self.directory, "rows": self.rows,
                "schema": {k: [list(s), d] for k, (s, d) in self.schema.items()}}

    @staticmethod
    def from_json(doc: Dict[str, Any]) -> "Segment":
        schema = {k: (tuple(s), d) for k, (s, d) in doc["schema"].items()}
        return Segment(doc["directory"], int(doc["rows"]), schema)


class DataCacheWriter:
    """Append columnar batches; rotate segments at ``segment_rows``.

    ``workers > 1`` writes whole segments on a background thread pool
    (the reference's data plane writes with operator parallelism P,
    ``Iterations.java:188-209``; here the analog is segment-parallel
    pwrite, which overlaps disk IO with the producer's parse/decode and
    scales on multi-queue storage).  Batches buffer in memory until a
    segment fills, bounded to ``workers + 2`` segments in flight; the
    manifest still lists segments in arrival order, so the reader's view
    is identical for any worker count."""

    def __init__(self, directory: str, segment_rows: int = 1 << 20,
                 workers: int = 1, borrow_batches: bool = False):
        if segment_rows <= 0:
            raise ValueError("segment_rows must be positive")
        if workers < 1:
            raise ValueError("workers must be >= 1")
        # borrow_batches=True skips the defensive copy the parallel path
        # otherwise makes of every buffered slice: valid ONLY when the
        # producer never mutates a batch after append() (e.g. it yields
        # fresh arrays, like CriteoTSVReader) — on a single core the copy
        # costs more than the write overlap buys.  Note: borrowed slices
        # are VIEWS, so each in-flight segment pins its producer arrays'
        # full base buffers until the background write lands — peak RSS
        # scales with the producer's chunk size, not just segment size.
        self._borrow = borrow_batches
        self.directory = directory
        self.segment_rows = segment_rows
        os.makedirs(directory, exist_ok=True)
        # Refuse a dirty directory: appending after a previous run's bytes
        # would silently serve stale leading rows (the reference likewise
        # refuses to overwrite existing persistence paths).
        leftovers = [name for name in os.listdir(directory)
                     if name.startswith("seg-") or name == "manifest.json"]
        if leftovers:
            raise ValueError(
                f"Cache directory {directory!r} already contains "
                f"{sorted(leftovers)[:3]}...; use a fresh directory")
        self._schema: Optional[Dict[str, Tuple[Tuple[int, ...], str]]] = None
        self._segments: List[Segment] = []
        self._current_rows = 0
        self._current_dir: Optional[str] = None
        self._finished = False
        self._broken = False
        self._workers = workers
        self._pool = None
        self._futures: List = []        # (segment_index, Future[Segment])
        self._pending: List = []        # buffered arrays for current seg
        self._pending_rows = 0
        self._next_seg = 0
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="datacache-write")

    def _check_schema(self, batch: Dict[str, np.ndarray]) -> None:
        schema = {name: (tuple(arr.shape[1:]), str(arr.dtype))
                  for name, arr in batch.items()}
        if self._schema is None:
            self._schema = schema
        elif schema != self._schema:
            raise ValueError(
                f"Batch schema {schema} does not match cache schema "
                f"{self._schema}")

    def _open_segment(self) -> None:
        idx = len(self._segments)
        self._current_dir = os.path.join(self.directory, f"seg-{idx:05d}")
        os.makedirs(self._current_dir, exist_ok=True)
        self._current_rows = 0

    def _rotate(self) -> None:
        if self._current_dir is not None and self._current_rows > 0:
            self._segments.append(
                Segment(self._current_dir, self._current_rows, self._schema))
        self._current_dir = None

    def append(self, batch: Dict[str, Any]) -> None:
        if self._finished:
            raise RuntimeError("writer already finished")
        if self._broken:
            raise RuntimeError(
                "writer is broken: a previous append failed mid-write, the "
                "current segment may hold partial column bytes")
        batch = {k: np.ascontiguousarray(v) for k, v in batch.items()}
        rows = next(iter(batch.values())).shape[0]
        for name, arr in batch.items():
            if arr.shape[0] != rows:
                raise ValueError("Ragged batch: columns disagree on rows")
        self._check_schema(batch)
        if self._pool is not None:
            self._append_parallel(batch, rows)
            return

        written = 0
        lib = _native_lib()
        try:
            while written < rows:
                if self._current_dir is None:
                    self._open_segment()
                take = min(rows - written,
                           self.segment_rows - self._current_rows)
                for name, arr in batch.items():
                    chunk = np.ascontiguousarray(arr[written:written + take])
                    path = self.column_path_for_current(name)
                    if lib is not None:
                        r = lib.dc_write(path.encode(), chunk.ctypes.data,
                                         chunk.nbytes, 1)
                        if r != chunk.nbytes:
                            raise IOError(f"native write failed for {path}")
                    else:
                        with open(path, "ab") as f:
                            f.write(chunk.tobytes())
                written += take
                self._current_rows += take
                if self._current_rows >= self.segment_rows:
                    self._rotate()
        except Exception:
            # Columns written before the failing one hold partial bytes for
            # this chunk; retrying would silently shift every later row.
            self._broken = True
            raise

    def column_path_for_current(self, name: str) -> str:
        return os.path.join(self._current_dir, _col_filename(name))

    # -- segment-parallel path (workers > 1) -------------------------------

    def _append_parallel(self, batch: Dict[str, np.ndarray],
                         rows: int) -> None:
        written = 0
        while written < rows:
            take = min(rows - written, self.segment_rows - self._pending_rows)
            # COPY the slice (unless borrowing): append() returns before
            # the background write runs, so a view into a caller-reused
            # buffer would let the next batch's bytes land in this segment
            self._pending.append(
                {k: (v[written:written + take] if self._borrow
                     else v[written:written + take].copy())
                 for k, v in batch.items()})
            self._pending_rows += take
            written += take
            if self._pending_rows >= self.segment_rows:
                self._submit_segment()

    def _submit_segment(self) -> None:
        if not self._pending_rows:
            return
        seg_idx = self._next_seg
        self._next_seg += 1
        parts, rows = self._pending, self._pending_rows
        self._pending, self._pending_rows = [], 0
        # backpressure: bound in-flight segments (memory = buffered
        # arrays); block on the OLDEST unfinished write, pruning finished
        # futures so neither the list nor the wait degenerates
        pending = [(i, f) for i, f in self._futures if not f.done()]
        done = [(i, f) for i, f in self._futures if f.done()]
        try:
            for _, f in done:
                f.result()   # surface write errors promptly
            self._futures = done + pending  # keep results for finish()
            while len(pending) >= self._workers + 2:
                pending[0][1].result()
                pending = [(i, f) for i, f in pending if not f.done()]
        except Exception:
            # same contract as the serial path: a failed segment write
            # leaves partial column bytes on disk — refuse retries
            self._broken = True
            raise
        self._futures.append(
            (seg_idx, self._pool.submit(self._write_segment, seg_idx,
                                        parts, rows)))

    def _write_segment(self, seg_idx: int, parts: List[Dict[str, np.ndarray]],
                       rows: int) -> Segment:
        seg_dir = os.path.join(self.directory, f"seg-{seg_idx:05d}")
        os.makedirs(seg_dir, exist_ok=True)
        lib = _native_lib()
        for name in self._schema:
            path = os.path.join(seg_dir, _col_filename(name))
            if lib is not None:
                for part in parts:
                    chunk = np.ascontiguousarray(part[name])
                    r = lib.dc_write(path.encode(), chunk.ctypes.data,
                                     chunk.nbytes, 1)
                    if r != chunk.nbytes:
                        raise IOError(f"native write failed for {path}")
            else:
                with open(path, "ab") as f:
                    for part in parts:
                        f.write(np.ascontiguousarray(part[name]).tobytes())
        return Segment(seg_dir, rows, self._schema)

    def finish(self) -> List[Segment]:
        """Seal the cache and write the manifest
        (``DataCacheWriter.finish``)."""
        if not self._finished:
            if self._pool is not None:
                self._submit_segment()
                try:
                    segs = {i: f.result() for i, f in self._futures}
                except Exception:
                    self._broken = True
                    self._pool.shutdown(wait=True)
                    raise
                self._pool.shutdown(wait=True)
                self._segments = [segs[i] for i in sorted(segs)]
            else:
                self._rotate()
            self._finished = True
            manifest = {
                "segments": [s.to_json() for s in self._segments],
                "schema": ({k: [list(s), d]
                            for k, (s, d) in self._schema.items()}
                           if self._schema else {}),
            }
            with open(os.path.join(self.directory, "manifest.json"), "w") as f:
                json.dump(manifest, f)
        return list(self._segments)


def load_segments(directory: str) -> List[Segment]:
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    return [Segment.from_json(doc) for doc in manifest["segments"]]


class DataCacheReader:
    """Iterate fixed-size row batches across segments; resumable via the
    ``cursor`` property (global row index).  With the native library, the
    next batch's byte ranges are prefetched into page cache while the caller
    consumes the current one."""

    def __init__(self, source, batch_rows: int, cursor: int = 0,
                 prefetch: bool = True):
        if batch_rows <= 0:
            raise ValueError("batch_rows must be positive")
        self.segments = (load_segments(source) if isinstance(source, str)
                         else list(source))
        if not self.segments:
            raise ValueError("DataCacheReader got an empty cache")
        self.batch_rows = batch_rows
        self.total_rows = sum(s.rows for s in self.segments)
        if not 0 <= cursor <= self.total_rows:
            raise ValueError(f"cursor {cursor} out of range "
                             f"[0, {self.total_rows}]")
        self._cursor = cursor
        self._prefetch = prefetch
        self._maps: Dict[Tuple[int, str], np.memmap] = {}

    @property
    def cursor(self) -> int:
        return self._cursor

    def seek(self, cursor: int) -> None:
        if not 0 <= cursor <= self.total_rows:
            raise ValueError(f"cursor {cursor} out of range")
        self._cursor = cursor

    def _segment_at(self, row: int) -> Tuple[int, int]:
        """global row -> (segment index, row within segment)."""
        offset = row
        for i, seg in enumerate(self.segments):
            if offset < seg.rows:
                return i, offset
            offset -= seg.rows
        return len(self.segments) - 1, self.segments[-1].rows

    def _column_map(self, seg_idx: int, name: str) -> np.memmap:
        key = (seg_idx, name)
        if key not in self._maps:
            seg = self.segments[seg_idx]
            shape, dtype = seg.schema[name]
            self._maps[key] = np.memmap(
                seg.column_path(name), dtype=np.dtype(dtype), mode="r",
                shape=(seg.rows,) + shape)
        return self._maps[key]

    def _prefetch_range(self, start_row: int, rows: int) -> None:
        lib = _native_lib()
        if lib is None or rows <= 0 or start_row >= self.total_rows:
            return
        seg_idx, in_seg = self._segment_at(start_row)
        remaining = min(rows, self.total_rows - start_row)
        while remaining > 0 and seg_idx < len(self.segments):
            seg = self.segments[seg_idx]
            take = min(remaining, seg.rows - in_seg)
            for name, (shape, dtype) in seg.schema.items():
                row_bytes = (int(np.prod(shape, dtype=np.int64)) if shape
                             else 1) * np.dtype(dtype).itemsize
                lib.dc_prefetch(seg.column_path(name).encode(),
                                in_seg * row_bytes, take * row_bytes)
            remaining -= take
            seg_idx += 1
            in_seg = 0

    def read_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """Next batch (dict of arrays, <= batch_rows on the tail), advancing
        the cursor; None at end of cache."""
        if self._cursor >= self.total_rows:
            return None
        rows = min(self.batch_rows, self.total_rows - self._cursor)
        out: Dict[str, List[np.ndarray]] = {}
        start = self._cursor
        seg_idx, in_seg = self._segment_at(start)
        remaining = rows
        while remaining > 0:
            seg = self.segments[seg_idx]
            take = min(remaining, seg.rows - in_seg)
            for name in seg.schema:
                out.setdefault(name, []).append(
                    np.asarray(self._column_map(seg_idx, name)
                               [in_seg:in_seg + take]))
            remaining -= take
            seg_idx += 1
            in_seg = 0
        self._cursor += rows
        if self._prefetch:
            self._prefetch_range(self._cursor, self.batch_rows)
        return {name: (parts[0] if len(parts) == 1
                       else np.concatenate(parts, axis=0))
                for name, parts in out.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            batch = self.read_batch()
            if batch is None:
                return
            yield batch

    # Stream-source protocol for iterate() checkpointing (the analog of
    # ReplayOperator snapshotting its reader position).
    def snapshot(self) -> Dict[str, Any]:
        return {"cursor": self._cursor}

    def restore(self, snap: Dict[str, Any]) -> None:
        self.seek(int(snap["cursor"]))


class ShuffledCacheReader:
    """Per-epoch block-shuffled view over a data cache — the documented
    "vary segment order per epoch" posture for out-of-core SGD, packaged
    with exact resume.

    Full fixed-size row blocks of ``batch_rows`` are visited in a seeded
    permutation of ``(seed, epoch)``; the trailing partial block (if any)
    is always visited last so batch shapes stay static for the one
    compiled step program.  Construct one per epoch — pass an
    epoch-aware ``make_reader(epoch=...)`` to ``sgd_fit_outofcore`` and
    it supplies the epoch, which keeps the permutation reconstructible
    on checkpoint resume (the cursor protocol's ``seek`` jumps to a
    VISIT position, ``cursor // batch_rows``, not a file offset — the
    permutation plus the visit index IS the stream position).

    ``epoch_varying = True`` declares the per-epoch variance to
    ``sgd_fit_outofcore``'s decoded replay cache — a one-batch digest
    guard cannot prove a permutation identical (two epochs can lead
    with the same block yet differ after it), so declaring beats
    detecting.  ``block_order`` additionally makes the stream
    BLOCK-ADDRESSABLE: the i-th yielded batch is block
    ``block_order[i]``, and a given block's rows (hence its decoded
    form) are identical in every epoch — the contract the streamer's
    block-keyed decode cache relies on to give per-epoch reshuffling
    AND decode-once together.

    Shuffling defeats the sequential fadvise readahead, so each read
    prefetches the NEXT visit's block instead."""

    epoch_varying = True

    def __init__(self, source, batch_rows: int, *, seed: int = 0,
                 epoch: int = 0, prefetch: bool = True):
        self._inner = DataCacheReader(source, batch_rows=batch_rows,
                                      prefetch=False)
        self.batch_rows = batch_rows
        self.total_rows = self._inner.total_rows
        self._do_prefetch = prefetch
        full = self.total_rows // batch_rows
        order = np.random.default_rng(
            np.random.SeedSequence([int(seed), int(epoch)])
        ).permutation(full)
        if self.total_rows % batch_rows:
            order = np.concatenate([order, [full]])
        self._order = order.astype(np.int64)
        self._visit = 0

    @property
    def block_order(self) -> Tuple[int, ...]:
        """This epoch's visit order: the i-th yielded batch is block
        ``block_order[i]`` (block b = rows ``[b*batch_rows,
        (b+1)*batch_rows)`` of the cache, ragged block last)."""
        return tuple(int(b) for b in self._order)

    @property
    def cursor(self) -> int:
        """Rows handed out so far (visit position x batch_rows, capped)."""
        return min(self._visit * self.batch_rows, self.total_rows)

    def seek(self, cursor: int) -> None:
        if not 0 <= cursor <= self.total_rows:
            raise ValueError(f"cursor {cursor} out of range")
        if cursor < self.total_rows and cursor % self.batch_rows:
            # this class's cursor protocol only ever produces visit
            # boundaries (or total_rows); silently flooring an arbitrary
            # row position would drop up to batch_rows-1 rows
            raise ValueError(
                f"cursor {cursor} is not a visit boundary (multiple of "
                f"batch_rows={self.batch_rows}) or total_rows; "
                "ShuffledCacheReader seeks by whole visits")
        self._visit = (len(self._order) if cursor >= self.total_rows
                       else cursor // self.batch_rows)

    def read_batch(self) -> Optional[Dict[str, np.ndarray]]:
        if self._visit >= len(self._order):
            return None
        block = int(self._order[self._visit])
        self._inner.seek(block * self.batch_rows)
        batch = self._inner.read_batch()
        self._visit += 1
        if self._do_prefetch and self._visit < len(self._order):
            nxt = int(self._order[self._visit])
            self._inner._prefetch_range(nxt * self.batch_rows,
                                        self.batch_rows)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            batch = self.read_batch()
            if batch is None:
                return
            yield batch

    def snapshot(self) -> Dict[str, Any]:
        return {"cursor": self.cursor}

    def restore(self, snap: Dict[str, Any]) -> None:
        self.seek(int(snap["cursor"]))


class DataCacheSnapshot:
    """Persist/recover a cache into a checkpoint directory
    (``DataCacheSnapshot.java:50-224``): path-only references when the cache
    is on a shared filesystem, embedded bytes otherwise."""

    @staticmethod
    def write(segments: List[Segment], target: str, *,
              embed: bool = False, cursor: int = 0) -> None:
        os.makedirs(target, exist_ok=True)
        doc = {
            "embed": embed,
            "cursor": cursor,
            "segments": [s.to_json() for s in segments],
        }
        if embed:
            payload_dir = os.path.join(target, "payload")
            os.makedirs(payload_dir, exist_ok=True)
            for i, seg in enumerate(segments):
                for name in seg.schema:
                    shutil.copyfile(
                        seg.column_path(name),
                        os.path.join(payload_dir, f"{i:05d}." + _col_filename(name)))
        with open(os.path.join(target, "snapshot.json"), "w") as f:
            json.dump(doc, f)

    @staticmethod
    def recover(target: str, restore_dir: Optional[str] = None
                ) -> Tuple[List[Segment], int]:
        with open(os.path.join(target, "snapshot.json")) as f:
            doc = json.load(f)
        segments = [Segment.from_json(d) for d in doc["segments"]]
        if doc["embed"]:
            if restore_dir is None:
                raise ValueError("embedded snapshot needs a restore_dir")
            os.makedirs(restore_dir, exist_ok=True)
            restored = []
            for i, seg in enumerate(segments):
                seg_dir = os.path.join(restore_dir, f"seg-{i:05d}")
                os.makedirs(seg_dir, exist_ok=True)
                for name in seg.schema:
                    shutil.copyfile(
                        os.path.join(target, "payload",
                                     f"{i:05d}." + _col_filename(name)),
                        os.path.join(seg_dir, _col_filename(name)))
                restored.append(Segment(seg_dir, seg.rows, seg.schema))
            segments = restored
        return segments, int(doc["cursor"])
