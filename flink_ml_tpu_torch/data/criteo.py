"""Criteo-format TSV ingest: raw click logs -> the mixed training layout.

The BASELINE.md north star is Criteo-1TB LogisticRegression; this module
owns the first leg of that pipeline: parsing ``label \\t I1..I13 \\t
C1..C26`` lines into the framework's mixed convention (13 dense f32
slots + 26 hashed categorical int32 slots with implicit value 1.0): the
``{col}_dense`` + ``{col}_indices`` columns a linear estimator's ``fit``
takes as the mixed layout.

Parsing runs through ``native/criteo.cpp`` (one pass over a byte chunk,
FNV-1a hashing folded in) with a bit-identical pure-Python fallback where
the native library cannot be built (:func:`parser_name` says which one
runs).
Categorical tokens hash as ``C{field}={token}`` — the FeatureHasher salt
convention — into ``[n_reserved, n_reserved + hash_space)`` so hashed
slots can never alias the dense weight slots.  Empty categorical fields
hash the empty token, giving each field a stable "missing" slot.

A copy of the JAX package's ``data/criteo.py`` (host code; it loads the
same native library through this package's ``utils/native_lib.py``).  A
:class:`CriteoTSVReader` feeds a linear estimator's
``fit_outofcore(reader_factory, num_features=..., mixed=True)`` batch by
batch (its batches carry ``{col}_dense`` / ``{col}_indices`` / ``label``),
or its batches concatenate into a
:class:`~flink_ml_tpu_torch.data.table.Table` for ``fit``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..utils.native_lib import load_native_lib

__all__ = ["CriteoTSVReader", "parse_chunk", "parser_name"]

N_DENSE = 13
N_CAT = 26

_FNV_OFFSET = 14695981039346656037
_FNV_PRIME = 1099511628211
_FNV_MASK = (1 << 64) - 1


def _fnv1a_bytes(data: bytes, h: int = _FNV_OFFSET) -> int:
    """Raw-bytes FNV-1a (matches ``text._fnv1a`` on ASCII, and matches the
    native parser on arbitrary bytes — no utf-8 round-trip that could
    raise on undecodable tokens)."""
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _FNV_MASK
    return h


_CAT_SALTS = [_fnv1a_bytes(b"C%d=" % (f + 1)) for f in range(N_CAT)]


def _int_field(raw: bytes) -> float:
    """The native parser's integer rules, exactly: optional '-', then
    digits only; empty, non-digit, or > 18 digits -> 0.0."""
    if not raw:
        return 0.0
    neg = raw[:1] == b"-"
    body = raw[1:] if neg else raw
    if not body.isdigit() or len(body) > 18:
        return 0.0
    v = int(body)
    return float(-v if neg else v) if v else 0.0

_LIB = None
_LIB_TRIED = False


def _native_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    lib = load_native_lib("criteo")
    if lib is not None:
        lib.ct_parse.restype = ctypes.c_int64
        lib.ct_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
    _LIB = lib
    return _LIB


def parser_name() -> str:
    """``"native"`` where ``native/criteo.cpp`` is built and loaded, else
    ``"python"`` (the bit-identical fallback)."""
    return "native" if _native_lib() is not None else "python"


def _py_parse_chunk(data: bytes, max_rows: int, hash_space: int,
                    n_reserved: int):
    """Pure-Python twin of ``ct_parse`` (bit-identical output)."""
    dense = np.zeros((max_rows, N_DENSE), np.float32)
    cat = np.zeros((max_rows, N_CAT), np.int32)
    label = np.zeros((max_rows,), np.float32)
    rows = 0
    consumed = 0
    pos = 0
    while rows < max_rows:
        eol = data.find(b"\n", pos)
        if eol < 0:
            break
        fields = data[pos:eol].split(b"\t")
        if len(fields) == 40:
            label[rows] = 1.0 if fields[0][:1] == b"1" else 0.0
            for f in range(N_DENSE):
                dense[rows, f] = _int_field(fields[1 + f])
            for f in range(N_CAT):
                h = _fnv1a_bytes(fields[14 + f], _CAT_SALTS[f])
                cat[rows, f] = n_reserved + (h % hash_space)
            rows += 1
        pos = eol + 1
        consumed = pos
    return dense[:rows], cat[:rows], label[:rows], consumed


def parse_chunk(data: bytes, max_rows: int, hash_space: int,
                n_reserved: int = N_DENSE
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Parse whole lines from ``data`` (up to ``max_rows``); returns
    (dense (r, 13) f32, cat (r, 26) int32, label (r,) f32, bytes_consumed).
    A trailing partial line is left unconsumed for the caller to carry
    into its next chunk."""
    if hash_space <= 0:
        raise ValueError(f"hash_space must be positive, got {hash_space}")
    if n_reserved + hash_space > 1 << 31:
        raise ValueError(
            f"n_reserved + hash_space = {n_reserved + hash_space} exceeds "
            "int32 index range (2^31); use a smaller hash space")
    lib = _native_lib()
    if lib is None:
        return _py_parse_chunk(data, max_rows, hash_space, n_reserved)
    dense = np.zeros((max_rows, N_DENSE), np.float32)
    cat = np.zeros((max_rows, N_CAT), np.int32)
    label = np.zeros((max_rows,), np.float32)
    consumed = ctypes.c_int64(0)
    rows = lib.ct_parse(data, len(data), max_rows, hash_space, n_reserved,
                        dense.ctypes.data, cat.ctypes.data,
                        label.ctypes.data, ctypes.byref(consumed))
    return dense[:rows], cat[:rows], label[:rows], int(consumed.value)


class CriteoTSVReader:
    """Iterator of mixed-layout batch dicts over one Criteo TSV file or a
    SEQUENCE of files (the Criteo-1TB corpus is day_0..day_23; they
    stream back-to-back in the given order, batches crossing file
    boundaries): ``{"{col}_dense": (b, 13) f32, "{col}_indices": (b, 26)
    int32, "label": (b,) f32}``: the mixed layout's columns.  Construct
    a fresh reader per pass.

    ``num_features`` for the downstream trainer is
    ``n_reserved + hash_space``.
    """

    def __init__(self, path: "str | bytes | os.PathLike | Sequence[str]",
                 batch_rows: int, hash_space: int,
                 n_reserved: int = N_DENSE, features_col: str = "features",
                 label_col: str = "label", chunk_bytes: int = 1 << 24,
                 workers: int = 0):
        if batch_rows <= 0:
            raise ValueError(f"batch_rows must be positive: {batch_rows}")
        # one path or a sequence (the Criteo-1TB corpus is day_0..day_23
        # files; they stream back-to-back in the given order)
        self.paths = ([path] if isinstance(path, (str, bytes, os.PathLike))
                      else list(path))
        if not self.paths:
            raise ValueError("need at least one path")
        self.batch_rows = batch_rows
        self.hash_space = hash_space
        self.n_reserved = n_reserved
        self.features_col = features_col
        self.label_col = label_col
        self.chunk_bytes = max(chunk_bytes, 1 << 12)
        # workers=0: auto (one parse thread per core beyond the first,
        # capped; 1-core hosts parse inline).  The reference's data plane
        # is parallel by construction — every operator runs at
        # parallelism P with P readers (``Iterations.java:188-209``);
        # here the analog is byte-range sharding of the day-files across
        # a thread pool (ct_parse releases the GIL through ctypes, so
        # threads scale on real cores).  Output order is DETERMINISTIC
        # (ranges re-assemble in file order) so cursor-based resume and
        # seeded shuffles stay exact regardless of worker count.
        if workers < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        self.workers = (min(8, max(1, (os.cpu_count() or 1) - 1))
                        if workers == 0 else workers)

    @property
    def num_features(self) -> int:
        return self.n_reserved + self.hash_space

    def _rows(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        if self.workers > 1:
            yield from self._rows_parallel()
            return
        for path in self.paths:
            yield from self._file_rows(path)

    # -- parallel range-sharded parse --------------------------------------

    def _range_tasks(self, range_bytes: int = 32 << 20):
        """Split the file set into byte-range tasks.  Range boundaries are
        arbitrary; each task starts after the first newline past its start
        (unless at file offset 0) and runs through the first newline past
        its end, so every line belongs to exactly one task."""
        for path in self.paths:
            size = os.path.getsize(path)
            start = 0
            while start < size:
                yield (path, start, min(start + range_bytes, size))
                start += range_bytes

    def _parse_range(self, path, start: int, end: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Parse [start, end)'s lines (ownership rule above) into one
        concatenated (dense, cat, label) triple."""
        ds, cs, ys = [], [], []
        with open(path, "rb") as f:
            f.seek(max(0, start - 1))
            tail = b""
            # a range owns lines whose FIRST byte lies in [start, end); if
            # byte start-1 is a newline, start IS a line start and nothing
            # is skipped
            at_line_start = start == 0 or f.read(1) == b"\n"
            f.seek(start)
            if not at_line_start:
                # skip the partial line owned by the previous range
                while True:
                    probe = f.read(1 << 16)
                    if not probe:
                        return (np.zeros((0, N_DENSE), np.float32),
                                np.zeros((0, N_CAT), np.int32),
                                np.zeros((0,), np.float32))
                    nl = probe.find(b"\n")
                    if nl >= 0:
                        start += nl + 1
                        break
                    start += len(probe)
                if start >= end:
                    # the whole range sat inside one line owned by the
                    # previous range
                    return (np.zeros((0, N_DENSE), np.float32),
                            np.zeros((0, N_CAT), np.int32),
                            np.zeros((0,), np.float32))
                f.seek(start)   # re-read from the owned line start
            pos_in_file = start
            while True:
                data = tail
                take = end - pos_in_file
                if take > 0:
                    chunk = f.read(min(self.chunk_bytes, take))
                    if chunk:
                        data = tail + chunk
                        pos_in_file += len(chunk)
                    else:
                        take = 0
                if take <= 0:
                    if not data:
                        break  # ended exactly on a line boundary
                    # past end: the tail may hold several complete (e.g.
                    # malformed-short) lines plus the range's owned final
                    # partial line.  Complete that last line by extending
                    # through the FIRST newline past the current bytes
                    # (never further — later lines belong to the next
                    # range), then drain everything.
                    if not data.endswith(b"\n"):
                        while True:
                            extra = f.read(1 << 16)
                            if not extra:   # EOF without trailing newline
                                data = (data + b"\n" if data.strip()
                                        else b"")
                                break
                            nl = extra.find(b"\n")
                            if nl >= 0:
                                data += extra[:nl + 1]
                                break
                            data += extra
                    pos = 0
                    while pos < len(data):
                        d, c, y, consumed = parse_chunk(
                            data[pos:], max(1, (len(data) - pos) // 40),
                            self.hash_space, self.n_reserved)
                        if consumed == 0:
                            break
                        pos += consumed
                        if len(y):
                            ds.append(d); cs.append(c); ys.append(y)
                    break
                max_rows = max(1, len(data) // 40)
                d, c, y, consumed = parse_chunk(
                    data, max_rows, self.hash_space, self.n_reserved)
                if len(y):
                    ds.append(d); cs.append(c); ys.append(y)
                tail = data[consumed:]
        if not ds:
            return (np.zeros((0, N_DENSE), np.float32),
                    np.zeros((0, N_CAT), np.int32),
                    np.zeros((0,), np.float32))
        return (np.concatenate(ds), np.concatenate(cs), np.concatenate(ys))

    def _rows_parallel(self
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]]:
        """Ordered assembly over a thread pool: a sliding window of
        in-flight range tasks bounds memory at ~2x workers ranges."""
        from concurrent.futures import ThreadPoolExecutor

        tasks = self._range_tasks()
        with ThreadPoolExecutor(max_workers=self.workers,
                                thread_name_prefix="criteo-parse") as pool:
            window: list = []
            for task in tasks:
                window.append(pool.submit(self._parse_range, *task))
                if len(window) >= 2 * self.workers:
                    dense, cat, label = window.pop(0).result()
                    if len(label):
                        yield dense, cat, label
            for fut in window:
                dense, cat, label = fut.result()
                if len(label):
                    yield dense, cat, label

    def _file_rows(self, path
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        tail = b""
        with open(path, "rb") as f:
            while True:
                chunk = f.read(self.chunk_bytes)
                if not chunk:
                    break
                data = tail + chunk
                pos = 0
                # drain the chunk in as few calls as possible: a Criteo
                # line is >= 40 bytes (40 separators), so len//40 rows
                # always covers the chunk — repeated small-batch calls
                # would re-slice (copy) the remaining bytes quadratically
                max_rows = max(self.batch_rows, len(data) // 40)
                while True:
                    dense, cat, label, consumed = parse_chunk(
                        data[pos:], max_rows, self.hash_space,
                        self.n_reserved)
                    if consumed == 0:   # no whole line left in the chunk
                        break
                    pos += consumed     # advances past skipped bad lines too
                    if len(label):
                        yield dense, cat, label
                tail = data[pos:]
        if tail.strip():
            # final line without trailing newline
            dense, cat, label, _ = parse_chunk(
                tail + b"\n", self.batch_rows, self.hash_space,
                self.n_reserved)
            if len(label):
                yield dense, cat, label

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        B = self.batch_rows
        pend_d, pend_c, pend_l = [], [], []
        pending = 0
        for dense, cat, label in self._rows():
            pend_d.append(dense)
            pend_c.append(cat)
            pend_l.append(label)
            pending += len(label)
            if pending < B:
                continue
            # concatenate ONCE, then emit offset slices: re-concatenating
            # the leftover per batch would copy O(remaining) per yield
            # (quadratic when a parse chunk holds many batches)
            d = np.concatenate(pend_d)
            c = np.concatenate(pend_c)
            y = np.concatenate(pend_l)
            off = 0
            while pending - off >= B:
                yield self._batch(d[off:off + B], c[off:off + B],
                                  y[off:off + B])
                off += B
            pend_d, pend_c, pend_l = [d[off:]], [c[off:]], [y[off:]]
            pending -= off
        if pending:
            yield self._batch(np.concatenate(pend_d),
                              np.concatenate(pend_c),
                              np.concatenate(pend_l))

    def _batch(self, dense, cat, label) -> Dict[str, np.ndarray]:
        return {
            f"{self.features_col}_dense": dense,
            f"{self.features_col}_indices": cat,
            self.label_col: label,
        }
