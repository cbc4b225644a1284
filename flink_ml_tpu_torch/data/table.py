"""Columnar in-memory Table — the framework's data substrate.

The reference stages exchange lazy Flink ``Table``s over a streaming engine.
The substrate here is a host-resident **columnar batch**: named numpy
columns of equal length, cheap to slice into batches and to copy to the
device as tensors.  Vector-valued columns are plain 2-D arrays, so the whole
feature matrix moves to the card without row-wise marshalling.

A copy of the JAX package's ``data/table.py``; bounded streams map to a
Table (all rows known).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Table"]


class Table:
    """An ordered mapping ``name -> column`` where every column is a numpy
    array with the same leading dimension (rows)."""

    def __init__(self, columns: Mapping[str, Any]):
        cols: Dict[str, np.ndarray] = {}
        num_rows: Optional[int] = None
        for name, values in columns.items():
            arr = np.asarray(values)
            if arr.ndim == 0:
                raise ValueError(f"Column {name!r} must be at least 1-D")
            if num_rows is None:
                num_rows = arr.shape[0]
            elif arr.shape[0] != num_rows:
                raise ValueError(
                    f"Column {name!r} has {arr.shape[0]} rows, expected {num_rows}")
            cols[name] = arr
        self._columns = cols
        self._num_rows = num_rows or 0

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_rows(rows: Iterable[Sequence[Any]], names: Sequence[str]) -> "Table":
        """Build from row tuples (the shape of the reference's
        ``tEnv.fromDataStream`` test fixtures, e.g. ``KMeansTest.java:58-66``)."""
        rows = list(rows)
        columns: Dict[str, List[Any]] = {n: [] for n in names}
        for row in rows:
            if len(row) != len(names):
                raise ValueError(f"Row {row!r} does not match schema {names!r}")
            for name, value in zip(names, row):
                columns[name].append(value)
        return Table({n: np.asarray(v) for n, v in columns.items()})

    @staticmethod
    def empty_like(other: "Table") -> "Table":
        return Table({n: c[:0] for n, c in other._columns.items()})

    # -- schema -------------------------------------------------------------
    @property
    def column_names(self) -> List[str]:
        return list(self._columns.keys())

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def schema(self) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
        return {n: (c.shape[1:], c.dtype) for n, c in self._columns.items()}

    # -- access -------------------------------------------------------------
    def column(self, name: str) -> np.ndarray:
        if name not in self._columns:
            raise KeyError(
                f"No column {name!r}; available: {self.column_names}")
        return self._columns[name]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.column(name)

    def rows(self) -> Iterator[Tuple[Any, ...]]:
        names = self.column_names
        for i in range(self._num_rows):
            yield tuple(self._columns[n][i] for n in names)

    # -- transformation -----------------------------------------------------
    def select(self, *names: str) -> "Table":
        return Table({n: self.column(n) for n in names})

    def with_column(self, name: str, values: Any) -> "Table":
        cols = dict(self._columns)
        cols[name] = np.asarray(values)
        return Table(cols)

    def drop(self, *names: str) -> "Table":
        return Table({n: c for n, c in self._columns.items() if n not in names})

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(n, n): c for n, c in self._columns.items()})

    def take(self, n: int) -> "Table":
        return Table({name: c[:n] for name, c in self._columns.items()})

    def slice(self, start: int, stop: int) -> "Table":
        return Table({name: c[start:stop] for name, c in self._columns.items()})

    def select_rows(self, indices: Any) -> "Table":
        """Row subset/reorder by integer index array (or boolean mask)."""
        idx = np.asarray(indices)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        return Table({name: c[idx] for name, c in self._columns.items()})

    def shuffle(self, seed: int = 0) -> "Table":
        perm = np.random.default_rng(seed).permutation(self._num_rows)
        return Table({name: c[perm] for name, c in self._columns.items()})

    def concat(self, other: "Table") -> "Table":
        if set(self.column_names) != set(other.column_names):
            raise ValueError("Cannot concat tables with different schemas")
        return Table({
            n: np.concatenate([c, other.column(n)], axis=0)
            for n, c in self._columns.items()
        })

    # -- batching / sharding ------------------------------------------------
    def pad_to_multiple(self, multiple: int) -> Tuple["Table", np.ndarray]:
        """Pad rows (repeating row 0) so num_rows % multiple == 0; returns the
        padded table plus a float mask (1 for real rows).  Fixed shapes let
        one kernel launch configuration serve every batch."""
        from ..utils.padding import pad_rows_with_mask

        mask = np.ones((self._num_rows,), dtype=np.float32)
        cols = {}
        for n, c in self._columns.items():
            cols[n], mask = pad_rows_with_mask(c, multiple)
        if not cols:
            return self, mask
        return Table(cols), mask

    def batches(self, batch_size: int, *, drop_remainder: bool = False
                ) -> Iterator["Table"]:
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        for start in range(0, self._num_rows, batch_size):
            batch = self.slice(start, min(start + batch_size, self._num_rows))
            if drop_remainder and batch.num_rows < batch_size:
                return
            yield batch

    def to_dict(self) -> Dict[str, np.ndarray]:
        return dict(self._columns)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        schema = ", ".join(
            f"{n}:{c.dtype.name}{list(c.shape[1:]) if c.ndim > 1 else ''}"
            for n, c in self._columns.items())
        return f"Table[{self._num_rows} rows; {schema}]"
