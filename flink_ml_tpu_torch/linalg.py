"""Minimal linear-algebra surface: dense/sparse vectors + factories.

Mirror of ``flink-ml-api/.../linalg/`` (``DenseVector.java:27-67``,
``Vectors.java``).  On the device a "vector" is just a row of a batched 2-D array;
these classes exist for API parity (single-row construction, save/load of
model data) and normalise everything to numpy float64 on the host, with
conversion helpers to device-friendly dtypes.

The reference's custom serializer (``DenseVectorSerializer.java``) is
replaced by npz persistence in :mod:`flink_ml_tpu_torch.utils.persist`.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence, Union

import numpy as np

__all__ = ["Vector", "DenseVector", "SparseVector", "Vectors",
           "stack_vectors", "stack_sparse_vectors"]


class Vector:
    """Abstract vector contract (``linalg/Vector.java``): size/get/to_array."""

    def size(self) -> int:
        raise NotImplementedError

    def get(self, i: int) -> float:
        raise NotImplementedError

    def to_array(self) -> np.ndarray:
        raise NotImplementedError


class DenseVector(Vector):
    """Dense double vector (``linalg/DenseVector.java:27-67``)."""

    __slots__ = ("values",)

    def __init__(self, values: Union[Sequence[float], np.ndarray]):
        self.values = np.asarray(values, dtype=np.float64).reshape(-1)

    def size(self) -> int:
        return int(self.values.shape[0])

    def get(self, i: int) -> float:
        return float(self.values[i])

    def to_array(self) -> np.ndarray:
        return self.values

    def __array__(self, dtype=None):
        return self.values if dtype is None else self.values.astype(dtype)

    def __len__(self) -> int:
        return self.size()

    def __getitem__(self, i: int) -> float:
        return float(self.values[i])

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, DenseVector) and np.array_equal(
            self.values, other.values)

    def __hash__(self) -> int:
        return hash(self.values.tobytes())

    def __repr__(self) -> str:
        return f"DenseVector({self.values.tolist()})"


class SparseVector(Vector):
    """COO sparse vector — not present in the reference snapshot but part of
    the Flink ML linalg surface; provided for completeness.  Densifies for
    device compute."""

    __slots__ = ("n", "indices", "values")

    def __init__(self, n: int, indices: Sequence[int], values: Sequence[float]):
        self.n = int(n)
        self.indices = np.asarray(indices, dtype=np.int64).reshape(-1)
        self.values = np.asarray(values, dtype=np.float64).reshape(-1)
        if self.indices.shape != self.values.shape:
            raise ValueError("indices and values must have the same length")
        if self.indices.size and (self.indices.min() < 0
                                  or self.indices.max() >= self.n):
            raise ValueError("index out of range")

    def size(self) -> int:
        return self.n

    def get(self, i: int) -> float:
        hits = np.nonzero(self.indices == i)[0]
        return float(self.values[hits[0]]) if hits.size else 0.0

    def to_array(self) -> np.ndarray:
        dense = np.zeros((self.n,), dtype=np.float64)
        dense[self.indices] = self.values
        return dense

    def to_dense(self) -> DenseVector:
        return DenseVector(self.to_array())

    def __repr__(self) -> str:
        return (f"SparseVector(n={self.n}, indices={self.indices.tolist()}, "
                f"values={self.values.tolist()})")


class Vectors:
    """Factory methods (``linalg/Vectors.java``)."""

    @staticmethod
    def dense(*values: float) -> DenseVector:
        if len(values) == 1 and isinstance(values[0], (list, tuple, np.ndarray)):
            return DenseVector(values[0])
        return DenseVector(values)

    @staticmethod
    def sparse(n: int, indices: Sequence[int], values: Sequence[float]) -> SparseVector:
        return SparseVector(n, indices, values)


def stack_sparse_vectors(column: Iterable["SparseVector"],
                         nnz: int = 0) -> tuple:
    """Normalise a column of :class:`SparseVector` into the device-facing
    fixed-active-count form: ``(indices (n, nnz) int32, values (n, nnz)
    float32, dim)``.  Rows with fewer actives pad with ``(index 0, value
    0.0)`` — a zero value contributes nothing to any gather-based score or
    scatter-based gradient, so padding is free of masking.

    This is what makes the hashed high-dim path (Criteo-shape, 2^20+ dims)
    expressible: the dense ``stack_vectors`` form would materialise an
    ``(n, 2^20)`` matrix.  The device kernels want a fixed nnz (pass
    ``nnz`` to force a count >= the max actives; 0 = use the max)."""
    vecs = list(column)
    n = len(vecs)
    max_active = max((v.indices.shape[0] for v in vecs), default=0)
    if nnz <= 0:
        nnz = max(max_active, 1)
    elif max_active > nnz:
        raise ValueError(
            f"nnz={nnz} is smaller than the densest row ({max_active} "
            "active entries)")
    indices = np.zeros((n, nnz), np.int32)
    values = np.zeros((n, nnz), np.float32)
    dim = 0
    for i, v in enumerate(vecs):
        k = v.indices.shape[0]
        indices[i, :k] = v.indices
        values[i, :k] = v.values
        dim = max(dim, v.size())
    return indices, values, dim


def stack_vectors(column: Iterable[Any]) -> np.ndarray:
    """Normalise a features column (array of DenseVector / lists / 2-D array)
    into one contiguous ``(rows, dim)`` float array — the device-facing form."""
    if isinstance(column, np.ndarray) and column.dtype != object:
        arr = np.asarray(column, dtype=np.float64)
        # A 1-D numeric column is n scalar samples -> (n, 1), NOT one n-dim row.
        return arr.reshape(-1, 1) if arr.ndim == 1 else arr
    rows = [np.asarray(getattr(v, "values", v), dtype=np.float64).reshape(-1)
            for v in column]
    if not rows:
        return np.zeros((0, 0), dtype=np.float64)
    return np.stack(rows)
