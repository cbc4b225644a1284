"""Row padding for fixed-shape batches: the helpers the port needs from the
JAX package's ``utils/padding.py`` (numpy only).

The port's CUDA kernels mask their ragged edge themselves and take any row
count; the block contracts stay for callers that pad on purpose (zero rows
the KMeans stats kernels tolerate, power-of-two predict buckets)."""

from __future__ import annotations

import threading

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["FixedRowBatcher", "pad_rows_with_mask", "bucket_rows",
           "bucket_sizes", "pad_rows_to_bucket", "pad_rows_to_block",
           "require_block_rows", "DEFAULT_MIN_BUCKET", "DEFAULT_BUCKET_CAP"]

#: Smallest row bucket the predict paths pad to.
DEFAULT_MIN_BUCKET = 8

#: Largest batch the predict paths bucket-pad; larger batches keep their
#: exact shape (padding them to the next power of two could double the
#: work and the peak memory).
DEFAULT_BUCKET_CAP = 1 << 16


class FixedRowBatcher:
    """The out-of-core fixed-row protocol of the streamed fits
    (``sgd_fit_outofcore``): the FIRST batch pins the row count
    (rounded up to ``multiple`` for data-axis divisibility), later
    batches must not grow, and short batches (the ragged tail) zero-pad
    — callers give padded rows weight/mask 0.

    Thread-safe: with multi-worker prefetch decode two first batches can
    race; the lock makes exactly one pin win (a mis-sized winner — only
    possible when a cursorless reader's final partial batch decodes
    first — still fails loudly as a growing batch)."""

    def __init__(self, multiple: int):
        if multiple <= 0:
            raise ValueError("multiple must be positive")
        self._multiple = multiple
        self._rows: list = []
        self._lock = threading.Lock()

    @property
    def rows(self) -> Optional[int]:
        return self._rows[0] if self._rows else None

    def pin(self, rows: int) -> None:
        """Pin the fixed row count (rounded up to the multiple); no-op if
        already pinned."""
        with self._lock:
            if not self._rows:
                self._rows.append(rows + (-rows) % self._multiple)

    def pad(self, arrays: Sequence[np.ndarray],
            have: Optional[int] = None) -> Tuple[np.ndarray, ...]:
        """Zero-pad every array's leading dim to the pinned row count
        (pinning from this batch if none is pinned yet)."""
        have = int(arrays[0].shape[0]) if have is None else int(have)
        self.pin(have)
        rows = self._rows[0]
        if have > rows:
            raise ValueError(
                f"reader produced a growing batch ({have} rows after "
                f"{rows}); fixed-size batches are required")
        if have == rows:
            return tuple(arrays)
        return tuple(
            np.concatenate(
                [a, np.zeros((rows - have,) + a.shape[1:], a.dtype)])
            for a in arrays)


def bucket_rows(n: int, *, min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """The power-of-two row bucket ``n`` rows pad to (floored at
    ``min_bucket``)."""
    if min_bucket <= 0:
        raise ValueError("min_bucket must be positive")
    if n <= min_bucket:
        return min_bucket
    return 1 << (int(n) - 1).bit_length()


def bucket_sizes(max_rows: int,
                 min_bucket: int = DEFAULT_MIN_BUCKET) -> Tuple[int, ...]:
    """The full bucket ladder covering every batch of ``1..max_rows`` rows
    (ascending powers of two): the shapes a serving warm-up runs."""
    if max_rows <= 0:
        raise ValueError("max_rows must be positive")
    sizes = []
    b = bucket_rows(1, min_bucket=min_bucket)
    top = bucket_rows(max_rows, min_bucket=min_bucket)
    while b <= top:
        sizes.append(b)
        b <<= 1
    return tuple(sizes)


def pad_rows_to_bucket(arrays: Sequence[np.ndarray], *,
                       min_bucket: int = DEFAULT_MIN_BUCKET,
                       max_bucket_rows: Optional[int] = DEFAULT_BUCKET_CAP
                       ) -> Tuple[Tuple[np.ndarray, ...], int]:
    """Zero-pad every array's leading dim to its power-of-two bucket;
    returns ``(padded_arrays, n_real_rows)``.  Safe for row-independent
    computations (per-row argmin, margins): pad rows never touch real
    rows, and the caller slices results back to ``[:n]``.  Batches above
    ``max_bucket_rows`` (None = unlimited) keep their exact shape."""
    n = int(arrays[0].shape[0])
    if max_bucket_rows is not None and n > max_bucket_rows:
        return tuple(np.asarray(a) for a in arrays), n
    bucket = bucket_rows(n, min_bucket=min_bucket)
    if n == bucket:
        return tuple(np.asarray(a) for a in arrays), n
    return tuple(
        np.concatenate(
            [a, np.zeros((bucket - n,) + a.shape[1:], a.dtype)])
        for a in arrays), n


def require_block_rows(n: int, block: int, *, op: str = "kernel") -> None:
    """The block invariant of a blocked kernel: its row count must be an
    exact multiple of its block."""
    if block <= 0:
        raise ValueError(f"{op}: block must be positive, got {block}")
    if n % block:
        raise ValueError(
            f"{op}: n={n} must be a multiple of block={block} — pad rows "
            "with pad_rows_to_block (maskless zero-fill contract) or "
            "pad_rows_with_mask(multiple=block) (masked contract)")


def pad_rows_to_block(arrays: Sequence[np.ndarray], block: int,
                      ) -> Tuple[Tuple[np.ndarray, ...], int]:
    """The MASKLESS padding contract: zero-pad every array's leading dim up
    to a multiple of ``block``; returns ``(padded, n_real_rows)``.  Pad
    rows are exact zeros, whose effect on the KMeans stats is removed
    analytically (``ops/kmeans.py::pad_correction``)."""
    if block <= 0:
        raise ValueError("block must be positive")
    n = int(arrays[0].shape[0])
    pad = (-n) % block
    if pad == 0:
        return tuple(np.asarray(a) for a in arrays), n
    return tuple(
        np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        for a in arrays), n


def pad_rows_with_mask(arr, multiple: int,
                       fill: str = "first_row") -> Tuple[np.ndarray, np.ndarray]:
    """Pad rows so ``rows % multiple == 0``; returns ``(padded, mask)`` with
    a float32 mask of 1 for real rows.

    ``fill="first_row"`` repeats row 0 — safe when every consumer weights
    rows by the mask.  ``fill="zero"`` pads exact-zero rows."""
    if multiple <= 0:
        raise ValueError("multiple must be positive")
    if fill not in ("first_row", "zero"):
        raise ValueError(f"fill must be 'first_row' or 'zero', got {fill!r}")
    arr = np.asarray(arr)
    n = arr.shape[0]
    mask = np.ones((n,), dtype=np.float32)
    remainder = n % multiple
    if remainder == 0 or n == 0:
        return arr, mask
    pad = multiple - remainder
    if fill == "zero":
        filler = np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)
    else:
        filler = np.repeat(arr[:1], pad, axis=0)
    padded = np.concatenate([arr, filler], axis=0)
    mask = np.concatenate([mask, np.zeros((pad,), dtype=np.float32)])
    return padded, mask
