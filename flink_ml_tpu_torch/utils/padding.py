"""Row padding for fixed-shape batches (the one helper the port needs from
the JAX package's ``utils/padding.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["pad_rows_with_mask"]


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
