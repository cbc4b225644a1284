"""Per-channel max-abs int8 calibration: the part the IVF-PQ build needs.

A copy of the numpy half of the JAX package's ``kernels/quantize.py``
(that module imports ``jax.numpy`` at its top, so the port keeps its own):
the ``scale = max|w| / 127`` contract with deterministic round-to-nearest
codes, and one scale per row for gathered tables such as the PQ
codebooks.  Dequantization is one exact ``int8 -> f32`` cast and one f32
multiply.  The int8 serving recipes (``quantize_stage_params`` and the
rest) are not ported yet (ROADMAP queue A8).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Q_MAX", "maxabs_scales", "quantize_channelwise", "quantize_rows",
           "dequantize_rows"]

#: symmetric int8 code range: ±127 (−128 unused, so dequantization is a
#: single multiply)
Q_MAX = 127.0


def _expand(scales: np.ndarray, ndim: int, axis: int):
    shape = [1] * ndim
    shape[axis] = -1
    return scales.reshape(shape)


def maxabs_scales(w: np.ndarray, channel_axis: Optional[int] = None
                  ) -> np.ndarray:
    """Per-channel (or per-tensor when ``channel_axis is None``) max-abs
    scales.  All-zero channels get scale 1.0: their codes are all zero
    either way, and a zero scale would NaN the dequantized weights."""
    w = np.asarray(w, np.float32)
    if channel_axis is None:
        m = float(np.max(np.abs(w))) if w.size else 0.0
        return np.float32(m / Q_MAX if m > 0.0 else 1.0)
    axis = channel_axis % w.ndim
    reduce_axes = tuple(a for a in range(w.ndim) if a != axis)
    m = np.max(np.abs(w), axis=reduce_axes) if w.size \
        else np.zeros((w.shape[axis],), np.float32)
    scales = (m / Q_MAX).astype(np.float32)
    scales[scales == 0.0] = np.float32(1.0)
    return scales


def quantize_channelwise(w: np.ndarray,
                         channel_axis: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``w -> (codes int8, scales f32)`` with deterministic
    round-to-nearest-even (``np.rint``): same weights, same codes."""
    w = np.asarray(w, np.float32)
    scales = maxabs_scales(w, channel_axis)
    denom = scales if channel_axis is None \
        else _expand(scales, w.ndim, channel_axis % w.ndim)
    codes = np.clip(np.rint(w / denom), -Q_MAX, Q_MAX).astype(np.int8)
    return codes, scales


def quantize_rows(table: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-ROW calibration for gathered tables (codebooks, centroids): one
    scale per leading-axis row, so a gathered row dequantizes from its own
    codes and its own scale."""
    return quantize_channelwise(table, channel_axis=0)


def dequantize_rows(row_codes: torch.Tensor,
                    row_scales: torch.Tensor) -> torch.Tensor:
    """Dequantize already-gathered rows: ``row_codes (..., row_dim)`` with
    one scale per row (``row_scales (...,)``)."""
    return row_codes.to(torch.float32) * row_scales[..., None]
