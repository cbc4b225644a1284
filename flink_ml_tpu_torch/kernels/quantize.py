"""Per-channel max-abs int8 calibration for the IVF-PQ codebooks and the
int8 serving path.

A port of the JAX package's ``kernels/quantize.py``: the quantizers are
host numpy and copied (the ``scale = max|w| / 127`` contract with
deterministic round-to-nearest codes: same params, same codes); the
dequantizers act on tensors, one exact ``int8 -> f32`` cast and one f32
multiply.  Calibration is data-free: a servable quantizes its params when
it binds them (``serving/executor.py``, ``serving/embcache.py``), so every
generation scores with scales derived from its own params.

What never quantizes: biases and intercepts (``b``, ``wide_b``,
``mlp[i]["b"]``), the categorical id ``offsets`` and activations; int8
here is weight-only storage compression, and the compute is "dequantize,
then the f32 expression".
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["Q_MAX", "maxabs_scales", "quantize_channelwise", "dequantize",
           "quantize_rows", "dequantize_rows", "quantize_stage_params",
           "quantize_widedeep_rest", "dequantize_widedeep_rest",
           "quantized_ops"]

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


def dequantize(codes: torch.Tensor, scales: torch.Tensor,
               channel_axis: Optional[int] = None) -> torch.Tensor:
    """Exact cast + one f32 multiply, the per-channel ``scales``
    broadcast along ``channel_axis`` (one per-tensor scale when None)."""
    c = codes.to(torch.float32)
    if channel_axis is None:
        return c * scales
    axis = channel_axis % c.ndim
    shape = [1] * c.ndim
    shape[axis] = c.shape[axis]
    return c * scales.reshape(shape)


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


# ---------------------------------------------------------------------------
# per-op calibration recipes
# ---------------------------------------------------------------------------

def _q_tensor(w, channel_axis=None) -> Dict[str, np.ndarray]:
    codes, scales = quantize_channelwise(w, channel_axis)
    return {"q": codes, "s": scales}


def _q_linear(params: Dict[str, Any]) -> Dict[str, Any]:
    # vector w: one per-tensor scale (the single output channel);
    # multiclass (d, k): per-output-class scales on axis 1
    w = np.asarray(params["w"], np.float32)
    axis = None if w.ndim == 1 else 1
    return {"w": _q_tensor(w, axis),
            "b": np.asarray(params["b"], np.float32)}


def _q_kmeans(params: Dict[str, Any]) -> Dict[str, Any]:
    # centroids (k, d): per-centroid-row scales, so each centroid's
    # distance error is bounded by its own magnitude
    return {"centroids": _q_tensor(params["centroids"], 0)}


def quantize_widedeep_rest(net: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize the NON-TABLE Wide&Deep leaves (``wide_dense`` and the
    ``mlp`` matrices; ``wide_b`` and biases pass through), shared by the
    ``widedeep_scores`` recipe and the embedding-row cache's int8
    servable, whose tables live in the cache pools instead."""
    return {
        "wide_dense": _q_tensor(net["wide_dense"]),
        "wide_b": np.asarray(net["wide_b"], np.float32),
        # mlp matrices: per-output-channel (axis 1); biases stay f32
        "mlp": [{"w": _q_tensor(layer["w"], 1),
                 "b": np.asarray(layer["b"], np.float32)}
                for layer in net["mlp"]],
    }


def dequantize_widedeep_rest(qrest: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`quantize_widedeep_rest` on device tensors: the
    param dict ``forward_from_rows`` consumes."""
    return {
        "wide_dense": dequantize(qrest["wide_dense"]["q"],
                                 qrest["wide_dense"]["s"]),
        "wide_b": qrest["wide_b"],
        "mlp": [{"w": dequantize(layer["w"]["q"], layer["w"]["s"], 1),
                 "b": layer["b"]} for layer in qrest["mlp"]],
    }


def _q_widedeep(params: Dict[str, Any]) -> Dict[str, Any]:
    net = params["net"]
    qnet = quantize_widedeep_rest(net)
    # 1-d tables get one per-tensor scale (a per-row scale on scalar rows
    # would cost MORE than the f32 it replaces); emb (V, E) goes per-row,
    # so gathered rows dequantize locally
    qnet["wide_cat"] = _q_tensor(net["wide_cat"])
    qnet["emb"] = _q_tensor(net["emb"], 0)
    return {"net": qnet, "offsets": np.asarray(params["offsets"])}


#: op label -> calibration recipe; the keys are the serving ops with an
#: int8 scoring function (the ``"int8"`` registry entries of
#: ``ops/int8_serving.py``)
_RECIPES = {
    "linear_margins": _q_linear,
    "kmeans_assign": _q_kmeans,
    "widedeep_scores": _q_widedeep,
}


def quantized_ops() -> Tuple[str, ...]:
    """Ops with a publish-time int8 calibration recipe."""
    return tuple(sorted(_RECIPES))


def quantize_stage_params(op: str, params: Dict[str, Any]
                          ) -> Dict[str, Any]:
    """Calibrate + quantize a stage kernel's f32 param tree into the tree
    the op's int8 scoring function expects.  KeyError for ops without a
    recipe: the servable surfaces that at bind time, not mid-serve."""
    try:
        recipe = _RECIPES[op]
    except KeyError:
        raise KeyError(
            f"no int8 calibration recipe for op {op!r} (have "
            f"{quantized_ops()}); serve this model at f32") from None
    return recipe(params)
