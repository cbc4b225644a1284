"""Int8 scoring functions of the serving ops.

A port of the JAX package's ``ops/int8_serving.py``.  Each function is the
int8 twin of a chain terminal's kernel function, registered as the
``"int8"`` backend of the servable's op: params arrive as the
``{"q": int8, "s": f32}`` trees of
:func:`~flink_ml_tpu_torch.kernels.quantize.quantize_stage_params`,
dequantize on the device (one exact cast + one f32 multiply), then run
the SAME expression as the f32 terminal, so the only divergence from f32
is the quantization error (decision agreement, not bits).

Tables gather the int8 codes first and dequantize only the gathered rows:
the f32 table never materializes on the device, the order the
``EmbeddingRowCache`` int8 pools use too.

Only ``make_servable(..., precision="int8")`` builds the quantized param
trees, so only a servable's bind reaches these functions: they register
as the ``"int8"`` backends of their ops (:func:`_register_int8_kernels`),
which only a forced ``lookup(op, backend="int8")`` returns.
"""

from __future__ import annotations

import torch

from ..api.chain import as_matrix
from ..kernels.quantize import (dequantize, dequantize_rows,
                                dequantize_widedeep_rest)

__all__ = ["int8_linear_margins", "int8_kmeans_assign",
           "int8_widedeep_scores"]


def int8_linear_margins(static, params, cols):
    """``linear_margins`` on dequantized weights: the expression of
    ``_linear_chain_kernel`` after the one multiply that rebuilds ``w``
    (per-tensor scale for vector ``w``, per-class for multiclass); ``b``
    is f32 passthrough."""
    (fcol, mcol) = static
    X = as_matrix(cols[fcol]).to(torch.float32)
    qw = params["w"]
    w = dequantize(qw["q"], qw["s"], None if qw["q"].ndim == 1 else 1)
    return {mcol: X @ w + params["b"]}


def int8_kmeans_assign(static, params, cols):
    """``kmeans_assign`` on dequantized centroids (per-centroid-row
    scales): the f32 terminal's function, so on the card the assignment
    is the ``kmeans_assign_reduce`` kernel (B5)."""
    from ..models.clustering.kmeans import _kmeans_chain_kernel

    c = params["centroids"]
    return _kmeans_chain_kernel(
        static, {"centroids": dequantize(c["q"], c["s"], 0)}, cols)


def int8_widedeep_scores(static, params, cols):
    """``widedeep_scores`` with int8 tables and MLP matrices: the
    ``wide_cat``/``emb`` gathers read the codes and dequantize the
    gathered rows only; the dense tower dequantizes its matrices on the
    device.  Biases, ``wide_b`` and the id ``offsets`` pass through."""
    from ..models.recommendation.widedeep import _rows, scores_from_rows

    (dcol, ccol, scol) = static
    qnet = params["net"]
    dense = cols[dcol].to(torch.float32)
    cat = cols[ccol] + params["offsets"][None, :]
    wide_rows = dequantize(_rows(qnet["wide_cat"]["q"], cat),
                           qnet["wide_cat"]["s"])
    emb_rows = dequantize_rows(_rows(qnet["emb"]["q"], cat),
                               _rows(qnet["emb"]["s"], cat))
    return {scol: scores_from_rows(dequantize_widedeep_rest(qnet), dense,
                                   wide_rows, emb_rows)}



def _quantized_params_only() -> bool:
    """Availability gate that always refuses: the int8 entries consume
    the quantized param trees only the servable bind path builds, so an
    automatic pick (which would hand them f32 params) must never see
    them.  A forced ``lookup(op, backend="int8")`` bypasses it, by the
    registry's own contract."""
    return False


def _register_int8_kernels() -> None:
    from ..kernels.registry import register_kernel

    register_kernel("linear_margins", "int8", int8_linear_margins,
                    convention="stage", available=_quantized_params_only)
    register_kernel("kmeans_assign", "int8", int8_kmeans_assign,
                    convention="stage", available=_quantized_params_only)
    register_kernel("widedeep_scores", "int8", int8_widedeep_scores,
                    convention="stage", available=_quantized_params_only)


_register_int8_kernels()
