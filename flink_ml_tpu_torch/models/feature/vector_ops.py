"""Vector-shaping transformers: VectorSlicer, ElementwiseProduct,
Interaction, DCT, plus the fitted KBinsDiscretizer and VectorIndexer.

Members of the Flink ML 2.x feature-engineering surface.  The dense
row-wise math (DCT matmul, interaction outer products, elementwise
scaling) runs as the stages' chain kernels on the device, as one-stage
segments (``api/chain.py``); the index-learning estimators
(KBinsDiscretizer, VectorIndexer) compute their per-column statistics
and their standalone transforms on the host in float64, where exact
comparisons matter, and chain through f32 edge surrogates.

A port of the JAX package's ``models/feature/vector_ops.py``.  Every
stage runs on ``device`` (default ``"cuda"``; raises without a card
unless ``"cpu"`` is asked for).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.chain import (StageKernel, apply_kernel_or_none,
                          as_matrix as _mat, f32_ceil, numeric_entry)
from ...api.stage import Estimator, Model, Transformer
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.param import (
    BoolParam,
    DoubleArrayParam,
    IntArrayParam,
    IntParam,
    ParamValidators,
    StringParam,
)
from ...params.shared import HasInputCols, HasOutputCol, HasSeed
from ...utils import persist
from .transforms import _InOutParams, _OnDevice, _SimpleTransformer

__all__ = [
    "DCT",
    "ElementwiseProduct",
    "Interaction",
    "KBinsDiscretizer",
    "KBinsDiscretizerModel",
    "VectorIndexer",
    "VectorIndexerModel",
    "VectorSlicer",
]


class VectorSlicer(_SimpleTransformer):
    """Select a sub-vector of the input by index list (order-preserving,
    duplicates allowed — the Flink ML VectorSlicer contract requires
    non-negative indices within bounds).  The standalone transform
    gathers on the host at the column's own precision."""

    _host_transform = True

    INDICES = IntArrayParam(
        "indices", "Indices of the features to keep (non-negative).",
        default=None, validator=ParamValidators.not_null())

    def get_indices(self):
        return self.get(VectorSlicer.INDICES)

    def set_indices(self, *values: int):
        vals = values[0] if len(values) == 1 and not np.isscalar(values[0]) \
            else values
        return self.set(VectorSlicer.INDICES, tuple(int(v) for v in vals))

    def _apply(self, X: np.ndarray) -> np.ndarray:
        idx = np.asarray(self.get_indices(), np.int64)
        if idx.size == 0:
            raise ValueError("VectorSlicer needs at least one index")
        if np.any(idx < 0) or np.any(idx >= X.shape[1]):
            raise ValueError(
                f"VectorSlicer index out of range for dim {X.shape[1]}: "
                f"{idx[(idx < 0) | (idx >= X.shape[1])][0]}")
        return X[:, idx]

    def transform_kernel(self, schema):
        entry = numeric_entry(schema, self.get_features_col())
        if entry is None or not entry[0]:
            return None
        idx = np.asarray(self.get_indices() or (), np.int64)
        if idx.size == 0 or np.any(idx < 0) or np.any(idx >= entry[0][0]):
            return None      # stagewise raises the diagnostic error
        return self._kernel(
            _gather_cols_kernel,
            (self.get_features_col(), self.get_output_col()),
            {"idx": idx})


class ElementwiseProduct(_SimpleTransformer):
    """Hadamard product of each row with a fixed scaling vector."""

    SCALING_VEC = DoubleArrayParam(
        "scalingVec", "The vector to multiply with.", default=None,
        validator=ParamValidators.not_null())

    def get_scaling_vec(self):
        return self.get(ElementwiseProduct.SCALING_VEC)

    def set_scaling_vec(self, *values: float):
        vals = values[0] if len(values) == 1 and not np.isscalar(values[0]) \
            else values
        return self.set(ElementwiseProduct.SCALING_VEC,
                        tuple(float(v) for v in vals))

    def _apply(self, X: np.ndarray) -> np.ndarray:
        scale = np.asarray(self.get_scaling_vec(), np.float64)
        if scale.shape[0] != X.shape[1]:
            raise ValueError(
                f"scalingVec has dim {scale.shape[0]}, input rows have "
                f"dim {X.shape[1]}")
        return X * scale[None, :]

    def transform_kernel(self, schema):
        entry = numeric_entry(schema, self.get_features_col())
        if entry is None:
            return None
        scale = np.asarray(self.get_scaling_vec() or (), np.float64)
        d = int(entry[0][0]) if entry[0] else 1
        if scale.shape[0] != d:
            return None      # stagewise raises the diagnostic error
        return self._kernel(
            _elementwise_product_kernel,
            (self.get_features_col(), self.get_output_col()),
            {"scale": scale.astype(np.float32)})


def _gather_cols_kernel(static, params, cols):
    (fcol, ocol) = static
    return {ocol: _mat(cols[fcol])[:, params["idx"]]}


def _elementwise_product_kernel(static, params, cols):
    (fcol, ocol) = static
    return {ocol: _mat(cols[fcol]) * params["scale"][None, :]}


class Interaction(_OnDevice, HasInputCols, HasOutputCol, Transformer):
    """Row-wise tensor (outer) product of the input columns, flattened.

    For input vectors ``a (da,), b (db,), c (dc,)`` the output row is the
    flattened ``da*db*dc`` product tensor with the LAST input varying
    fastest — the nested-loop order of the Flink ML / Spark Interaction.
    Scalar (1-D) columns are treated as length-1 vectors.  The whole batch
    is one chain of broadcasted multiplies on the device.
    """

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        cols = self.get_input_cols()
        if not cols or len(cols) < 2:
            raise ValueError("Interaction needs >= 2 input columns")
        fetched = apply_kernel_or_none(
            self.transform_kernel(table.schema()), table)
        if fetched is not None:
            out = fetched[self.get_output_col()]
        else:                   # f32-unsafe integers: host float64
            acc = None
            for name in cols:
                arr = np.asarray(table[name], np.float64)
                arr = arr[:, None] if arr.ndim == 1 else arr
                acc = arr if acc is None else (
                    acc[:, :, None] * arr[:, None, :]).reshape(
                        acc.shape[0], -1)
            out = acc
        return [table.with_column(self.get_output_col(), out)]

    def transform_kernel(self, schema):
        in_cols = self.get_input_cols()
        if not in_cols or len(in_cols) < 2:
            return None      # stagewise raises the diagnostic error
        for name in in_cols:
            if numeric_entry(schema, name) is None:
                return None
        return StageKernel(
            fn=_interaction_kernel,
            static=(tuple(in_cols), self.get_output_col()),
            params={},
            consumes=tuple(in_cols),
            produces=(self.get_output_col(),), device=self.device)


def _interaction_kernel(static, params, cols):
    in_cols, ocol = static
    acc = _mat(cols[in_cols[0]]).to(torch.float32)
    for name in in_cols[1:]:
        m = _mat(cols[name]).to(torch.float32)
        # (n, da, 1) * (n, 1, db) -> (n, da, db) -> (n, da*db)
        acc = (acc[:, :, None] * m[:, None, :]).reshape(acc.shape[0], -1)
    return {ocol: acc}


class DCT(_SimpleTransformer):
    """Orthonormal 1-D DCT-II of each row (``inverse=True`` applies the
    DCT-III inverse).  Implemented as one (n, d) @ (d, d) matmul over the
    whole batch — for feature-sized d the cosine matrix is tiny."""

    INVERSE = BoolParam("inverse", "Apply the inverse transform (DCT-III).",
                        default=False)

    def get_inverse(self) -> bool:
        return self.get(DCT.INVERSE)

    def set_inverse(self, value: bool):
        return self.set(DCT.INVERSE, bool(value))

    @staticmethod
    def _matrix(d: int) -> np.ndarray:
        # C[k, n] = s_k * sqrt(2/d) * cos(pi * (2n + 1) * k / (2d)),
        # s_0 = 1/sqrt(2): the orthonormal DCT-II basis (C @ C.T = I).
        n = np.arange(d)
        k = np.arange(d)[:, None]
        C = np.sqrt(2.0 / d) * np.cos(np.pi * (2 * n[None, :] + 1) * k
                                      / (2.0 * d))
        C[0] /= np.sqrt(2.0)
        return C

    def _apply(self, X: np.ndarray) -> np.ndarray:
        C = self._matrix(X.shape[1])
        # orthonormal => inverse is the transpose
        return X @ (C if self.get_inverse() else C.T)

    def transform_kernel(self, schema):
        entry = numeric_entry(schema, self.get_features_col())
        if entry is None:
            return None
        d = int(entry[0][0]) if entry[0] else 1
        C = self._matrix(d).astype(np.float32)
        return self._kernel(
            _dct_chain_kernel,
            (self.get_features_col(), self.get_output_col(),
             bool(self.get_inverse())),
            {"C": C})


def _dct_chain_kernel(static, params, cols):
    (fcol, ocol, inverse) = static
    X = _mat(cols[fcol]).to(torch.float32)
    C = params["C"]
    return {ocol: X @ (C if inverse else C.T)}


# ---------------------------------------------------------------------------
# KBinsDiscretizer
# ---------------------------------------------------------------------------

class KBinsDiscretizerParams(_InOutParams, HasSeed):
    NUM_BINS = IntParam("numBins", "Number of bins per column.", default=5,
                        validator=ParamValidators.gt_eq(2))
    STRATEGY = StringParam(
        "strategy", "Bin-edge strategy: uniform | quantile | kmeans.",
        default="quantile",
        validator=ParamValidators.in_array(["uniform", "quantile", "kmeans"]))
    SUB_SAMPLES = IntParam(
        "subSamples", "Max rows sampled for edge fitting (<=0: use all).",
        default=200_000)

    def get_num_bins(self) -> int:
        return self.get(KBinsDiscretizerParams.NUM_BINS)

    def set_num_bins(self, value: int):
        return self.set(KBinsDiscretizerParams.NUM_BINS, value)

    def get_strategy(self) -> str:
        return self.get(KBinsDiscretizerParams.STRATEGY)

    def set_strategy(self, value: str):
        return self.set(KBinsDiscretizerParams.STRATEGY, value)

    def get_sub_samples(self) -> int:
        return self.get(KBinsDiscretizerParams.SUB_SAMPLES)

    def set_sub_samples(self, value: int):
        return self.set(KBinsDiscretizerParams.SUB_SAMPLES, value)


def _kmeans_1d_edges(col: np.ndarray, k: int, iters: int = 25) -> np.ndarray:
    """1-D Lloyd's on a sorted column; edges are midpoints between adjacent
    final centroids (the KBinsDiscretizer 'kmeans' strategy)."""
    uniq = np.unique(col)
    if len(uniq) <= k:
        # one bin per distinct value: edges at midpoints
        mids = (uniq[1:] + uniq[:-1]) / 2.0
        return np.concatenate([[col.min()], mids, [col.max()]])
    centers = np.quantile(col, (np.arange(k) + 0.5) / k)
    for _ in range(iters):
        # 1-D assignment = searchsorted against boundary midpoints
        bounds = (centers[1:] + centers[:-1]) / 2.0
        assign = np.searchsorted(bounds, col)
        sums = np.bincount(assign, weights=col, minlength=k)
        counts = np.bincount(assign, minlength=k)
        nonempty = counts > 0
        new = centers.copy()
        new[nonempty] = sums[nonempty] / counts[nonempty]
        if np.allclose(new, centers):
            centers = new
            break
        centers = new
    mids = (np.sort(centers)[1:] + np.sort(centers)[:-1]) / 2.0
    return np.concatenate([[col.min()], mids, [col.max()]])


class KBinsDiscretizerModel(_OnDevice, KBinsDiscretizerParams, Model):
    """Buckets each column by its learned edges; out-of-range values clamp
    into the first/last bin (the Flink ML KBinsDiscretizerModel behavior)."""

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._edges: Optional[np.ndarray] = None   # (d, max_edges) +inf pad
        self._n_edges: Optional[np.ndarray] = None  # (d,) valid counts

    def set_model_data(self, *inputs) -> "KBinsDiscretizerModel":
        (t,) = inputs
        self._edges = np.asarray(t["edges"], np.float64)
        self._n_edges = np.asarray(t["n_edges"], np.int64)
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"edges": self._edges, "n_edges": self._n_edges})]

    def _require_model(self) -> None:
        if self._edges is None:
            raise RuntimeError("KBinsDiscretizerModel has no model data")

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        out = np.empty_like(X)
        for j in range(X.shape[1]):
            edges = self._edges[j, : self._n_edges[j]]
            # interior edges only: clamping outer values into first/last bin
            idx = np.searchsorted(edges[1:-1], X[:, j], side="right")
            out[:, j] = idx
        return [table.with_column(self.get_output_col(), out)]

    def transform_kernel(self, schema):
        """Learned edges are arbitrary f64 quantiles, so the kernel binning
        uses f32_ceil surrogates per interior edge: ``#{e <= v}`` counted
        against the surrogates is bit-exact with the host-f64 searchsorted
        for every f32 value ``v`` — which is why f64 columns decline
        (``exact_compare``): segment-entry rounding could carry a value
        across an edge the host-f64 compare respects."""
        self._require_model()
        entry = numeric_entry(schema, self.get_features_col(),
                              exact_compare=True)
        if entry is None:
            return None
        d = int(entry[0][0]) if entry[0] else 1
        if d != self._edges.shape[0]:
            return None
        width = max(int(self._n_edges.max()) - 2, 1)
        ceil_edges = np.full((d, width), np.inf, np.float32)
        for j in range(d):
            interior = self._edges[j, 1: self._n_edges[j] - 1]
            ceil_edges[j, : len(interior)] = f32_ceil(interior)
        n_interior = np.maximum(self._n_edges - 2, 0).astype(np.int32)
        return StageKernel(
            fn=_kbins_kernel,
            static=(self.get_features_col(), self.get_output_col()),
            params={"ceil_edges": ceil_edges, "n_interior": n_interior},
            consumes=(self.get_features_col(),),
            produces=(self.get_output_col(),), device=self.device)

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {
            "edges": self._edges, "n_edges": self._n_edges})

    @classmethod
    def load(cls, path: str, device="cuda") -> "KBinsDiscretizerModel":
        model = super().load(path, device)
        data = persist.load_model_arrays(path, "model")
        model._edges = data["edges"].astype(np.float64)
        model._n_edges = data["n_edges"].astype(np.int64)
        return model


def _kbins_kernel(static, params, cols):
    (fcol, ocol) = static
    X = _mat(cols[fcol])
    # searchsorted(interior, x, "right") == #{e: e <= x}; +inf pads never hit
    idx = torch.sum(X[:, :, None] >= params["ceil_edges"][None, :, :],
                    dim=-1)
    # NaN compares false against every edge (bin 0 here), but the host
    # searchsorted sorts NaN AFTER everything -> last bin
    idx = torch.where(torch.isnan(X), params["n_interior"][None, :], idx)
    return {ocol: idx.to(torch.float32)}


class KBinsDiscretizer(_OnDevice, KBinsDiscretizerParams,
                       Estimator[KBinsDiscretizerModel]):
    """Learns per-column bin edges.  ``quantile`` collapses duplicate
    quantile edges (fewer effective bins on skewed data, same as the Flink
    ML implementation); ``uniform`` spaces bins over [min, max]; ``kmeans``
    runs 1-D Lloyd's per column and cuts at centroid midpoints."""

    def fit(self, *inputs) -> KBinsDiscretizerModel:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        sub = self.get_sub_samples()
        if 0 < sub < X.shape[0]:
            sel = np.random.default_rng(self.get_seed()).choice(
                X.shape[0], sub, replace=False)
            X = X[sel]
        k = self.get_num_bins()
        strategy = self.get_strategy()
        per_col: List[np.ndarray] = []
        for j in range(X.shape[1]):
            col = X[:, j]
            if col.min() == col.max():
                # constant column: one [min, min+1) bin for EVERY strategy
                # (uniform's linspace would yield k+1 identical edges and
                # searchsorted would bucket everything into bin k-1)
                edges = np.array([col.min(), col.max() + 1.0])
            elif strategy == "uniform":
                edges = np.linspace(col.min(), col.max(), k + 1)
            elif strategy == "quantile":
                edges = np.unique(np.quantile(col, np.linspace(0, 1, k + 1)))
            else:
                edges = _kmeans_1d_edges(col, k)
            per_col.append(edges)

        max_e = max(len(e) for e in per_col)
        edges = np.full((X.shape[1], max_e), np.inf)
        n_edges = np.zeros(X.shape[1], np.int64)
        for j, e in enumerate(per_col):
            edges[j, : len(e)] = e
            n_edges[j] = len(e)

        model = self._model_of(KBinsDiscretizerModel)
        model._edges = edges
        model._n_edges = n_edges
        return model


# ---------------------------------------------------------------------------
# VectorIndexer
# ---------------------------------------------------------------------------

class VectorIndexerParams(_InOutParams):
    MAX_CATEGORIES = IntParam(
        "maxCategories",
        "Columns with more distinct values than this stay continuous.",
        default=20, validator=ParamValidators.gt_eq(2))
    HANDLE_INVALID = StringParam(
        "handleInvalid", "Unseen categorical values: error | skip | keep.",
        default="error",
        validator=ParamValidators.in_array(["error", "skip", "keep"]))

    def get_max_categories(self) -> int:
        return self.get(VectorIndexerParams.MAX_CATEGORIES)

    def set_max_categories(self, value: int):
        return self.set(VectorIndexerParams.MAX_CATEGORIES, value)

    def get_handle_invalid(self) -> str:
        return self.get(VectorIndexerParams.HANDLE_INVALID)

    def set_handle_invalid(self, value: str):
        return self.set(VectorIndexerParams.HANDLE_INVALID, value)


class VectorIndexerModel(_OnDevice, VectorIndexerParams, Model):
    """Maps each categorical column's values to indices in ascending value
    order; columns whose distinct count exceeded ``maxCategories`` at fit
    time pass through unchanged.  Unseen values at transform time follow
    ``handleInvalid``: error raises, skip drops the row, keep maps to the
    extra index ``numCategories``."""

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._values: Optional[np.ndarray] = None   # (d, max_vals) NaN pad
        self._n_values: Optional[np.ndarray] = None  # (d,) -1 => continuous

    def set_model_data(self, *inputs) -> "VectorIndexerModel":
        (t,) = inputs
        self._values = np.asarray(t["values"], np.float64)
        self._n_values = np.asarray(t["n_values"], np.int64)
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"values": self._values, "n_values": self._n_values})]

    def _require_model(self) -> None:
        if self._values is None:
            raise RuntimeError("VectorIndexerModel has no model data")

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        out = X.copy()
        invalid_rows = np.zeros(X.shape[0], bool)
        policy = self.get_handle_invalid()
        for j in range(X.shape[1]):
            n = self._n_values[j]
            if n < 0:           # continuous column: passthrough
                continue
            vals = self._values[j, :n]
            pos = np.searchsorted(vals, X[:, j])
            pos_c = np.clip(pos, 0, n - 1)
            hit = vals[pos_c] == X[:, j]
            if not np.all(hit):
                if policy == "error":
                    bad = X[:, j][~hit][0]
                    raise ValueError(
                        f"VectorIndexer saw unseen value {bad} in column {j}"
                        "; set handleInvalid to 'keep' or 'skip'")
                invalid_rows |= ~hit
            out[:, j] = np.where(hit, pos_c, float(n))
        result = table.with_column(self.get_output_col(), out)
        if policy == "skip" and np.any(invalid_rows):
            result = result.select_rows(np.flatnonzero(~invalid_rows))
        return [result]

    def transform_kernel(self, schema):
        """Chainable only under ``handleInvalid="keep"`` (error raises,
        skip drops rows — both host control flow).  Vocab values carry
        their f32 casts plus an exactness mask: a fitted value that is
        not f32-representable can never equal an f32 column value, so it
        is simply unmatchable (bit-exact with the host-f64 compare on
        f32 columns); two values colliding in f32 make the lookup
        ambiguous, and the stage falls back stagewise.  f64 columns
        decline (``exact_compare``): entry rounding could land an unseen
        f64 value exactly on a vocab entry the host-f64 compare rejects."""
        self._require_model()
        if self.get_handle_invalid() != "keep":
            return None
        entry = numeric_entry(schema, self.get_features_col(),
                              exact_compare=True)
        if entry is None:
            return None
        d = int(entry[0][0]) if entry[0] else 1
        if d != self._values.shape[0]:
            return None
        m = max(int(self._n_values.max()), 1)
        vals32 = np.full((d, m), np.inf, np.float32)
        exact = np.zeros((d, m), np.float32)
        for j in range(d):
            n = self._n_values[j]
            if n < 0:
                continue
            v = self._values[j, :n]
            v32 = v.astype(np.float32)
            if np.any(np.diff(v32) <= 0):
                return None       # f32 collision: lookup would be ambiguous
            vals32[j, :n] = v32
            exact[j, :n] = (v32.astype(np.float64) == v)
        return StageKernel(
            fn=_vector_indexer_kernel,
            static=(self.get_features_col(), self.get_output_col()),
            params={"vals": vals32, "exact": exact,
                    "unseen": self._n_values.astype(np.float32),
                    "is_cat": (self._n_values >= 0).astype(np.float32)},
            consumes=(self.get_features_col(),),
            produces=(self.get_output_col(),), device=self.device)

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {
            "values": self._values, "n_values": self._n_values})

    @classmethod
    def load(cls, path: str, device="cuda") -> "VectorIndexerModel":
        model = super().load(path, device)
        data = persist.load_model_arrays(path, "model")
        model._values = data["values"].astype(np.float64)
        model._n_values = data["n_values"].astype(np.int64)
        return model


def _vector_indexer_kernel(static, params, cols):
    (fcol, ocol) = static
    X = _mat(cols[fcol]).to(torch.float32)
    vals = params["vals"]                               # (d, m), +inf pad
    d = vals.shape[0]
    col_ids = torch.arange(d, device=X.device)[None, :]
    # last index with vals <= x (unique vocab => same index searchsorted
    # side="left" lands on when x matches)
    pos = torch.sum(X[:, :, None] >= vals[None, :, :], dim=-1) - 1
    pos_c = torch.clamp(pos, 0, vals.shape[1] - 1)
    hit = (vals[col_ids, pos_c] == X) & (params["exact"][col_ids, pos_c] > 0)
    out_cat = torch.where(hit, pos_c.to(torch.float32),
                          params["unseen"][None, :])
    return {ocol: torch.where(params["is_cat"][None, :] > 0, out_cat, X)}


class VectorIndexer(_OnDevice, VectorIndexerParams,
                    Estimator[VectorIndexerModel]):
    def fit(self, *inputs) -> VectorIndexerModel:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        max_cat = self.get_max_categories()
        per_col: List[Optional[np.ndarray]] = []
        for j in range(X.shape[1]):
            uniq = np.unique(X[:, j])
            per_col.append(uniq if len(uniq) <= max_cat else None)

        max_v = max((len(v) for v in per_col if v is not None), default=1)
        values = np.full((X.shape[1], max_v), np.nan)
        n_values = np.full(X.shape[1], -1, np.int64)
        for j, v in enumerate(per_col):
            if v is not None:
                values[j, : len(v)] = v
                n_values[j] = len(v)

        model = self._model_of(VectorIndexerModel)
        model._values = values
        model._n_values = n_values
        return model
