"""Stateless-ish feature transformers: Bucketizer, Binarizer, Normalizer,
PolynomialExpansion, and the fitted Imputer.

Members of the Flink ML 2.x feature-engineering surface.  The
exact-compare transforms (Binarizer, Bucketizer) compare on the host in
float64; the continuous ones run their chain kernel on the device as a
one-stage segment (``api/chain.py``), so a standalone transform and the
same stage inside a fused segment run one function on one padded shape.
Imputer is an Estimator (it learns the fill statistics).

A port of the JAX package's ``models/feature/transforms.py``.  Every
stage runs on ``device`` (default ``"cuda"``; raises without a card
unless ``"cpu"`` is asked for).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.chain import (StageKernel, apply_kernel_or_none,
                          as_matrix as _as_mat, f32_ceil, f32_floor,
                          numeric_entry)
from ...api.stage import Estimator, Model, Transformer
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.param import (
    DoubleArrayParam,
    FloatParam,
    IntParam,
    ParamValidators,
    StringParam,
)
from ...params.shared import HasFeaturesCol, HasOutputCol
from ...utils import persist

__all__ = [
    "Binarizer",
    "Bucketizer",
    "Imputer",
    "ImputerModel",
    "Normalizer",
    "PolynomialExpansion",
]


class _OnDevice:
    """``device`` plumbing shared by the feature stages: the constructor
    argument, the fitted model inheriting it, and ``load(path, device)``
    (params-only stages; stages with model data extend it)."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device

    def _model_of(self, model_cls):
        """A fresh ``model_cls`` with this estimator's params and device."""
        model = model_cls(device=self.device)
        model.copy_params_from(self)
        return model

    @classmethod
    def load(cls, path: str, device="cuda"):
        stage = persist.load_stage_param(path)
        if not isinstance(stage, cls):
            raise IOError(f"Stage at {path} is a {type(stage).__name__}, "
                          f"not a {cls.__name__}")
        stage.device = device
        return stage


def _kernel_transform(stage, table: Table, kernel_of, host_apply):
    """A continuous stage's standalone transform: its kernel on the
    table's own column; on an object column (vectors), its kernel on the
    stacked matrix; ``host_apply(X f64)`` when no kernel applies (or the
    batch holds f32-unsafe integers).  Returns the output column."""
    ocol = stage.get_output_col()
    fetched = apply_kernel_or_none(kernel_of(table.schema()), table)
    if fetched is not None:
        return fetched[ocol]
    fcol = stage.get_features_col()
    X = stack_vectors(table[fcol])
    if np.asarray(table[fcol]).dtype == object:
        stacked = Table({fcol: X})
        fetched = apply_kernel_or_none(kernel_of(stacked.schema()), stacked)
        if fetched is not None:
            return fetched[ocol]
    return host_apply(X.astype(np.float64))


class _InOutParams(HasFeaturesCol, HasOutputCol):
    pass


class _SimpleTransformer(_OnDevice, _InOutParams, Transformer):
    """Shared column plumbing for the stateless transformers (save comes
    from the Stage default — params-only persistence).  ``_apply``
    receives the raw float64 batch: the exact-compare transforms
    (Binarizer, Bucketizer) compare on the host at full precision; the
    continuous ones run their kernel and use ``_apply`` only where no
    kernel applies."""

    def _apply(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    #: exact-compare transforms (threshold / bucket index outputs) set
    #: this True: their kernels decline f64 columns (chain.numeric_entry)
    #: and their standalone transform stays on the host
    _exact_compare = False
    #: a transform whose standalone path is host numpy at the column's
    #: own precision although its kernel is not an exact compare
    _host_transform = False

    def _numeric_feature(self, schema) -> bool:
        return numeric_entry(schema, self.get_features_col(),
                             exact_compare=self._exact_compare) is not None

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        if self._exact_compare or self._host_transform:
            X = stack_vectors(table[self.get_features_col()]).astype(
                np.float64)
            out = self._apply(X)
        else:
            out = _kernel_transform(self, table, self.transform_kernel,
                                    self._apply)
        return [table.with_column(self.get_output_col(), out)]

    def _kernel(self, fn, static, params) -> StageKernel:
        return StageKernel(
            fn=fn, static=static, params=params,
            consumes=(self.get_features_col(),),
            produces=(self.get_output_col(),), device=self.device)


class Binarizer(_SimpleTransformer):
    """x -> 1.0 if x > threshold else 0.0, elementwise."""

    _exact_compare = True

    THRESHOLD = FloatParam("threshold", "Binarization threshold.",
                           default=0.0)

    def get_threshold(self) -> float:
        return self.get(Binarizer.THRESHOLD)

    def set_threshold(self, value: float):
        return self.set(Binarizer.THRESHOLD, value)

    def _apply(self, X: np.ndarray) -> np.ndarray:
        # pure host comparison: full float64 precision for the threshold
        return (X > self.get_threshold()).astype(np.float64)

    def transform_kernel(self, schema):
        """Chain kernel with the f32_floor SURROGATE threshold: for any
        f32 value ``v``, ``v > t ⟺ v > f32_floor(t)`` — the in-segment
        compare is bit-exact with the host-f64 stagewise compare on the
        segment's f32 columns."""
        if not self._numeric_feature(schema):
            return None
        thr = f32_floor(np.asarray([self.get_threshold()]))[0]
        return self._kernel(
            _binarizer_kernel,
            (self.get_features_col(), self.get_output_col()),
            {"threshold": np.float32(thr)})


def _binarizer_kernel(static, params, cols):
    (fcol, ocol) = static
    X = _as_mat(cols[fcol])
    return {ocol: (X > params["threshold"]).to(torch.float32)}


class Bucketizer(_SimpleTransformer):
    """Map each value to the index of its half-open split interval
    ``[splits[i], splits[i+1])``.  Values outside the outer splits are
    *invalid* (as is NaN) and routed by ``handleInvalid``: ``"error"``
    (default) raises, ``"keep"`` maps them into a dedicated extra bucket
    ``len(splits) - 1``, ``"clip"`` clamps into the first/last regular
    bucket (NaN still errors — it has no nearest bucket)."""

    _exact_compare = True

    SPLITS = DoubleArrayParam(
        "splits", "Strictly increasing bucket boundaries (>= 3 values).",
        default=None, validator=ParamValidators.not_null())
    HANDLE_INVALID = StringParam(
        "handleInvalid",
        "Values outside the outer splits: error | keep | clip.",
        default="error",
        validator=ParamValidators.in_array(["error", "keep", "clip"]))

    def get_splits(self):
        return self.get(Bucketizer.SPLITS)

    def set_splits(self, *values: float):
        vals = values[0] if len(values) == 1 and not np.isscalar(values[0]) \
            else values
        return self.set(Bucketizer.SPLITS, tuple(float(v) for v in vals))

    def get_handle_invalid(self) -> str:
        return self.get(Bucketizer.HANDLE_INVALID)

    def set_handle_invalid(self, value: str):
        return self.set(Bucketizer.HANDLE_INVALID, value)

    def _apply(self, X: np.ndarray) -> np.ndarray:
        splits = np.asarray(self.get_splits(), np.float64)
        if len(splits) < 3:
            raise ValueError("Bucketizer needs >= 3 split values "
                             f"(got {len(splits)})")
        if not np.all(np.diff(splits) > 0):
            raise ValueError("Bucketizer splits must be strictly increasing")
        n_buckets = len(splits) - 1  # last regular bucket is closed on top
        nan = np.isnan(X)
        invalid = nan | (X < splits[0]) | (X > splits[-1])
        policy = self.get_handle_invalid()
        if np.any(invalid) and (policy == "error"
                                or (policy == "clip" and np.any(nan))):
            bad = X[invalid if policy == "error" else nan].ravel()[0]
            raise ValueError(
                f"Bucketizer got invalid value {bad} for splits "
                f"[{splits[0]}, {splits[-1]}]; set handleInvalid to 'keep' "
                "to accept it")
        idx = np.searchsorted(splits, X, side="right") - 1
        idx = np.clip(idx, 0, n_buckets - 1)  # top edge + 'clip' policy
        if policy == "keep":
            idx = np.where(invalid, n_buckets, idx)
        return idx.astype(np.float64)

    def transform_kernel(self, schema):
        """Chainable only under ``handleInvalid="keep"`` — the other
        policies raise on data the kernel would have to detect in-device.
        The splits carry f32_ceil/f32_floor surrogates so the searchsorted
        semantics (``#{splits[j] <= v}``) are bit-exact on f32 columns."""
        if self.get_handle_invalid() != "keep" \
                or not self._numeric_feature(schema):
            return None
        splits = np.asarray(self.get_splits(), np.float64)
        if len(splits) < 3 or not np.all(np.diff(splits) > 0):
            return None      # stagewise raises the diagnostic error
        return self._kernel(
            _bucketizer_kernel,
            (self.get_features_col(), self.get_output_col(),
             len(splits) - 1),
            {"ceil_splits": f32_ceil(splits),
             "lower": np.float32(f32_ceil(splits[:1])[0]),
             "upper": np.float32(f32_floor(splits[-1:])[0])})


def _bucketizer_kernel(static, params, cols):
    (fcol, ocol, nb) = static
    X = _as_mat(cols[fcol])
    # searchsorted(splits, X, "right") == #{j: splits[j] <= X}
    idx = torch.sum(X[..., None] >= params["ceil_splits"], dim=-1) - 1
    idx = torch.clamp(idx, 0, nb - 1)
    invalid = torch.isnan(X) | (X < params["lower"]) | (X > params["upper"])
    return {ocol: torch.where(invalid, nb, idx).to(torch.float32)}


class Normalizer(_SimpleTransformer):
    """Scale each row to unit p-norm."""

    P = FloatParam("p", "Norm order.", default=2.0,
                   validator=ParamValidators.gt_eq(1.0))

    def get_p(self) -> float:
        return self.get(Normalizer.P)

    def set_p(self, value: float):
        return self.set(Normalizer.P, value)

    def _apply(self, X: np.ndarray) -> np.ndarray:
        p = self.get_p()
        if np.isinf(p):
            norm = np.max(np.abs(X), axis=-1, keepdims=True)
        else:
            norm = np.sum(np.abs(X) ** p, axis=-1,
                          keepdims=True) ** (1.0 / p)
        return X / np.maximum(norm, 1e-12)

    def transform_kernel(self, schema):
        if not self._numeric_feature(schema):
            return None
        return self._kernel(
            _normalizer_kernel,
            (self.get_features_col(), self.get_output_col(),
             float(self.get_p())), {})


def _normalizer_kernel(static, params, cols):
    (fcol, ocol, p) = static
    X = _as_mat(cols[fcol])
    # |x|**inf over/underflows into a constant 1.0 norm, so the inf-norm
    # needs its own branch
    if np.isinf(p):
        norm = torch.amax(torch.abs(X), dim=-1, keepdim=True)
    else:
        norm = torch.sum(torch.abs(X) ** p, dim=-1,
                         keepdim=True) ** (1.0 / p)
    return {ocol: X / torch.clamp(norm, min=1e-12)}


def _poly_exponents(d: int, degree: int) -> np.ndarray:
    """(n_terms, d) monomial exponent rows, in the expansion order BOTH
    the stagewise and fused paths share."""
    exponents: List[np.ndarray] = []

    def expand(prefix, remaining, start):
        for j in range(start, d):
            e = prefix.copy()
            e[j] += 1
            exponents.append(e.copy())
            if remaining > 1:
                expand(e, remaining - 1, j)

    expand(np.zeros(d, np.int64), degree, 0)
    return np.stack(exponents)


class PolynomialExpansion(_SimpleTransformer):
    """Expand features into all monomials up to ``degree`` (without the
    constant term), depth-first by variable index: for (x, y), degree 2 ->
    [x, x^2, xy, y, y^2]."""

    DEGREE = IntParam("degree", "Polynomial degree.", default=2,
                      validator=ParamValidators.gt_eq(1))

    def get_degree(self) -> int:
        return self.get(PolynomialExpansion.DEGREE)

    def set_degree(self, value: int):
        return self.set(PolynomialExpansion.DEGREE, value)

    def _apply(self, X: np.ndarray) -> np.ndarray:
        expo = _poly_exponents(X.shape[1], self.get_degree())
        return np.prod(X[:, None, :] ** expo[None, :, :], axis=-1)

    def transform_kernel(self, schema):
        entry = numeric_entry(schema, self.get_features_col())
        if entry is None:
            return None
        shape = entry[0]
        d = int(shape[0]) if shape else 1
        expo = _poly_exponents(d, self.get_degree())
        return self._kernel(
            _poly_chain_kernel,
            (self.get_features_col(), self.get_output_col()),
            {"expo": expo.astype(np.float32)})


def _poly_chain_kernel(static, params, cols):
    (fcol, ocol) = static
    X = _as_mat(cols[fcol])
    expo = params["expo"]
    # (n, 1, d) ** (terms, d) -> product over d
    return {ocol: torch.prod(X[:, None, :] ** expo[None, :, :], dim=-1)}


class ImputerParams(_InOutParams):
    STRATEGY = StringParam(
        "strategy", "Fill statistic.", default="mean",
        validator=ParamValidators.in_array(["mean", "median", "most_frequent"]))
    MISSING_VALUE = FloatParam(
        "missingValue", "Placeholder for missing entries (NaN always counts "
        "as missing).", default=float("nan"))

    def get_strategy(self) -> str:
        return self.get(ImputerParams.STRATEGY)

    def set_strategy(self, value: str):
        return self.set(ImputerParams.STRATEGY, value)

    def get_missing_value(self) -> float:
        return self.get(ImputerParams.MISSING_VALUE)

    def set_missing_value(self, value: float):
        return self.set(ImputerParams.MISSING_VALUE, value)


def _missing_mask(X: np.ndarray, missing: float) -> np.ndarray:
    mask = np.isnan(X)
    if not np.isnan(missing):
        mask |= X == missing
    return mask


class ImputerModel(_OnDevice, ImputerParams, Model):
    def __init__(self, device="cuda"):
        super().__init__(device)
        self._fill: Optional[np.ndarray] = None

    def set_model_data(self, *inputs) -> "ImputerModel":
        (t,) = inputs
        self._fill = np.asarray(t["fill"][0], np.float64)
        return self

    def _require_model(self) -> None:
        if self._fill is None:
            raise RuntimeError("ImputerModel has no model data; call "
                               "set_model_data() or fit an Imputer first")

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"fill": self._fill[None]})]

    def transform_kernel(self, schema):
        self._require_model()
        missing = self.get_missing_value()
        # equality only fires for f32-exact placeholders (+-inf included):
        # a non-exact placeholder can never equal an f32 column value, so
        # the kernel drops the compare instead of matching the ROUNDED
        # placeholder against real values
        use_eq = (not np.isnan(missing)
                  and float(np.float32(missing)) == float(missing))
        # ANY non-NaN placeholder is an exact decision over the column
        # values, so f64 columns decline even when use_eq is False: f64
        # data can carry the placeholder exactly (host path fills it)
        # while entry rounding makes it unmatchable
        if numeric_entry(schema, self.get_features_col(),
                         exact_compare=not np.isnan(missing)) is None:
            return None
        return StageKernel(
            fn=_imputer_kernel,
            static=(self.get_features_col(), self.get_output_col(),
                    float(np.float32(missing)) if use_eq else None),
            params={"fill": np.asarray(self._fill, np.float32)},
            consumes=(self.get_features_col(),),
            produces=(self.get_output_col(),), device=self.device)

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        fetched = apply_kernel_or_none(
            self.transform_kernel(table.schema()), table)
        if fetched is None:     # object dtype / f64 / f32-unsafe ints: host
            X = stack_vectors(
                table[self.get_features_col()]).astype(np.float64)
            mask = _missing_mask(X, self.get_missing_value())
            out = np.where(mask, self._fill[None, :], X)
        else:                   # device kernel: shared with the fused chain
            out = fetched[self.get_output_col()]
        return [table.with_column(self.get_output_col(), out)]

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {"fill": self._fill})

    @classmethod
    def load(cls, path: str, device="cuda") -> "ImputerModel":
        model = super().load(path, device)
        model._fill = persist.load_model_arrays(
            path, "model")["fill"].astype(np.float64)
        return model


def _imputer_kernel(static, params, cols):
    (fcol, ocol, missing) = static
    X = _as_mat(cols[fcol])
    mask = torch.isnan(X)
    if missing is not None:
        mask = mask | (X == missing)
    return {ocol: torch.where(mask, params["fill"][None, :], X)}


class Imputer(_OnDevice, ImputerParams, Estimator[ImputerModel]):
    """save comes from the Stage default (params-only persistence)."""

    def fit(self, *inputs) -> ImputerModel:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        mask = _missing_mask(X, self.get_missing_value())
        masked = np.ma.masked_array(X, mask)
        strategy = self.get_strategy()
        if strategy == "mean":
            fill = masked.mean(axis=0)
        elif strategy == "median":
            fill = np.ma.median(masked, axis=0)
        else:  # most_frequent
            fill = np.empty(X.shape[1])
            for j in range(X.shape[1]):
                col = X[~mask[:, j], j]
                if len(col) == 0:
                    fill[j] = 0.0
                    continue
                vals, counts = np.unique(col, return_counts=True)
                fill[j] = vals[np.argmax(counts)]
        fill = np.asarray(np.ma.filled(fill, 0.0), np.float64)

        model = self._model_of(ImputerModel)
        model._fill = fill
        return model
