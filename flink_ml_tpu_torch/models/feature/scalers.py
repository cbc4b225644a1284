"""Feature scalers: Standard, MinMax, MaxAbs and Robust, each with its
model.

Statistics are fitted on the host; every model's transform is one affine
kernel on the device, run as a one-stage segment (``api/chain.py``), so a
standalone transform and the same stage inside a fused segment run one
function on one padded shape.

A port of the JAX package's ``models/feature/scalers.py``.  Every stage
runs on ``device`` (default ``"cuda"``; raises without a card unless
``"cpu"`` is asked for).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...api.chain import StageKernel, as_matrix as _as_matrix, numeric_entry
from ...api.stage import Estimator, Model
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.param import BoolParam, FloatParam
from ...params.shared import HasFeaturesCol, HasOutputCol
from ...utils import persist
from .transforms import _kernel_transform, _OnDevice

__all__ = ["StandardScaler", "StandardScalerModel",
           "MinMaxScaler", "MinMaxScalerModel",
           "MaxAbsScaler", "MaxAbsScalerModel",
           "RobustScaler", "RobustScalerModel"]


class _HasOutputCol(HasFeaturesCol, HasOutputCol):
    """features-in / output-out mixin for the scalers."""


def _affine_kernel(static, params, cols):
    (fcol, ocol) = static
    X = _as_matrix(cols[fcol])
    return {ocol: (X - params["shift"]) * params["scale"]}


def _div_affine_kernel(static, params, cols):
    """Division-form affine: mirrors the stagewise ``(X - lo) / span``
    expression ORDER so range boundaries stay exact (x/x == 1.0; a
    reciprocal-multiply would round)."""
    (fcol, ocol) = static
    X = _as_matrix(cols[fcol])
    return {ocol: (X - params["shift"]) / params["div"] * params["mul"]
            + params["add"]}


class _ScalerChainMixin:
    """Shared ``transform_kernel`` / ``transform`` plumbing: subclasses
    provide ``_kernel_fn`` + ``_kernel_params`` (f32 arrays precomputed
    from the fitted state — the WITH_* flags fold into the params, so one
    shared fn serves every configuration) and ``_host_apply`` (float64
    numpy, where no kernel applies)."""

    _kernel_fn = staticmethod(_affine_kernel)

    def transform_kernel(self, schema):
        fcol, ocol = self.get_features_col(), self.get_output_col()
        if numeric_entry(schema, fcol) is None:
            return None
        return StageKernel(
            fn=self._kernel_fn, static=(fcol, ocol),
            params=self._kernel_params(),
            consumes=(fcol,), produces=(ocol,), device=self.device)

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        out = _kernel_transform(self, table, self.transform_kernel,
                                self._host_apply)
        return [table.with_column(self.get_output_col(), out)]


class StandardScalerParams(_HasOutputCol):
    WITH_MEAN = BoolParam("withMean", "Center to zero mean.", default=True)
    WITH_STD = BoolParam("withStd", "Scale to unit variance.", default=True)


class StandardScalerModel(_OnDevice, StandardScalerParams, _ScalerChainMixin,
                          Model):
    def __init__(self, device="cuda"):
        super().__init__(device)
        self._mean: Optional[np.ndarray] = None
        self._std: Optional[np.ndarray] = None

    def _shift_scale(self):
        """f64 statistics with the WITH_* flags folded in."""
        mean = (self._mean if self.get(StandardScalerParams.WITH_MEAN)
                else np.zeros_like(self._mean))
        scale = (1.0 / np.maximum(self._std, 1e-12)
                 if self.get(StandardScalerParams.WITH_STD)
                 else np.ones_like(self._std))
        return mean, scale

    def _kernel_params(self):
        mean, scale = self._shift_scale()
        return {"shift": np.asarray(mean, np.float32),
                "scale": np.asarray(scale, np.float32)}

    def _host_apply(self, X: np.ndarray) -> np.ndarray:
        mean, scale = self._shift_scale()
        return (X - mean) * scale

    def set_model_data(self, *inputs) -> "StandardScalerModel":
        (t,) = inputs
        self._mean = np.asarray(t["mean"][0], np.float64)
        self._std = np.asarray(t["std"][0], np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"mean": self._mean[None], "std": self._std[None]})]

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model",
                                  {"mean": self._mean, "std": self._std})

    @classmethod
    def load(cls, path: str, device="cuda") -> "StandardScalerModel":
        model = super().load(path, device)
        data = persist.load_model_arrays(path, "model")
        model._mean, model._std = (data["mean"].astype(np.float64),
                                   data["std"].astype(np.float64))
        return model


class StandardScaler(_OnDevice, StandardScalerParams,
                     Estimator[StandardScalerModel]):
    def fit(self, *inputs) -> StandardScalerModel:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()])
        model = self._model_of(StandardScalerModel)
        model._mean = X.mean(axis=0)
        model._std = X.std(axis=0)
        return model


class MinMaxScalerParams(_HasOutputCol):
    MIN = FloatParam("min", "Lower bound of the output range.", default=0.0)
    MAX = FloatParam("max", "Upper bound of the output range.", default=1.0)


class MinMaxScalerModel(_OnDevice, MinMaxScalerParams, _ScalerChainMixin,
                        Model):
    _kernel_fn = staticmethod(_div_affine_kernel)

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._data_min: Optional[np.ndarray] = None
        self._data_max: Optional[np.ndarray] = None

    def _range(self):
        lo = self.get(MinMaxScalerParams.MIN)
        hi = self.get(MinMaxScalerParams.MAX)
        if hi <= lo:
            raise ValueError(f"min {lo} must be < max {hi}")
        return lo, hi, np.maximum(self._data_max - self._data_min, 1e-12)

    def _kernel_params(self):
        lo, hi, span = self._range()
        return {"shift": np.asarray(self._data_min, np.float32),
                "div": np.asarray(span, np.float32),
                "mul": np.float32(hi - lo), "add": np.float32(lo)}

    def _host_apply(self, X: np.ndarray) -> np.ndarray:
        lo, hi, span = self._range()
        return (X - self._data_min) / span * (hi - lo) + lo

    def set_model_data(self, *inputs) -> "MinMaxScalerModel":
        (t,) = inputs
        self._data_min = np.asarray(t["min"][0], np.float64)
        self._data_max = np.asarray(t["max"][0], np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"min": self._data_min[None],
                       "max": self._data_max[None]})]

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {"min": self._data_min,
                                                  "max": self._data_max})

    @classmethod
    def load(cls, path: str, device="cuda") -> "MinMaxScalerModel":
        model = super().load(path, device)
        data = persist.load_model_arrays(path, "model")
        model._data_min = data["min"].astype(np.float64)
        model._data_max = data["max"].astype(np.float64)
        return model


class MinMaxScaler(_OnDevice, MinMaxScalerParams,
                   Estimator[MinMaxScalerModel]):
    def fit(self, *inputs) -> MinMaxScalerModel:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()])
        model = self._model_of(MinMaxScalerModel)
        model._data_min = X.min(axis=0)
        model._data_max = X.max(axis=0)
        return model


class MaxAbsScalerModel(_OnDevice, _HasOutputCol, _ScalerChainMixin, Model):
    """Scale columns into [-1, 1] by the per-column max absolute value
    (preserves sparsity/sign)."""

    _kernel_fn = staticmethod(_div_affine_kernel)

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._max_abs: Optional[np.ndarray] = None

    def _kernel_params(self):
        return {"shift": np.float32(0.0),
                "div": np.asarray(np.maximum(self._max_abs, 1e-12),
                                  np.float32),
                "mul": np.float32(1.0), "add": np.float32(0.0)}

    def _host_apply(self, X: np.ndarray) -> np.ndarray:
        return X / np.maximum(self._max_abs, 1e-12)

    def set_model_data(self, *inputs) -> "MaxAbsScalerModel":
        (t,) = inputs
        self._max_abs = np.asarray(t["maxAbs"][0], np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"maxAbs": self._max_abs[None]})]

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {"maxAbs": self._max_abs})

    @classmethod
    def load(cls, path: str, device="cuda") -> "MaxAbsScalerModel":
        model = super().load(path, device)
        model._max_abs = persist.load_model_arrays(
            path, "model")["maxAbs"].astype(np.float64)
        return model


class MaxAbsScaler(_OnDevice, _HasOutputCol, Estimator[MaxAbsScalerModel]):
    def fit(self, *inputs) -> MaxAbsScalerModel:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()])
        model = self._model_of(MaxAbsScalerModel)
        model._max_abs = np.abs(X).max(axis=0)
        return model


class RobustScalerParams(_HasOutputCol):
    LOWER = FloatParam("lower", "Lower quantile of the scaling range.",
                       default=25.0)
    UPPER = FloatParam("upper", "Upper quantile of the scaling range.",
                       default=75.0)
    WITH_CENTERING = BoolParam("withCentering", "Subtract the median.",
                               default=True)
    WITH_SCALING = BoolParam("withScaling", "Divide by the quantile range.",
                             default=True)


class RobustScalerModel(_OnDevice, RobustScalerParams, _ScalerChainMixin,
                        Model):
    """Median/IQR scaling — outlier-robust standardization."""

    _kernel_fn = staticmethod(_div_affine_kernel)

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._median: Optional[np.ndarray] = None
        self._range: Optional[np.ndarray] = None

    def _kernel_params(self):
        center = (self._median
                  if self.get(RobustScalerParams.WITH_CENTERING)
                  else np.zeros_like(self._median))
        div = (np.maximum(self._range, 1e-12)
               if self.get(RobustScalerParams.WITH_SCALING)
               else np.ones_like(self._range))
        return {"shift": np.asarray(center, np.float32),
                "div": np.asarray(div, np.float32),
                "mul": np.float32(1.0), "add": np.float32(0.0)}

    def _host_apply(self, X: np.ndarray) -> np.ndarray:
        if self.get(RobustScalerParams.WITH_CENTERING):
            X = X - self._median
        if self.get(RobustScalerParams.WITH_SCALING):
            X = X / np.maximum(self._range, 1e-12)
        return X

    def set_model_data(self, *inputs) -> "RobustScalerModel":
        (t,) = inputs
        self._median = np.asarray(t["median"][0], np.float64)
        self._range = np.asarray(t["range"][0], np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({"median": self._median[None],
                       "range": self._range[None]})]

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {"median": self._median,
                                                  "range": self._range})

    @classmethod
    def load(cls, path: str, device="cuda") -> "RobustScalerModel":
        model = super().load(path, device)
        data = persist.load_model_arrays(path, "model")
        model._median = data["median"].astype(np.float64)
        model._range = data["range"].astype(np.float64)
        return model


class RobustScaler(_OnDevice, RobustScalerParams,
                   Estimator[RobustScalerModel]):
    def fit(self, *inputs) -> RobustScalerModel:
        (table,) = inputs
        lo = self.get(RobustScalerParams.LOWER)
        hi = self.get(RobustScalerParams.UPPER)
        if not 0.0 <= lo < hi <= 100.0:
            raise ValueError(f"need 0 <= lower < upper <= 100, "
                             f"got ({lo}, {hi})")
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        model = self._model_of(RobustScalerModel)
        model._median = np.median(X, axis=0)
        q_lo, q_hi = np.percentile(X, [lo, hi], axis=0)
        model._range = q_hi - q_lo
        return model
