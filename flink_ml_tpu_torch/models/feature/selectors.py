"""Feature selectors: VarianceThresholdSelector and
UnivariateFeatureSelector.

Members of the Flink ML 2.x feature surface (``feature/
variancethresholdselector``, ``feature/univariatefeatureselector`` in the
library line; the reference snapshot ships neither — SURVEY §2.8).  Both
are Estimator/Model pairs whose model data is the list of surviving
feature indices; transform is one gather.

Scoring reuses the stats machinery: chi-squared (categorical feature /
categorical label, ``stats.chisqtest``, on the host), one-way ANOVA F
(continuous / categorical, ``stats.anovatest`` — one-hot products on the
device), and the F-regression test (continuous / continuous) whose
correlation reduction is one device pass.

A port of the JAX package's ``models/feature/selectors.py``.  The
estimators and models take ``device`` (default ``"cuda"``): the variance,
ANOVA and F-regression reductions run there; the standalone transform
gathers on the host at the column's own precision, and inside a fused
segment (``api/chain.py``) the gather runs on ``device``.  Selection sorts
float64 p-values with a stable argsort, as the JAX package does, so an
exact tie breaks to the lower index in both packages.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.chain import StageKernel, numeric_entry
from ...api.stage import Estimator, Model
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.param import FloatParam, ParamValidators, StringParam
from ...params.shared import HasLabelCol
from ...utils import persist
from ...utils.device import resolve_device
from .transforms import _InOutParams, _OnDevice
from .vector_ops import _gather_cols_kernel

__all__ = [
    "UnivariateFeatureSelector",
    "UnivariateFeatureSelectorModel",
    "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel",
]


class _IndexSelectingModel(_OnDevice, Model):
    """Shared Model body: keep the learned subset of feature columns."""

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._indices: Optional[np.ndarray] = None

    def set_model_data(self, *inputs):
        (t,) = inputs
        self._indices = np.asarray(t["indices"], np.int64)
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"indices": self._indices})]

    def _require_model(self) -> None:
        if self._indices is None:
            raise RuntimeError(
                f"{type(self).__name__} has no model data; call "
                "set_model_data() or fit first")

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        X = stack_vectors(table[self.get_features_col()])
        if self._indices.size and self._indices.max() >= X.shape[1]:
            raise ValueError(
                f"model selects index {self._indices.max()} but input has "
                f"only {X.shape[1]} features")
        return [table.with_column(self.get_output_col(),
                                  X[:, self._indices])]

    def transform_kernel(self, schema):
        """Chain kernel: the transform is one gather by fitted indices —
        value-exact at any dtype, so the fused path is bit-exact."""
        self._require_model()
        entry = numeric_entry(schema, self.get_features_col())
        if entry is None:
            return None
        d = int(entry[0][0]) if entry[0] else 1
        if self._indices.size and self._indices.max() >= d:
            return None      # stagewise raises the diagnostic error
        return StageKernel(
            fn=_gather_cols_kernel,
            static=(self.get_features_col(), self.get_output_col()),
            params={"idx": self._indices.astype(np.int64)},
            consumes=(self.get_features_col(),),
            produces=(self.get_output_col(),), device=self.device)

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {"indices": self._indices})

    @classmethod
    def load(cls, path: str, device="cuda"):
        model = super().load(path, device)
        model._indices = persist.load_model_arrays(
            path, "model")["indices"].astype(np.int64)
        return model


# ---------------------------------------------------------------------------
# VarianceThresholdSelector
# ---------------------------------------------------------------------------

class VarianceThresholdSelectorParams(_InOutParams):
    VARIANCE_THRESHOLD = FloatParam(
        "varianceThreshold",
        "Features with sample variance <= this are removed.", default=0.0,
        validator=ParamValidators.gt_eq(0.0))

    def get_variance_threshold(self) -> float:
        return self.get(
            VarianceThresholdSelectorParams.VARIANCE_THRESHOLD)

    def set_variance_threshold(self, value: float):
        return self.set(
            VarianceThresholdSelectorParams.VARIANCE_THRESHOLD, value)


class VarianceThresholdSelectorModel(VarianceThresholdSelectorParams,
                                     _IndexSelectingModel):
    pass


def _sample_variances(X: torch.Tensor) -> torch.Tensor:
    n = X.shape[0]
    mean = X.mean(dim=0, keepdim=True)
    ss = ((X - mean) ** 2).sum(dim=0)
    return ss / max(n - 1, 1)


class VarianceThresholdSelector(_OnDevice, VarianceThresholdSelectorParams,
                                Estimator[VarianceThresholdSelectorModel]):
    """Drops features whose *sample* variance (ddof=1) does not exceed the
    threshold — the Flink ML / sklearn VarianceThresholdSelector rule.
    The f32 variances run on ``device``."""

    def fit(self, *inputs) -> VarianceThresholdSelectorModel:
        (table,) = inputs
        dev = resolve_device(self.device)
        X = stack_vectors(table[self.get_features_col()])
        var = _sample_variances(torch.as_tensor(
            np.asarray(X, np.float32), device=dev))
        var = var.cpu().numpy().astype(np.float64)
        keep = np.flatnonzero(var > self.get_variance_threshold())
        model = self._model_of(VarianceThresholdSelectorModel)
        model._indices = keep.astype(np.int64)
        return model


# ---------------------------------------------------------------------------
# UnivariateFeatureSelector
# ---------------------------------------------------------------------------

def _chi2_scores(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-feature chi-squared p-values (categorical X, categorical y),
    on the host."""
    # imported here: the stats modules import this package's transforms
    from ..stats.chisqtest import _chi2_from_contingency, _p_values

    _, y_idx = np.unique(y, return_inverse=True)
    n_label = int(y_idx.max()) + 1 if len(y_idx) else 0
    stats, dofs = [], []
    for j in range(X.shape[1]):
        _, xj = np.unique(X[:, j], return_inverse=True)
        n_feat = int(xj.max()) + 1 if len(xj) else 0
        contingency = np.bincount(
            xj * n_label + y_idx, minlength=n_feat * n_label).reshape(
                n_feat, n_label).astype(np.float64)
        stat, dof = _chi2_from_contingency(contingency)
        stats.append(stat)
        dofs.append(dof)
    return _p_values(np.asarray(stats), np.asarray(dofs))


def _f_regression_scores(X: np.ndarray, y: np.ndarray,
                         device="cuda") -> np.ndarray:
    """Per-feature F-regression p-values — THE implementation lives in
    ``stats.fvaluetest`` (the FValueTest AlgoOperator); the selector only
    consumes the p-values."""
    from ..stats.fvaluetest import f_regression_scores

    _, p, _ = f_regression_scores(X, y, device)
    return p


_DEFAULT_THRESHOLDS = {"numTopFeatures": 50.0, "percentile": 0.1,
                       "fpr": 0.05, "fdr": 0.05, "fwe": 0.05}


class UnivariateFeatureSelectorParams(_InOutParams, HasLabelCol):
    FEATURE_TYPE = StringParam(
        "featureType", "categorical | continuous.", default=None,
        validator=ParamValidators.in_array(["categorical", "continuous"]))
    LABEL_TYPE = StringParam(
        "labelType", "categorical | continuous.", default=None,
        validator=ParamValidators.in_array(["categorical", "continuous"]))
    SELECTION_MODE = StringParam(
        "selectionMode",
        "numTopFeatures | percentile | fpr | fdr | fwe.",
        default="numTopFeatures",
        validator=ParamValidators.in_array(
            ["numTopFeatures", "percentile", "fpr", "fdr", "fwe"]))
    SELECTION_THRESHOLD = FloatParam(
        "selectionThreshold",
        "Meaning depends on mode: top-k count, percentile fraction, or "
        "p-value bound.  Defaults per mode when unset.", default=None)

    def get_feature_type(self) -> str:
        return self.get(UnivariateFeatureSelectorParams.FEATURE_TYPE)

    def set_feature_type(self, value: str):
        return self.set(UnivariateFeatureSelectorParams.FEATURE_TYPE, value)

    def get_label_type(self) -> str:
        return self.get(UnivariateFeatureSelectorParams.LABEL_TYPE)

    def set_label_type(self, value: str):
        return self.set(UnivariateFeatureSelectorParams.LABEL_TYPE, value)

    def get_selection_mode(self) -> str:
        return self.get(UnivariateFeatureSelectorParams.SELECTION_MODE)

    def set_selection_mode(self, value: str):
        return self.set(UnivariateFeatureSelectorParams.SELECTION_MODE,
                        value)

    def get_selection_threshold(self) -> float:
        value = self.get(UnivariateFeatureSelectorParams.SELECTION_THRESHOLD)
        if value is None:
            return _DEFAULT_THRESHOLDS[self.get_selection_mode()]
        return value

    def set_selection_threshold(self, value: float):
        return self.set(
            UnivariateFeatureSelectorParams.SELECTION_THRESHOLD, value)


class UnivariateFeatureSelectorModel(UnivariateFeatureSelectorParams,
                                     _IndexSelectingModel):
    pass


def _select_by_mode(p: np.ndarray, mode: str, threshold: float) -> np.ndarray:
    """Sorted indices of the selected features, per the Flink ML modes."""
    d = len(p)
    order = np.argsort(p, kind="stable")
    if mode == "numTopFeatures":
        return np.sort(order[: int(threshold)])
    if mode == "percentile":
        return np.sort(order[: int(d * threshold)])
    if mode == "fpr":
        return np.flatnonzero(p < threshold)
    if mode == "fdr":
        # Benjamini-Hochberg: largest m with p_(m) <= m/d * alpha
        ranked = p[order]
        below = np.flatnonzero(ranked <= (np.arange(1, d + 1) / d) * threshold)
        if below.size == 0:
            return np.zeros(0, np.int64)
        return np.sort(order[: below[-1] + 1])
    if mode == "fwe":
        return np.flatnonzero(p < threshold / d)
    raise ValueError(f"unknown selection mode {mode!r}")


class UnivariateFeatureSelector(_OnDevice, UnivariateFeatureSelectorParams,
                                Estimator[UnivariateFeatureSelectorModel]):
    """Scores each feature against the label with the test implied by
    (featureType, labelType) — chi-squared for categorical/categorical,
    ANOVA F for continuous/categorical, F-regression for
    continuous/continuous (categorical features with a continuous label are
    unsupported, as in Flink ML) — then keeps features by ``selectionMode``
    over the p-values."""

    def fit(self, *inputs) -> UnivariateFeatureSelectorModel:
        from ..stats.anovatest import anova_f_scores

        (table,) = inputs
        # param-system null check raises here if the types were never set
        ftype, ltype = self.get_feature_type(), self.get_label_type()
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        y = np.asarray(table[self.get_label_col()])

        if ftype == "categorical" and ltype == "categorical":
            p = _chi2_scores(X, y)
        elif ftype == "continuous" and ltype == "categorical":
            _, p, _, _ = anova_f_scores(X, y, self.device)
        elif ftype == "continuous" and ltype == "continuous":
            p = _f_regression_scores(X, y.astype(np.float64), self.device)
        else:
            raise ValueError(
                "categorical features with a continuous label are not "
                "supported (no test defined); index the label instead")

        indices = _select_by_mode(np.asarray(p, np.float64),
                                  self.get_selection_mode(),
                                  self.get_selection_threshold())
        model = self._model_of(UnivariateFeatureSelectorModel)
        model._indices = indices.astype(np.int64)
        return model
