"""Shared Estimator/Model plumbing for GBTClassifier / GBTRegressor.

A port of the JAX package's ``models/common/gbt_stage.py``.  Every stage
runs on ``device`` (default ``"cuda"``; raises without a card unless
``"cpu"`` is asked for).  The device is a runtime choice, not a param, so
it is not saved; ``load(path, device=)`` places a loaded model."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...api.stage import Estimator, Model
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.param import FloatParam, IntParam, ParamValidators
from ...params.shared import (
    HasFeaturesCol,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasPredictionCol,
)
from ...utils import persist
from .gbt import Forest, GBTConfig, predict_forest, train_forest

__all__ = ["GBTParams", "GBTModelBase", "GBTEstimatorBase"]


class GBTModelParams(HasFeaturesCol, HasPredictionCol):
    pass


class GBTParams(GBTModelParams, HasLabelCol, HasMaxIter, HasLearningRate):
    """``maxIter`` = number of trees (the boosting iterations);
    ``learningRate`` = shrinkage.  No seed: training is fully deterministic
    (no row/feature subsampling yet)."""

    REG_LAMBDA = FloatParam(
        "regLambda", "Leaf L2 regularization (XGBoost lambda).", default=1.0,
        validator=ParamValidators.gt_eq(0))

    def get_reg_lambda(self) -> float:
        return self.get(GBTParams.REG_LAMBDA)

    def set_reg_lambda(self, value: float):
        return self.set(GBTParams.REG_LAMBDA, value)

    MAX_DEPTH = IntParam("maxDepth", "Tree depth (internal levels).",
                         default=4, validator=ParamValidators.in_range(1, 12))
    MAX_BINS = IntParam("maxBins", "Histogram bins per feature.", default=64,
                        validator=ParamValidators.in_range(2, 256))
    MIN_CHILD_WEIGHT = FloatParam(
        "minChildWeight", "Minimum hessian sum per child.", default=1e-3,
        validator=ParamValidators.gt_eq(0))

    def get_max_depth(self) -> int:
        return self.get(GBTParams.MAX_DEPTH)

    def set_max_depth(self, value: int):
        return self.set(GBTParams.MAX_DEPTH, value)

    def get_max_bins(self) -> int:
        return self.get(GBTParams.MAX_BINS)

    def set_max_bins(self, value: int):
        return self.set(GBTParams.MAX_BINS, value)


class GBTModelBase(GBTModelParams, Model):
    """Holds the Forest arrays; subclasses map margins to predictions.

    Not chainable (no ``transform_kernel``): the shared predict entry
    points (``predict_forest[_softmax]``) accumulate tree margins in
    float64 on the HOST — an in-segment f32 accumulation could not stay
    bit-exact with them, so in a fused pipeline GBT breaks the chain and
    scores through its own (bucket-padded) entry points."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self._forest: Optional[Forest] = None

    def _margins(self, table: Table) -> np.ndarray:
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        return predict_forest(X, self._forest, device=self.device)

    def _require_model(self) -> None:
        if self._forest is None:
            raise RuntimeError(
                f"{type(self).__name__} has no model data; call "
                "set_model_data() or fit the estimator first")

    # -- model data ---------------------------------------------------------
    def set_model_data(self, *inputs) -> "GBTModelBase":
        (t,) = inputs
        self._forest = Forest(
            feature=np.asarray(t["feature"], np.int32),
            threshold=np.asarray(t["threshold"], np.int32),
            value=np.asarray(t["value"], np.float32),
            bin_edges=np.asarray(t["binEdges"][0], np.float64),
            base_score=float(np.asarray(t["baseScore"])[0]),
            learning_rate=float(np.asarray(t["learningRate"])[0]),
        )
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        f = self._forest
        n_trees = f.feature.shape[0]
        return [Table({
            "feature": f.feature, "threshold": f.threshold, "value": f.value,
            "binEdges": np.broadcast_to(
                f.bin_edges[None], (n_trees,) + f.bin_edges.shape).copy(),
            "baseScore": np.full((n_trees,), f.base_score),
            "learningRate": np.full((n_trees,), f.learning_rate),
        })]

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        f = self._forest
        persist.save_model_arrays(path, "model", {
            "feature": f.feature, "threshold": f.threshold, "value": f.value,
            "binEdges": f.bin_edges,
            "scalars": np.asarray([f.base_score, f.learning_rate])})

    @classmethod
    def load(cls, path: str, device="cuda"):
        """Load a model saved by this package or by the JAX package."""
        model = persist.load_stage_param(path)
        model.device = device
        data = persist.load_model_arrays(path, "model")
        model._forest = Forest(
            feature=data["feature"].astype(np.int32),
            threshold=data["threshold"].astype(np.int32),
            value=data["value"].astype(np.float32),
            bin_edges=data["binEdges"].astype(np.float64),
            base_score=float(data["scalars"][0]),
            learning_rate=float(data["scalars"][1]),
        )
        return model


class GBTEstimatorBase(GBTParams, Estimator):
    """Subclasses define ``_prepare_labels`` (-> float targets + label map),
    ``_grad_hess``, ``_base_score``, and ``model_cls``."""

    model_cls: type

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device

    def _config(self) -> GBTConfig:
        return GBTConfig(
            num_trees=self.get_max_iter(),
            max_depth=self.get_max_depth(),
            learning_rate=self.get_learning_rate(),
            max_bins=self.get_max_bins(),
            reg_lambda=self.get_reg_lambda(),
            min_child_weight=self.get(GBTParams.MIN_CHILD_WEIGHT),
        )

    def _new_model(self):
        model = self.model_cls(device=self.device)
        model.copy_params_from(self)
        return model

    def fit(self, *inputs):
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        if len(X) == 0:
            raise ValueError(f"{type(self).__name__}.fit requires rows")
        # Label values thread through fit (never stored on the estimator):
        # concurrent fits on one estimator stay independent.
        y, label_values = self._prepare_labels(
            np.asarray(table[self.get_label_col()]))
        forest = train_forest(X, y, self._grad_hess, self._base_score(y),
                              self._config(), device=self.device)
        model = self._new_model()
        model._forest = forest
        self._finalize_model(model, label_values)
        return model

    def fit_outofcore(self, make_reader, *, features_key: str = None,
                      label_key: str = None, work_dir: str = None,
                      sample_rows: int = 1 << 18):
        """Out-of-core ``fit`` (see ``gbt.train_forest_outofcore``): the
        dataset streams from ``make_reader()`` — a fresh iterator of host
        batch dicts per call (``{features_key: (b, d) float, label_key:
        (b,) labels}``, e.g. a re-seeked ``DataCacheReader``) — instead
        of living in RAM; per-row state is one f64 margin memmap.

        Binary-classification label note: the streamed labels must
        already be 0/1 floats (the in-core fit's arbitrary-label mapping
        needs the full label set up front)."""
        from .gbt import train_forest_outofcore

        def prepared_reader():
            for batch in make_reader():
                y = self._streaming_labels(
                    np.asarray(batch[label_key or self.get_label_col()]))
                yield {"features": np.asarray(
                    batch[features_key or self.get_features_col()]),
                    "label": y}

        # base score folds into the trainer's pass A over the same
        # leading sample (no extra head read of a slow source)
        forest = train_forest_outofcore(
            prepared_reader, self._grad_hess, self._base_score,
            self._config(), work_dir=work_dir, sample_rows=sample_rows,
            device=self.device)
        model = self._new_model()
        model._forest = forest
        self._finalize_model(model, self._streaming_label_values())
        return model

    def _streaming_labels(self, y_raw: np.ndarray) -> np.ndarray:
        """Per-batch label prep for fit_outofcore.  Unlike
        ``_prepare_labels``, this must be BATCH-LOCAL (no global label
        inventory); the default passes float targets through."""
        return np.asarray(y_raw, np.float64)

    def _streaming_label_values(self):
        """Label set installed on the streamed-fit model (None for
        regressors)."""
        return None

    def _finalize_model(self, model, label_values) -> None:
        """Hook for subclasses (e.g. install the label mapping)."""

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)

    @classmethod
    def load(cls, path: str, device="cuda"):
        stage = persist.load_stage_param(path)
        stage.device = device
        return stage
