"""SoftmaxRegression — multinomial logistic regression.

The binary LogisticRegression generalized to K classes: the dense SGD core
(:func:`~flink_ml_tpu_torch.models.common.sgd.sgd_fit_params`) with ``W``
a ``(features, classes)`` matrix, scores ``X @ W + b`` and a weighted
cross-entropy loss.  A port of the JAX package's
``models/classification/softmaxregression.py``; model directories saved by
either package load in the other's layout.  Every stage runs on ``device``
(default ``"cuda"``; raises without a card unless ``"cpu"`` is asked
for).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.stage import Estimator, Model
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.shared import (
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasPredictionCol,
    HasRawPredictionCol,
    HasRegParam,
    HasSeed,
    HasTol,
    HasWeightCol,
)
from ...utils import persist
from ...utils.device import resolve_device
from ..common.losses import _weighted_mean
from ..common.sgd import SGDConfig, sgd_fit_params

__all__ = ["SoftmaxRegression", "SoftmaxRegressionModel",
           "softmax_xent_loss"]


def softmax_xent_loss(scores, labels, weights):
    """Weighted cross-entropy; ``labels`` arrive as f32 class ids (the SGD
    epoch tensor's dtype) and are cast back to indices here."""
    logp = torch.log_softmax(scores, dim=-1)
    idx = labels.to(torch.int64)
    nll = -torch.gather(logp, 1, idx[:, None])[:, 0]
    return _weighted_mean(nll, weights)


class SoftmaxRegressionModelParams(HasFeaturesCol, HasPredictionCol,
                                   HasRawPredictionCol):
    pass


class SoftmaxRegressionParams(SoftmaxRegressionModelParams, HasLabelCol,
                              HasWeightCol, HasMaxIter, HasLearningRate,
                              HasRegParam, HasGlobalBatchSize, HasTol,
                              HasSeed):
    pass


class SoftmaxRegressionModel(SoftmaxRegressionModelParams, Model):
    """Prediction = original label value of the argmax class; the raw
    prediction column holds the full per-class probability vectors."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self._weights: Optional[np.ndarray] = None   # (features, classes)
        self._bias: Optional[np.ndarray] = None      # (classes,)
        self._labels: Optional[np.ndarray] = None    # original label values

    def set_model_data(self, *inputs) -> "SoftmaxRegressionModel":
        (t,) = inputs
        self._weights = np.asarray(t["coefficients"][0], np.float64)
        self._bias = np.asarray(t["intercepts"][0], np.float64)
        self._labels = np.asarray(t["labels"][0])
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"coefficients": self._weights[None],
                       "intercepts": self._bias[None],
                       "labels": self._labels[None]})]

    @property
    def loss_log(self) -> list:
        """Per-epoch training loss recorded by fit (empty when the model
        was built from set_model_data/load rather than trained)."""
        return list(getattr(self, "_loss_log", []) or [])

    def _require_model(self) -> None:
        if self._weights is None:
            raise RuntimeError(
                "SoftmaxRegressionModel has no model data; call "
                "set_model_data() or fit a SoftmaxRegression first")

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        dev = resolve_device(self.device)
        X = stack_vectors(table[self.get_features_col()])
        probs = torch.softmax(
            torch.as_tensor(X, dtype=torch.float32, device=dev)
            @ torch.as_tensor(self._weights, dtype=torch.float32, device=dev)
            + torch.as_tensor(self._bias, dtype=torch.float32, device=dev),
            dim=-1).cpu().numpy()
        pred = self._labels[np.argmax(probs, axis=1)]
        out = table.with_column(self.get_prediction_col(), pred)
        return [out.with_column(self.get_raw_prediction_col(),
                                probs.astype(np.float64))]

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {
            "coefficients": self._weights, "intercepts": self._bias,
            "labels": self._labels})

    @classmethod
    def load(cls, path: str, device="cuda") -> "SoftmaxRegressionModel":
        """Load a model saved by this package or by the JAX package."""
        model = persist.load_stage_param(path)
        if not isinstance(model, cls):
            raise IOError(f"Stage at {path} is a {type(model).__name__}, "
                          f"not a {cls.__name__}")
        model.device = device
        data = persist.load_model_arrays(path, "model")
        model._weights = data["coefficients"].astype(np.float64)
        model._bias = data["intercepts"].astype(np.float64)
        model._labels = data["labels"]
        return model


class SoftmaxRegression(SoftmaxRegressionParams,
                        Estimator[SoftmaxRegressionModel]):
    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device

    def fit(self, *inputs) -> SoftmaxRegressionModel:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()]).astype(np.float32)
        y_raw = np.asarray(table[self.get_label_col()])
        labels, y = np.unique(y_raw, return_inverse=True)
        if len(labels) < 2:
            raise ValueError("SoftmaxRegression requires >= 2 distinct "
                             f"label values, got {len(labels)}")
        sample_w = (np.asarray(table[self.get_weight_col()], np.float64)
                    if self.get_weight_col() else None)

        d, c = X.shape[1], len(labels)
        config = SGDConfig(
            learning_rate=self.get_learning_rate(),
            reg=self.get_reg(),
            global_batch_size=self.get_global_batch_size(),
            max_epochs=self.get_max_iter(),
            tol=self.get_tol(),
            seed=self.get_seed(),
        )
        params, loss_log = sgd_fit_params(
            softmax_xent_loss, X, y.astype(np.float64), sample_w, config,
            self.device, init_params={"w": np.zeros((d, c), np.float32),
                                      "b": np.zeros((c,), np.float32)})

        model = SoftmaxRegressionModel(device=self.device)
        model.copy_params_from(self)
        model.set_model_data(Table({
            "coefficients": np.asarray(params["w"], np.float64)[None],
            "intercepts": np.asarray(params["b"], np.float64)[None],
            "labels": labels[None]}))
        model._loss_log = loss_log
        return model

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "SoftmaxRegression":
        stage = persist.load_stage_param(path)
        stage.device = device
        return stage
