"""Multinomial Naive Bayes.

Part of the early Flink ML 2.x library surface (the reference snapshot ships
only KMeans, but the lib module is explicitly "the algorithm library" —
SURVEY §2.8).  Smoothing-adjusted log-likelihoods are a (classes,
features) matrix, so scoring a batch is one product
``X @ log_theta.T + log_prior`` (f32, on ``device``).

A port of the JAX package's ``models/classification/naivebayes.py``.  The
fit is host numpy; the model scores on ``device`` (default ``"cuda"``;
raises without a card unless ``"cpu"`` is asked for).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.stage import Estimator, Model
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.param import FloatParam, ParamValidators
from ...params.shared import HasFeaturesCol, HasLabelCol, HasPredictionCol
from ...utils import persist
from ...utils.device import resolve_device

__all__ = ["NaiveBayes", "NaiveBayesModel"]


class NaiveBayesParams(HasFeaturesCol, HasLabelCol, HasPredictionCol):
    SMOOTHING = FloatParam("smoothing", "Laplace smoothing.", default=1.0,
                           validator=ParamValidators.gt_eq(0))

    def get_smoothing(self) -> float:
        return self.get(NaiveBayesParams.SMOOTHING)

    def set_smoothing(self, value: float):
        return self.set(NaiveBayesParams.SMOOTHING, value)


def _scores(X, log_theta, log_prior):
    # With smoothing=0, log_theta holds -inf for zero-count features and a
    # zero count must contribute 0 — but 0 * -inf = nan through the matmul.
    # Clamping -inf to the most-negative finite float keeps the single
    # product: count 0 contributes exactly 0, while a positive count
    # scores the class at or near the lowest float (the "impossible
    # class" score).
    log_theta = torch.clamp_min(log_theta, torch.finfo(log_theta.dtype).min)
    return X @ log_theta.T + log_prior[None, :]


class NaiveBayesModel(NaiveBayesParams, Model):
    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self._log_theta: Optional[np.ndarray] = None   # (classes, features)
        self._log_prior: Optional[np.ndarray] = None   # (classes,)
        self._labels: Optional[np.ndarray] = None      # original label values

    def set_model_data(self, *inputs) -> "NaiveBayesModel":
        (t,) = inputs
        self._log_theta = np.asarray(t["logTheta"][0], np.float64)
        self._log_prior = np.asarray(t["logPrior"][0], np.float64)
        self._labels = np.asarray(t["labels"][0])
        return self

    def _require_model(self) -> None:
        if self._log_theta is None:
            raise RuntimeError("NaiveBayesModel has no model data; call "
                               "set_model_data() or fit a NaiveBayes first")

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"logTheta": self._log_theta[None],
                       "logPrior": self._log_prior[None],
                       "labels": self._labels[None]})]

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        X = stack_vectors(table[self.get_features_col()]).astype(np.float32)
        if np.any(X < 0):
            raise ValueError("Multinomial NaiveBayes requires non-negative "
                             "features (counts)")
        dev = resolve_device(self.device)

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        scores = _scores(put(X), put(self._log_theta),
                         put(self._log_prior)).cpu().numpy()
        pred = self._labels[np.argmax(scores, axis=1)]
        return [table.with_column(self.get_prediction_col(), pred)]

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {
            "logTheta": self._log_theta, "logPrior": self._log_prior,
            "labels": self._labels})

    @classmethod
    def load(cls, path: str, device="cuda") -> "NaiveBayesModel":
        model = persist.load_stage_param(path)
        model.device = device
        data = persist.load_model_arrays(path, "model")
        model._log_theta = data["logTheta"].astype(np.float64)
        model._log_prior = data["logPrior"].astype(np.float64)
        model._labels = data["labels"]
        return model


class NaiveBayes(NaiveBayesParams, Estimator[NaiveBayesModel]):
    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device

    def fit(self, *inputs) -> NaiveBayesModel:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()])
        if np.any(X < 0):
            raise ValueError("Multinomial NaiveBayes requires non-negative "
                             "features (counts)")
        y = np.asarray(table[self.get_label_col()])
        labels, inverse = np.unique(y, return_inverse=True)
        smoothing = self.get_smoothing()

        n_classes, n_features = len(labels), X.shape[1]
        counts = np.zeros((n_classes, n_features))
        np.add.at(counts, inverse, X)
        class_counts = np.bincount(inverse, minlength=n_classes)

        theta_num = counts + smoothing
        theta_den = counts.sum(axis=1, keepdims=True) + smoothing * n_features
        with np.errstate(divide="ignore"):
            # smoothing=0 legitimately yields log(0) = -inf: an unseen
            # feature/class pair has exactly zero likelihood, and -inf scores
            # propagate correctly through the argmax (tested).
            log_theta = np.log(theta_num) - np.log(theta_den)
            log_prior = np.log(class_counts) - np.log(class_counts.sum())

        model = NaiveBayesModel(device=self.device)
        model.copy_params_from(self)
        model._log_theta = log_theta
        model._log_prior = log_prior
        model._labels = labels
        return model

    @classmethod
    def load(cls, path: str, device="cuda") -> "NaiveBayes":
        stage = persist.load_stage_param(path)
        stage.device = device
        return stage
