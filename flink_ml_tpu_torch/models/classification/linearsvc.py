"""LinearSVC — linear support-vector classifier (hinge loss).

BASELINE.json config 3; same SGD skeleton as LogisticRegression.
Decision threshold on the margin is configurable (flink-ml's
``HasThreshold``-style param)."""

from __future__ import annotations

import numpy as np

from ...params.param import FloatParam
from ..common.linear import LinearEstimatorBase, LinearModelBase

__all__ = ["LinearSVC", "LinearSVCModel"]


class _HasThreshold:
    THRESHOLD = FloatParam(
        "threshold", "Decision threshold on the margin.", default=0.0)

    def get_threshold(self) -> float:
        return self.get(_HasThreshold.THRESHOLD)

    def set_threshold(self, value: float):
        return self.set(_HasThreshold.THRESHOLD, value)


class LinearSVCModel(_HasThreshold, LinearModelBase):
    loss_name = "hinge"

    def _decision(self, margins: np.ndarray) -> np.ndarray:
        return (margins > self.get_threshold()).astype(np.int64)


class LinearSVC(_HasThreshold, LinearEstimatorBase):
    """Labels are {0, 1} (converted to +-1 inside the hinge loss)."""

    loss_name = "hinge"
    model_cls = LinearSVCModel
