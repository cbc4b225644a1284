"""LinearRegression — least-squares regression via the shared SGD skeleton.

BASELINE.json config 3 (flink-ml-lib regressors)."""

from __future__ import annotations

import numpy as np

from ..common.linear import LinearEstimatorBase, LinearModelBase

__all__ = ["LinearRegression", "LinearRegressionModel"]


class LinearRegressionModel(LinearModelBase):
    loss_name = "squared"

    def _decision(self, margins: np.ndarray) -> np.ndarray:
        return margins  # the prediction IS the margin


class LinearRegression(LinearEstimatorBase):
    loss_name = "squared"
    model_cls = LinearRegressionModel
