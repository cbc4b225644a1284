"""LogisticRegression — binary classifier, bounded-iteration SGD.

Capability target from BASELINE.json config 1 ("LogisticRegression (binary,
bounded-iteration SGD)"), with the param surface of flink-ml's linear
models.  The training loop is the shared SGD skeleton
(:mod:`flink_ml_tpu_torch.models.common.sgd`); weights stay in device
memory across epochs.
"""

from __future__ import annotations

import numpy as np

from ..common.linear import LinearEstimatorBase, LinearModelBase

__all__ = ["LogisticRegression", "LogisticRegressionModel"]


def _sigmoid(m: np.ndarray) -> np.ndarray:
    out = np.empty_like(m)
    pos = m >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-m[pos]))
    e = np.exp(m[~pos])
    out[~pos] = e / (1.0 + e)
    return out


class LogisticRegressionModel(LinearModelBase):
    loss_name = "logistic"

    def _decision(self, margins: np.ndarray) -> np.ndarray:
        return (margins > 0).astype(np.int64)

    def _raw(self, margins: np.ndarray) -> np.ndarray:
        """Probability of the positive class."""
        return _sigmoid(margins)


class LogisticRegression(LinearEstimatorBase):
    """Labels are {0, 1} (converted to +-1 inside the logistic loss)."""

    loss_name = "logistic"
    model_cls = LogisticRegressionModel
