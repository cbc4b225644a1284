"""GBTRegressor — gradient-boosted trees, squared loss.

Member of the later Flink ML 2.x library line.  See
``models/common/gbt.py`` for the histogram trainer.  A port of the JAX
package's ``models/regression/gbtregressor.py``; every stage runs on
``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...data.table import Table
from ..common.gbt_stage import GBTEstimatorBase, GBTModelBase

__all__ = ["GBTRegressor", "GBTRegressorModel"]


class GBTRegressorModel(GBTModelBase):
    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        return [table.with_column(self.get_prediction_col(),
                                  self._margins(table))]


class GBTRegressor(GBTEstimatorBase):
    model_cls = GBTRegressorModel

    def _prepare_labels(self, y_raw: np.ndarray):
        return np.asarray(y_raw, np.float64), None

    def _grad_hess(self, y, pred):
        return pred - y, np.ones_like(pred)

    def _base_score(self, y) -> float:
        return float(y.mean())
