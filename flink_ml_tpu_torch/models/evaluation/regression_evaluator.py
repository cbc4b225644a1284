"""RegressionEvaluator — RMSE / MSE / MAE / R².

Companion to the binary/multiclass evaluators (the Flink ML 2.x evaluation
surface).  All metrics are one host float64 pass over (label, prediction) —
exact accumulation; a device f32 sum loses precision on the squared-error
scale long before the transfer cost is repaid.

A copy of the JAX package's
``models/evaluation/regression_evaluator.py`` (host numpy; no device).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...api.stage import AlgoOperator
from ...data.table import Table
from ...params.param import StringArrayParam
from ...params.shared import HasLabelCol, HasPredictionCol, HasWeightCol

__all__ = ["RegressionEvaluator"]

_SUPPORTED = ("rmse", "mse", "mae", "r2")


class RegressionEvaluator(HasLabelCol, HasPredictionCol, HasWeightCol,
                          AlgoOperator):
    """transform(table) -> one Table row with the requested metrics.
    Weighted variants use the weight column when set (weighted means in
    every formula; R² uses the weighted label mean)."""

    METRICS = StringArrayParam(
        "metricsNames", "Metrics to compute.",
        default=("rmse", "r2"),
        validator=lambda v: v is not None and all(m in _SUPPORTED for m in v))

    def set_metrics(self, *names: str):
        return self.set(RegressionEvaluator.METRICS, names)

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        y = np.asarray(table[self.get_label_col()], np.float64)
        pred = np.asarray(table[self.get_prediction_col()], np.float64)
        if len(y) != len(pred):
            raise ValueError("label/prediction length mismatch")
        if len(y) == 0:
            raise ValueError("RegressionEvaluator needs at least one row")
        wcol = self.get_weight_col()
        w = (np.asarray(table[wcol], np.float64) if wcol
             else np.ones_like(y))
        wsum = w.sum()
        if wsum <= 0:
            raise ValueError("weights sum to zero")

        err = pred - y
        mse = float((w * err * err).sum() / wsum)
        mae = float((w * np.abs(err)).sum() / wsum)
        y_mean = (w * y).sum() / wsum
        ss_tot = float((w * (y - y_mean) ** 2).sum())
        ss_res = float((w * err * err).sum())
        # all-constant labels: perfect fit -> 1, anything else -> 0 (the
        # degenerate-variance convention)
        r2 = (1.0 - ss_res / ss_tot if ss_tot > 0
              else (1.0 if ss_res == 0 else 0.0))

        values = {"mse": mse, "rmse": float(np.sqrt(mse)), "mae": mae,
                  "r2": r2}
        names = self.get(RegressionEvaluator.METRICS)
        return [Table({name: np.asarray([values[name]]) for name in names})]
