"""MulticlassClassificationEvaluator — accuracy / weighted F-measure.

Companion to the binary evaluator (the Flink ML 2.x evaluation surface).
All metrics derive from the (classes, classes) confusion matrix, computed
with one host ``np.bincount`` over the joint (true, predicted) key — exact
integer counts at any n (a one-hot f32 matmul loses exactness past 2^24
rows per cell and materializes O(n*classes) memory for no device win).

A copy of the JAX package's
``models/evaluation/multiclass_evaluator.py`` (host numpy; no device).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...api.stage import AlgoOperator
from ...data.table import Table
from ...params.param import StringArrayParam
from ...params.shared import HasLabelCol, HasPredictionCol

__all__ = ["MulticlassClassificationEvaluator"]

_SUPPORTED = ("accuracy", "weightedPrecision", "weightedRecall",
              "weightedFMeasure")


def _metrics(conf: np.ndarray) -> dict:
    total = conf.sum()
    tp = np.diag(conf)
    per_pred = conf.sum(axis=0)             # predicted-count per class
    per_true = conf.sum(axis=1)             # support per class
    precision = np.where(per_pred > 0, tp / np.maximum(per_pred, 1), 0.0)
    recall = np.where(per_true > 0, tp / np.maximum(per_true, 1), 0.0)
    f1 = np.where(precision + recall > 0,
                  2 * precision * recall
                  / np.maximum(precision + recall, 1e-12), 0.0)
    weights = per_true / max(total, 1)
    return {
        "accuracy": float(tp.sum() / max(total, 1)),
        "weightedPrecision": float((weights * precision).sum()),
        "weightedRecall": float((weights * recall).sum()),
        "weightedFMeasure": float((weights * f1).sum()),
    }


class MulticlassClassificationEvaluator(HasLabelCol, HasPredictionCol,
                                        AlgoOperator):
    METRICS = StringArrayParam(
        "metricsNames", "Metrics to compute.",
        default=("accuracy", "weightedFMeasure"),
        validator=lambda v: v is not None and all(m in _SUPPORTED for m in v))

    def set_metrics(self, *names: str):
        return self.set(MulticlassClassificationEvaluator.METRICS, names)

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        labels = np.asarray(table[self.get_label_col()])
        preds = np.asarray(table[self.get_prediction_col()])
        if len(labels) != len(preds):
            raise ValueError("label/prediction length mismatch")
        # joint class space: predictions outside the label set still count
        classes, _ = np.unique(np.concatenate([labels, preds]),
                               return_inverse=True)
        y = np.searchsorted(classes, labels)
        p = np.searchsorted(classes, preds)
        c = len(classes)
        conf = np.bincount(y * c + p, minlength=c * c).reshape(c, c)
        conf = conf.astype(np.float64)      # [true, predicted]
        values = _metrics(conf)
        names = self.get(MulticlassClassificationEvaluator.METRICS)
        return [Table({name: np.asarray([values[name]]) for name in names})]
