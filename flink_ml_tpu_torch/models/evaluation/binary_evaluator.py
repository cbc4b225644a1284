"""BinaryClassificationEvaluator — AUC-ROC / AUC-PR / accuracy as an
AlgoOperator (evaluation is a table -> metrics-table mapping, the Flink ML
evaluator shape).  The ROC integral is computed on ``device``: one stable
sort of the f32 scores, then the cumulative counts and the integrals in
float64 (exact counts, and sums that agree across devices far below the
metrics' own resolution).

A port of the JAX package's ``models/evaluation/binary_evaluator.py``,
which sums in f32.  Runs on ``device`` (default ``"cuda"``; raises
without a card unless ``"cpu"`` is asked for).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...api.stage import AlgoOperator
from ...data.table import Table
from ...params.param import StringArrayParam
from ...params.shared import HasLabelCol, HasRawPredictionCol
from ...utils.device import resolve_device

__all__ = ["BinaryClassificationEvaluator"]

_SUPPORTED = ("areaUnderROC", "areaUnderPR", "accuracy")


def _binary_metrics(scores: torch.Tensor, labels: torch.Tensor):
    """``(auc_roc, auc_pr, accuracy)`` of f32 ``scores`` against {0, 1}
    ``labels``, as Python floats."""
    s_sorted_neg, order = torch.sort(-scores, stable=True)   # descending
    y = labels[order].to(torch.float64)
    pos = torch.sum(y)
    neg = y.shape[0] - pos
    tp = torch.cumsum(y, 0)
    fp = torch.cumsum(1.0 - y, 0)
    # Tied scores form ONE ROC/PR point: each row takes the counts at the
    # END of its tie group (rightmost equal score), so the integrals
    # collapse to the group boundaries.
    group_end = torch.searchsorted(s_sorted_neg, s_sorted_neg,
                                   right=True) - 1
    tp_g, fp_g = tp[group_end], fp[group_end]
    tpr = tp_g / torch.clamp(pos, min=1.0)
    fpr = fp_g / torch.clamp(neg, min=1.0)
    precision = tp_g / torch.clamp(tp_g + fp_g, min=1.0)
    zero = torch.zeros(1, dtype=torch.float64, device=scores.device)
    tpr_prev = torch.cat([zero, tpr[:-1]])
    fpr_prev = torch.cat([zero, fpr[:-1]])
    auc_roc = torch.sum((fpr - fpr_prev) * (tpr + tpr_prev) / 2)
    auc_pr = torch.sum((tpr - tpr_prev) * precision)
    accuracy = torch.mean(((scores > 0.5) == (labels > 0.5)).to(
        torch.float64))
    return float(auc_roc), float(auc_pr), float(accuracy)


class BinaryClassificationEvaluator(HasLabelCol, HasRawPredictionCol,
                                    AlgoOperator):
    METRICS = StringArrayParam(
        "metricsNames", "Metrics to compute.",
        default=("areaUnderROC", "areaUnderPR"),
        validator=lambda v: v is not None and all(m in _SUPPORTED for m in v))

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device

    def set_metrics(self, *names: str):
        return self.set(BinaryClassificationEvaluator.METRICS, names)

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        dev = resolve_device(self.device)
        scores = np.asarray(table[self.get_raw_prediction_col()], np.float32)
        labels = np.asarray(table[self.get_label_col()], np.float32)
        if scores.ndim != 1:
            raise ValueError("rawPrediction column must be scalar scores")
        auc_roc, auc_pr, acc = _binary_metrics(
            torch.from_numpy(scores).to(dev), torch.from_numpy(labels).to(dev))
        values = {"areaUnderROC": auc_roc, "areaUnderPR": auc_pr,
                  "accuracy": acc}
        names = self.get(BinaryClassificationEvaluator.METRICS)
        return [Table({name: np.asarray([values[name]]) for name in names})]
