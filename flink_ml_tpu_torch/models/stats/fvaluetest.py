"""FValueTest — F-regression test, continuous feature vs continuous label.

Member of the Flink ML 2.x stats surface (``org.apache.flink.ml.stats``
family alongside ChiSqTest and ANOVATest; the reference snapshot ships
none — SURVEY §2.8).  AlgoOperator: one output row per feature column
with (pValue, degreesOfFreedom, fValue), where
``F = r^2 / (1 - r^2) * (n - 2)`` from the Pearson correlation r.

Device split (same stance as ANOVATest): the O(n*d) correlation
reduction is one f32 pass on ``device`` (default ``"cuda"``); the F ratio
and its survival-function p-value finish on host in float64.

A port of the JAX package's ``models/stats/fvaluetest.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ...api.stage import AlgoOperator
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.shared import HasFeaturesCol, HasLabelCol
from ...utils.device import resolve_device
from ..feature.transforms import _OnDevice
from .anovatest import f_p_values

__all__ = ["FValueTest", "f_regression_scores"]


def _pearson_r(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    Xc = X - X.mean(dim=0, keepdim=True)
    yc = y - y.mean()
    num = Xc.T @ yc
    den = torch.sqrt((Xc * Xc).sum(dim=0) * (yc * yc).sum())
    return num / torch.clamp(den, min=1e-30)


def f_regression_scores(X: np.ndarray, y: np.ndarray, device="cuda"
                        ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(f_values (d,), p_values (d,), dfd) for continuous features X
    against a continuous label y: F = r^2/(1-r^2) * (n-2), dof (1, n-2);
    the correlation on ``device``."""
    dev = resolve_device(device)
    n, d = X.shape
    r = _pearson_r(
        torch.as_tensor(np.asarray(X, np.float32), device=dev),
        torch.as_tensor(np.asarray(y, np.float32), device=dev))
    r = np.clip(r.cpu().numpy().astype(np.float64), -1.0, 1.0)
    dfd = n - 2
    with np.errstate(divide="ignore", invalid="ignore"):
        # the 1e-300 floor keeps perfect correlation (r = +-1) FINITE and
        # astronomically large -> survival function underflows to p = 0;
        # a NaN r (degenerate input) stays NaN, which f_p_values maps to
        # p = 1 — so fValue and pValue always tell the same story
        f = r * r / np.maximum(1.0 - r * r, 1e-300) * dfd
    return f, f_p_values(f, np.ones(d), np.full(d, dfd)), dfd


class FValueTest(_OnDevice, HasFeaturesCol, HasLabelCol, AlgoOperator):
    """transform(table) -> one Table with a row per feature column:
    (featureIndex, pValue, degreesOfFreedom, fValue).  Features and label
    are continuous."""

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        y = np.asarray(table[self.get_label_col()], np.float64)
        f, p, dfd = f_regression_scores(X, y, self.device)
        d = X.shape[1]
        return [Table({
            "featureIndex": np.arange(d, dtype=np.int64),
            "pValue": np.asarray(p, np.float64),
            # the reference family reports numSamples - 2 here (the
            # denominator dof), unlike ANOVA's summed-dofs convention
            "degreesOfFreedom": np.full(d, dfd, np.int64),
            "fValue": np.asarray(f, np.float64),
        })]
