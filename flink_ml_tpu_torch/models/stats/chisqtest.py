"""ChiSqTest — Pearson's chi-squared independence test, feature vs label.

Member of the Flink ML 2.x stats surface.  AlgoOperator: one output row per
feature column with (pValue, degreesOfFreedom, statistic).

Contingency tables and statistics are exact host ``np.bincount`` integer
counts (tiny work; a per-feature jitted kernel would recompile for every
distinct (levels, labels) shape and sync three times per feature); the
p-values are the chi^2 survival function ``Q(df/2, x/2)`` evaluated on the
host in float64 (``scipy.special.gammaincc``) — the output column is
float64-typed and must carry genuine float64 precision, which a device f32
evaluation caps at ~1e-7 and flushes tiny p-values to 0.

A copy of the JAX package's ``models/stats/chisqtest.py`` (host work, no
``device``).
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy.special import gammaincc

from ...api.stage import AlgoOperator
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.shared import HasFeaturesCol, HasLabelCol

__all__ = ["ChiSqTest"]


def _chi2_from_contingency(table: np.ndarray):
    """(r, c) observed counts -> (statistic, dof), exact host arithmetic."""
    total = table.sum()
    expected = (table.sum(1, keepdims=True) * table.sum(0, keepdims=True)
                / max(total, 1.0))
    # cells with zero expectation contribute nothing (their observed is 0
    # too, since a zero row/col sum forces zero observed)
    diff = table - expected
    stat = float(np.where(expected > 0,
                          diff * diff / np.maximum(expected, 1e-12),
                          0.0).sum())
    r_eff = int(np.any(table > 0, axis=1).sum())
    c_eff = int(np.any(table > 0, axis=0).sum())
    return stat, max((r_eff - 1) * (c_eff - 1), 0)


def _p_values(stats: np.ndarray, dofs: np.ndarray) -> np.ndarray:
    """Survival function of chi^2_dof at stat, vectorized over features in
    host float64: Q(dof/2, stat/2)."""
    stats = np.asarray(stats, np.float64)
    dofs = np.asarray(dofs, np.float64)
    return np.where(dofs > 0,
                    gammaincc(np.maximum(dofs, 1.0) / 2.0, stats / 2.0),
                    1.0)


class ChiSqTest(HasFeaturesCol, HasLabelCol, AlgoOperator):
    """transform(table) -> one Table with a row per feature column:
    (featureIndex, pValue, degreesOfFreedom, statistic).  Features and label
    must be categorical (their distinct values index the contingency
    table)."""

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()])
        y_raw = np.asarray(table[self.get_label_col()])
        _, y = np.unique(y_raw, return_inverse=True)
        n_label = int(y.max()) + 1 if len(y) else 0

        stats, dofs = [], []
        for j in range(X.shape[1]):
            _, xj = np.unique(X[:, j], return_inverse=True)
            n_feat = int(xj.max()) + 1 if len(xj) else 0
            contingency = np.bincount(
                xj * n_label + y, minlength=n_feat * n_label).reshape(
                    n_feat, n_label).astype(np.float64)
            stat, dof = _chi2_from_contingency(contingency)
            stats.append(stat)
            dofs.append(dof)

        ps = (_p_values(np.asarray(stats), np.asarray(dofs)) if stats
              else np.zeros(0))

        return [Table({
            "featureIndex": np.arange(X.shape[1], dtype=np.int64),
            "pValue": np.asarray(ps, np.float64),
            "degreesOfFreedom": np.asarray(dofs, np.int64),
            "statistic": np.asarray(stats, np.float64),
        })]
