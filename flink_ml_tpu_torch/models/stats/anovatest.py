"""ANOVATest — one-way analysis-of-variance F-test, feature vs label.

Member of the Flink ML 2.x stats surface (the reference snapshot's lib is
KMeans-only — SURVEY §2.8; this mirrors the library line's
``org.apache.flink.ml.stats`` package).  AlgoOperator: one output row per
feature column with (pValue, degreesOfFreedom, fValue).

Device split: the O(n*d*k) per-class reductions are two one-hot matrix
products on ``device`` (labels one-hot (n,k) against the globally-centered
features and their squares — centering first keeps the f32 sums
cancellation-safe), while the final F ratio and its survival-function
p-value run on host in float64 (same stance as ChiSqTest: the p-value
column must carry true float64 precision).

A port of the JAX package's ``models/stats/anovatest.py``.  The products
are full-f32 ``torch.matmul`` (PyTorch leaves TF32 off by default; this
module does not turn it on).  The f32 sums run in another order than
XLA's, so F values agree with the JAX package's to f32 rounding, not bit
for bit.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from scipy.special import fdtrc

from ...api.stage import AlgoOperator
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.shared import HasFeaturesCol, HasLabelCol
from ...utils.device import resolve_device
from ..feature.transforms import _OnDevice

__all__ = ["ANOVATest", "anova_f_scores", "f_p_values"]


def _class_moments(X: torch.Tensor, onehot: torch.Tensor):
    """Center features globally, then per-class sum / sum-of-squares via
    one-hot products: returns (counts (k,), s (k,d), sq (k,d),
    total_sq (d,))."""
    Xc = X - X.mean(dim=0, keepdim=True)
    Xc2 = Xc * Xc
    s = onehot.T @ Xc                      # (k, d) per-class sums
    sq = onehot.T @ Xc2                    # (k, d) per-class sq sums
    counts = onehot.sum(dim=0)             # (k,)
    return counts, s, sq, Xc2.sum(dim=0)


def f_p_values(f: np.ndarray, dfn: np.ndarray, dfd: np.ndarray) -> np.ndarray:
    """Survival function of F(dfn, dfd) at f, host float64."""
    f = np.asarray(f, np.float64)
    valid = (np.asarray(dfn) > 0) & (np.asarray(dfd) > 0) & np.isfinite(f)
    return np.where(valid,
                    fdtrc(np.maximum(dfn, 1), np.maximum(dfd, 1),
                          np.maximum(f, 0.0)),
                    1.0)


def anova_f_scores(X: np.ndarray, y: np.ndarray, device="cuda"
                   ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(f_values (d,), p_values (d,), dfn, dfd) for continuous features X
    against categorical labels y; the class moments on ``device``."""
    dev = resolve_device(device)
    X = np.asarray(X, np.float64)
    _, y_idx = np.unique(np.asarray(y), return_inverse=True)
    n, d = X.shape
    k = int(y_idx.max()) + 1 if n else 0
    if k < 2 or n - k < 1:
        ones = np.ones(d)
        return np.zeros(d), ones, max(k - 1, 0), max(n - k, 0)

    onehot = torch.as_tensor(np.eye(k, dtype=np.float32)[y_idx], device=dev)
    moments = _class_moments(
        torch.as_tensor(X.astype(np.float32), device=dev), onehot)
    counts, s, sq, total_sq = (a.cpu().numpy().astype(np.float64)
                               for a in moments)
    nz = np.maximum(counts, 1.0)[:, None]
    ss_between = np.sum(s * s / nz, axis=0)        # Σ_g n_g (μ_g - μ)^2
    ss_within = np.maximum(total_sq - ss_between, 0.0)
    dfn, dfd = k - 1, n - k
    with np.errstate(divide="ignore", invalid="ignore"):
        f = (ss_between / dfn) / np.maximum(ss_within / dfd, 1e-300)
    f = np.where(np.isfinite(f), f, np.inf)
    return f, f_p_values(f, np.full(d, dfn), np.full(d, dfd)), dfn, dfd


class ANOVATest(_OnDevice, HasFeaturesCol, HasLabelCol, AlgoOperator):
    """transform(table) -> one Table with a row per feature column:
    (featureIndex, pValue, degreesOfFreedom, fValue).  Features are
    continuous, the label categorical."""

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        y = np.asarray(table[self.get_label_col()])
        f, p, dfn, dfd = anova_f_scores(X, y, self.device)
        d = X.shape[1]
        return [Table({
            "featureIndex": np.arange(d, dtype=np.int64),
            "pValue": np.asarray(p, np.float64),
            "degreesOfFreedom": np.full(d, dfn + dfd, np.int64),
            "fValue": np.asarray(f, np.float64),
        })]
