"""ClusteringEvaluator — mean silhouette coefficient.

The silhouette is all-pairs work: the (n, n) distance matrix is one
pairwise expansion matmul and the per-cluster mean distances are one
``D @ onehot`` matmul, in f32 on ``device``.

s(i) = (b_i - a_i) / max(a_i, b_i) with
    a_i = mean distance to OWN cluster (excluding self)
    b_i = min over other clusters of mean distance to that cluster;
singleton clusters score 0 by convention (sklearn's rule).

A port of the JAX package's ``models/evaluation/clustering_evaluator.py``.
Runs on ``device`` (default ``"cuda"``; raises without a card unless
``"cpu"`` is asked for).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ...api.stage import AlgoOperator
from ...data.table import Table
from ...distance import DistanceMeasure
from ...linalg import stack_vectors
from ...params.shared import HasDistanceMeasure, HasFeaturesCol, \
    HasPredictionCol
from ...utils.device import resolve_device

__all__ = ["ClusteringEvaluator"]


def _silhouette(measure: DistanceMeasure, X: torch.Tensor,
                labels: torch.Tensor, k: int) -> float:
    D = measure.pairwise(X, X)                             # (n, n)
    onehot = F.one_hot(labels, k).to(X.dtype)              # (n, k)
    counts = torch.sum(onehot, dim=0)                      # (k,)
    sums = D @ onehot                                      # (n, k)

    own_count = counts[labels]
    # a_i: own-cluster mean excluding self (D[i,i] = 0 contributes nothing)
    a = torch.gather(sums, 1, labels[:, None])[:, 0] \
        / torch.clamp(own_count - 1.0, min=1.0)
    # b_i: min mean distance over OTHER non-empty clusters
    means = sums / torch.clamp(counts, min=1.0)[None, :]
    own_or_empty = onehot.bool() | (counts[None, :] == 0)
    b = torch.min(torch.where(own_or_empty, torch.inf, means), dim=1).values

    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-12)
    s = torch.where(own_count > 1, s, 0.0)                 # singletons
    s = torch.where(torch.isfinite(s), s, 0.0)             # one cluster
    return float(torch.mean(s))


class ClusteringEvaluator(HasDistanceMeasure, HasFeaturesCol,
                          HasPredictionCol, AlgoOperator):
    """transform(table with features + cluster predictions) -> one-row Table
    with the mean silhouette."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        dev = resolve_device(self.device)
        X = stack_vectors(table[self.get_features_col()]).astype(np.float32)
        labels_raw = np.asarray(table[self.get_prediction_col()])
        if len(X) != len(labels_raw):
            raise ValueError("features/prediction length mismatch")
        if len(X) < 2:
            raise ValueError("silhouette needs at least 2 rows")
        uniq, labels = np.unique(labels_raw, return_inverse=True)
        measure = DistanceMeasure.get_instance(self.get_distance_measure())
        value = _silhouette(measure, torch.from_numpy(X).to(dev),
                            torch.from_numpy(labels.astype(np.int64)).to(dev),
                            int(len(uniq)))
        return [Table({"silhouette": np.asarray([value])})]
