"""AgglomerativeClustering — hierarchical clustering as an AlgoOperator.

Member of the Flink ML 2.x clustering surface (the reference snapshot ships
only KMeans).  Like its Flink ML counterpart it is an **AlgoOperator**, not
an Estimator: there is no model to fit — ``transform`` clusters the input
table directly.

Work split: hierarchical clustering is a small-n algorithm (the matrix is
n^2; the row guard enforces it), and its merge ordering is precision-
critical — so BOTH the pairwise matrix and the inherently-serial
Lance-Williams merge loop run on host in float64
(``DistanceMeasure.pairwise_host64``; the f32 device expansion cancels
catastrophically for data far from the origin).  The guard keeps the host
O(n^2 d) BLAS cost trivial; pre-cluster with KMeans to scale beyond it.

A port of the JAX package's ``models/clustering/agglomerative.py``, which
imports no JAX either: the same host float64 work through the port's own
``DistanceMeasure.pairwise_host64``, so labels and merge order equal the
JAX package's.  A host stage: it takes no ``device``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...api.stage import AlgoOperator
from ...data.table import Table
from ...distance import DistanceMeasure
from ...linalg import stack_vectors
from ...params.param import IntParam, ParamValidators, StringParam
from ...params.shared import HasDistanceMeasure, HasFeaturesCol, HasPredictionCol

__all__ = ["AgglomerativeClustering"]

_MAX_ROWS = 20_000

# Lance-Williams coefficients: d(i∪j, k) = a_i d(i,k) + a_j d(j,k)
# + b d(i,j) + g |d(i,k) - d(j,k)|
_LINKAGES = ("average", "complete", "single", "ward")


class AgglomerativeClustering(HasDistanceMeasure, HasFeaturesCol,
                              HasPredictionCol, AlgoOperator):
    NUM_CLUSTERS = IntParam("numClusters", "Target number of clusters.",
                            default=2, validator=ParamValidators.gt_eq(1))
    LINKAGE = StringParam("linkage", "Cluster-distance criterion.",
                          default="ward",
                          validator=ParamValidators.in_array(_LINKAGES))

    def get_num_clusters(self) -> int:
        return self.get(AgglomerativeClustering.NUM_CLUSTERS)

    def set_num_clusters(self, value: int):
        return self.set(AgglomerativeClustering.NUM_CLUSTERS, value)

    def get_linkage(self) -> str:
        return self.get(AgglomerativeClustering.LINKAGE)

    def set_linkage(self, value: str):
        return self.set(AgglomerativeClustering.LINKAGE, value)

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        n = len(X)
        if n > _MAX_ROWS:
            raise ValueError(
                f"AgglomerativeClustering is O(n^2) in memory; {n} rows "
                f"exceeds the {_MAX_ROWS}-row guard — pre-cluster with "
                "KMeans or sample")
        k = self.get_num_clusters()
        if n == 0:
            return [table.with_column(self.get_prediction_col(),
                                      np.zeros((0,), np.int64))]
        if k > n:
            raise ValueError(f"numClusters={k} exceeds the {n} input rows")
        linkage = self.get_linkage()
        measure = DistanceMeasure.get_instance(self.get_distance_measure())
        if linkage == "ward" and measure.name != "euclidean":
            raise ValueError("ward linkage requires the euclidean measure")

        # The pairwise matrix is computed on HOST in float64: the merge
        # ordering is precision-critical, and the f32 device expansion
        # catastrophically cancels for data far from the origin (verified:
        # blobs at coords ~1000 collapse 55% of within-blob distances to 0).
        # n is guard-capped, so the host O(n^2 d) BLAS call is cheap.
        D = measure.pairwise_host64(X, X)
        if linkage == "ward":
            D = D * D  # ward's Lance-Williams runs on squared euclidean

        labels = _merge_loop(D, max(k, 1), linkage)
        return [table.with_column(self.get_prediction_col(), labels)]


def _merge_loop(D: np.ndarray, k: int, linkage: str) -> np.ndarray:
    """Sequential agglomeration with Lance-Williams distance updates and a
    per-row nearest-neighbour index, so each merge costs O(n) typical (full
    n^2 argmin per merge would make the loop O(n^3) scans).  Returns dense
    labels 0..k-1, numbered by each cluster's smallest row index."""
    n = D.shape[0]
    D = D.copy()
    np.fill_diagonal(D, np.inf)
    active = np.ones(n, bool)
    size = np.ones(n)
    parent = np.arange(n)
    nn_dist = D.min(axis=1)
    nn_idx = D.argmin(axis=1)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for _ in range(n - k):
        cand = np.where(active, nn_dist, np.inf)
        i = int(np.argmin(cand))
        if not np.isfinite(cand[i]):
            break
        j = int(nn_idx[i])
        if j < i:
            i, j = j, i
        di, dj = D[i], D[j]
        if linkage == "single":
            new = np.minimum(di, dj)
        elif linkage == "complete":
            new = np.maximum(di, dj)
        elif linkage == "average":
            new = (size[i] * di + size[j] * dj) / (size[i] + size[j])
        else:  # ward on squared distances
            sk = size
            tot = size[i] + size[j] + sk
            new = ((size[i] + sk) * di + (size[j] + sk) * dj
                   - sk * D[i, j]) / tot
        new[~active] = np.inf
        new[i] = np.inf
        D[i, :] = new
        D[:, i] = new
        D[j, :] = np.inf
        D[:, j] = np.inf
        active[j] = False
        size[i] += size[j]
        parent[j] = i

        # maintain the NN index: row i changed entirely; any row whose NN
        # was i or j, or that found a closer neighbour in the updated column
        # i, is repaired (rescans are rare in practice -> ~O(n) per merge)
        nn_dist[i] = D[i].min()
        nn_idx[i] = D[i].argmin()
        changed = active.copy()
        changed[i] = False
        closer = changed & (new < nn_dist)
        nn_dist[closer] = new[closer]
        nn_idx[closer] = i
        stale = changed & ~closer & np.isin(nn_idx, (i, j))
        for m in np.nonzero(stale)[0]:
            nn_dist[m] = D[m].min()
            nn_idx[m] = D[m].argmin()

    roots = np.array([find(i) for i in range(n)])
    # every merge keeps the smaller index as the root, so roots sort in
    # first-appearance order and unique's inverse is already the dense label
    return np.unique(roots, return_inverse=True)[1].astype(np.int64)
