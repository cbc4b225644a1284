"""KNN classifier — brute-force k-nearest-neighbour voting.

Part of the Flink ML 2.x library line (the reference snapshot ships only
KMeans).  CPU KNN implementations index (KD-trees etc.) to avoid the O(n*q)
distance matrix; on an accelerator the matrix IS the fast path — one
product per query chunk via the shared ``DistanceMeasure.pairwise`` — so
"fit" is just storing the training set and "transform" is pairwise +
``topk`` + one-hot vote.  Queries run in fixed-size chunks so the (chunk,
n_train) distance tile is bounded.

A port of the JAX package's ``models/classification/knn.py``; the model
scores on ``device`` (default ``"cuda"``; raises without a card unless
``"cpu"`` is asked for).  Where the k-th and (k+1)-th distances tie
exactly, ``torch.topk`` may keep the other neighbour (``lax.top_k`` keeps
the lower index); the vote can differ only there.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.stage import Estimator, Model
from ...data.table import Table
from ...distance import DistanceMeasure
from ...linalg import stack_vectors
from ...params.param import IntParam, ParamValidators
from ...params.shared import (
    HasDistanceMeasure,
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
)
from ...utils import persist
from ...utils.device import resolve_device

__all__ = ["KNNClassifier", "KNNClassifierModel"]

_QUERY_CHUNK = 4096


class KNNModelParams(HasDistanceMeasure, HasFeaturesCol, HasPredictionCol):
    K = IntParam("k", "Number of nearest neighbours to vote.", default=5,
                 validator=ParamValidators.gt_eq(1))

    def get_k(self) -> int:
        return self.get(KNNModelParams.K)

    def set_k(self, value: int):
        return self.set(KNNModelParams.K, value)


class KNNParams(KNNModelParams, HasLabelCol):
    pass


def _vote(measure: DistanceMeasure, k: int, n_classes: int,
          queries, train, train_cls):
    """(chunk, d) queries -> (chunk,) winning class index.  Ties in the vote
    resolve to the smallest class index (argmax-first semantics)."""
    dists = measure.pairwise(queries, train)                 # (chunk, n)
    _, idx = torch.topk(-dists, k)                           # k smallest
    votes = torch.nn.functional.one_hot(train_cls[idx].long(),
                                        n_classes)           # (chunk, k, c)
    return torch.argmax(torch.sum(votes, dim=1), dim=1)


class KNNClassifierModel(KNNModelParams, Model):
    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self._train: Optional[np.ndarray] = None     # (n, d)
        self._classes: Optional[np.ndarray] = None   # (n,) dense class ids
        self._labels: Optional[np.ndarray] = None    # original label values

    def set_model_data(self, *inputs) -> "KNNClassifierModel":
        # Two tables: per-row (features, classes) and per-class (labels) —
        # different leading dims, so they cannot share one Table.
        train_t, labels_t = inputs
        self._train = np.asarray(train_t["features"], np.float32)
        self._classes = np.asarray(train_t["classes"], np.int32)
        self._labels = np.asarray(labels_t["labels"])
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"features": self._train, "classes": self._classes}),
                Table({"labels": self._labels})]

    def _require_model(self) -> None:
        if self._train is None:
            raise RuntimeError("KNNClassifierModel has no model data; call "
                               "set_model_data() or fit a KNNClassifier "
                               "first")

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        measure = DistanceMeasure.get_instance(self.get_distance_measure())
        k = min(self.get_k(), len(self._train))
        X = stack_vectors(table[self.get_features_col()]).astype(np.float32)
        dev = resolve_device(self.device)
        train = torch.as_tensor(self._train, device=dev)
        train_cls = torch.as_tensor(self._classes, device=dev)
        n_classes = len(self._labels)

        preds = np.empty((len(X),), np.int64)
        # Bucket the chunk to powers of two, as the JAX package does, so a
        # query's (chunk, n_train) tile has one of a few shapes.
        chunk = min(_QUERY_CHUNK,
                    1 << max(int(np.ceil(np.log2(max(len(X), 1)))), 0))
        for start in range(0, len(X), chunk):
            q = X[start:start + chunk]
            if len(q) < chunk:  # pad to the chunk's shape
                q = np.concatenate(
                    [q, np.zeros((chunk - len(q), X.shape[1]), np.float32)])
            got = _vote(measure, k, n_classes,
                        torch.as_tensor(q, device=dev), train,
                        train_cls).cpu().numpy()
            preds[start:start + chunk] = got[: len(X) - start]
        return [table.with_column(self.get_prediction_col(),
                                  self._labels[preds])]

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {
            "features": self._train, "classes": self._classes,
            "labels": self._labels})

    @classmethod
    def load(cls, path: str, device="cuda") -> "KNNClassifierModel":
        model = persist.load_stage_param(path)
        model.device = device
        data = persist.load_model_arrays(path, "model")
        model._train = data["features"].astype(np.float32)
        model._classes = data["classes"].astype(np.int32)
        model._labels = data["labels"]
        return model


class KNNClassifier(KNNParams, Estimator[KNNClassifierModel]):
    """fit = remember the training table (dense class ids + label mapping)."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device

    def fit(self, *inputs) -> KNNClassifierModel:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()]).astype(np.float32)
        if len(X) == 0:
            raise ValueError("KNNClassifier.fit requires at least one row")
        y_raw = np.asarray(table[self.get_label_col()])
        labels, classes = np.unique(y_raw, return_inverse=True)

        model = KNNClassifierModel(device=self.device)
        model.copy_params_from(self)
        model._train = X
        model._classes = classes.astype(np.int32)
        model._labels = labels
        return model

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "KNNClassifier":
        stage = persist.load_stage_param(path)
        stage.device = device
        return stage
