"""GBTClassifier — gradient-boosted trees, binary (logistic loss) or
multiclass (softmax objective, one tree per class per round).

Member of the later Flink ML 2.x library line.  See
``models/common/gbt.py`` for the histogram trainer.  A port of the JAX
package's ``models/classification/gbtclassifier.py``; every stage runs on
``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...data.table import Table
from ...linalg import stack_vectors
from ...utils import persist
from ..common.gbt import (
    SoftmaxForest,
    _softmax_rows,
    predict_forest_softmax,
    train_forest_softmax,
)
from ..common.gbt_stage import GBTEstimatorBase, GBTModelBase


__all__ = ["GBTClassifier", "GBTClassifierModel"]


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.tanh(0.5 * x))


class GBTClassifierModel(GBTModelBase):
    def __init__(self, device="cuda"):
        super().__init__(device)
        self._labels = np.asarray([0.0, 1.0])
        self._soft: Optional[SoftmaxForest] = None   # multiclass forest

    def _require_model(self) -> None:
        if self._soft is None:
            super()._require_model()

    # -- model data: forest table + label-mapping table ---------------------
    def set_model_data(self, *inputs) -> "GBTClassifierModel":
        forest_t, labels_t = inputs
        # installing either representation fully replaces the other — a
        # stale forest from a previous set/fit must never answer transform()
        self._soft = None
        self._forest = None
        if "nClasses" in forest_t:
            k = int(np.asarray(forest_t["nClasses"])[0])
            feat = np.asarray(forest_t["feature"], np.int32)
            nodes = feat.shape[-1]
            self._soft = SoftmaxForest(
                feature=feat.reshape(-1, k, nodes),
                threshold=np.asarray(forest_t["threshold"],
                                     np.int32).reshape(-1, k, nodes),
                value=np.asarray(forest_t["value"],
                                 np.float32).reshape(-1, k, nodes),
                bin_edges=np.asarray(forest_t["binEdges"][0], np.float64),
                base_scores=np.asarray(forest_t["baseScores"][0], np.float64),
                learning_rate=float(np.asarray(forest_t["learningRate"])[0]),
            )
        else:
            super().set_model_data(forest_t)
        self._labels = np.asarray(labels_t["labels"])
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        if self._soft is None:
            return super().get_model_data() + [Table({"labels": self._labels})]
        f = self._soft
        n_trees, k, nodes = f.feature.shape
        forest_t = Table({
            "feature": f.feature.reshape(n_trees * k, nodes),
            "threshold": f.threshold.reshape(n_trees * k, nodes),
            "value": f.value.reshape(n_trees * k, nodes),
            "binEdges": np.broadcast_to(
                f.bin_edges[None], (n_trees * k,) + f.bin_edges.shape).copy(),
            "baseScores": np.broadcast_to(
                f.base_scores[None], (n_trees * k, k)).copy(),
            "learningRate": np.full((n_trees * k,), f.learning_rate),
            "nClasses": np.full((n_trees * k,), k, np.int64),
        })
        return [forest_t, Table({"labels": self._labels})]

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        if self._soft is not None:
            X = stack_vectors(table[self.get_features_col()]).astype(
                np.float64)
            probs = _softmax_rows(predict_forest_softmax(
                X, self._soft, device=self.device))
            pred = self._labels[np.argmax(probs, axis=1)]
        else:
            margins = self._margins(table)
            probs = _sigmoid(margins)
            pred = self._labels[(probs > 0.5).astype(np.int64)]
        out = table.with_column(self.get_prediction_col(), pred)
        return [out.with_column("rawPrediction", probs)]

    def save(self, path: str) -> None:
        if self._soft is None:
            super().save(path)
        else:
            f = self._soft
            persist.save_metadata(self, path, {"nClasses": f.n_classes})
            persist.save_model_arrays(path, "model", {
                "feature": f.feature, "threshold": f.threshold,
                "value": f.value, "binEdges": f.bin_edges,
                "baseScores": f.base_scores,
                "scalars": np.asarray([f.learning_rate])})
        persist.save_model_arrays(path, "labels", {"labels": self._labels})

    @classmethod
    def load(cls, path: str, device="cuda") -> "GBTClassifierModel":
        meta = persist.load_metadata(path)
        if "nClasses" in meta:
            model = persist.load_stage_param(path)
            model.device = device
            data = persist.load_model_arrays(path, "model")
            model._soft = SoftmaxForest(
                feature=data["feature"].astype(np.int32),
                threshold=data["threshold"].astype(np.int32),
                value=data["value"].astype(np.float32),
                bin_edges=data["binEdges"].astype(np.float64),
                base_scores=data["baseScores"].astype(np.float64),
                learning_rate=float(data["scalars"][0]),
            )
        else:
            model = super().load(path, device=device)
        model._labels = persist.load_model_arrays(path, "labels")["labels"]
        return model


class GBTClassifier(GBTEstimatorBase):
    model_cls = GBTClassifierModel

    def fit(self, *inputs):
        (table,) = inputs
        labels, y_ids = np.unique(np.asarray(table[self.get_label_col()]),
                                  return_inverse=True)
        if len(labels) <= 2:
            return super().fit(table)   # binary: shared logistic path
        # multiclass: softmax objective, one tree per class per round
        X = stack_vectors(table[self.get_features_col()]).astype(np.float64)
        forest = train_forest_softmax(X, y_ids, len(labels), self._config(),
                                      device=self.device)
        model = self._new_model()
        model._soft = forest
        model._labels = labels
        return model

    def _prepare_labels(self, y_raw: np.ndarray):
        labels, y = np.unique(y_raw, return_inverse=True)
        if len(labels) != 2:
            raise ValueError(
                f"GBTClassifier binary path needs 2 label values; got "
                f"{len(labels)}")
        return y.astype(np.float64), labels

    def _grad_hess(self, y, pred):
        p = _sigmoid(pred)
        return p - y, np.maximum(p * (1.0 - p), 1e-12)

    def _streaming_labels(self, y_raw: np.ndarray) -> np.ndarray:
        y = np.asarray(y_raw, np.float64)
        bad = ~np.isin(y, (0.0, 1.0))
        if bad.any():
            raise ValueError(
                "fit_outofcore needs 0/1 labels (a streamed fit cannot "
                f"inventory arbitrary label values); got {y[bad][:3]}")
        return y

    def _streaming_label_values(self):
        return np.asarray([0.0, 1.0])

    def _base_score(self, y) -> float:
        p = np.clip(y.mean(), 1e-6, 1 - 1e-6)
        return float(np.log(p / (1.0 - p)))

    def _finalize_model(self, model, label_values) -> None:
        model._labels = label_values
