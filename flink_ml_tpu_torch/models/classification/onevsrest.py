"""OneVsRest — binary-to-multiclass meta-estimator.

Beyond-reference surface (the flink-ml snapshot has no meta-classifier;
the Spark ML `OneVsRest` shape): K one-vs-all copies of any binary
estimator train against indicator labels, and prediction is the argmax
of the per-class raw scores.  Each per-class fit runs on the base
estimator's device over the same rows — the host relabeling is the only
per-class data work.

The base estimator must emit a raw-score column (set
``rawPredictionCol``; LogisticRegression and LinearSVC both do).

A port of the JAX package's ``models/classification/onevsrest.py``, over
any port classifier: the sub-models run where their estimator (or, after
``load(path, device=)``, the load) places them."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...api.stage import Estimator, Model
from ...data.table import Table
from ...params.shared import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasRawPredictionCol,
)
from ...utils import persist

__all__ = ["OneVsRest", "OneVsRestModel"]


class OneVsRestModel(HasFeaturesCol, HasLabelCol, HasPredictionCol,
                     HasRawPredictionCol, Model):
    """Holds K fitted binary models + the label inventory; transform
    appends argmax predictions (original label values) and, when
    ``rawPredictionCol`` is set, the (n, K) score matrix."""

    def __init__(self):
        super().__init__()
        self.models: List[Model] = []
        self.label_values: Optional[np.ndarray] = None

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        if not self.models:
            raise ValueError("OneVsRestModel has no fitted sub-models")
        n = table.num_rows
        scores = []
        for sub in self.models:
            raw_col = sub.get_raw_prediction_col()
            (out,) = sub.transform(table)
            raw = np.asarray(out[raw_col], np.float64)
            if raw.shape not in ((n,), (n, 1)):
                raise ValueError(
                    f"base classifier raw column has shape {raw.shape}; "
                    "OneVsRest needs ONE score per row (shape (n,) or "
                    "(n, 1)) — a multiclass base does not compose")
            scores.append(raw.reshape(n))
        score_mat = np.stack(scores, axis=1)           # (n, K)
        pred_idx = np.argmax(score_mat, axis=1)
        pred = self.label_values[pred_idx]
        result = table.with_column(self.get_prediction_col(), pred)
        raw_col = self.get_raw_prediction_col()
        if raw_col:
            result = result.with_column(raw_col, score_mat)
        return [result]

    def save(self, path: str) -> None:
        import os

        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "labels",
                                  {"label_values": self.label_values})
        for i, sub in enumerate(self.models):
            sub.save(os.path.join(path, "models", f"{i:03d}"))

    @classmethod
    def load(cls, path: str, device="cuda") -> "OneVsRestModel":
        import os

        model = persist.load_stage_param(path)
        data = persist.load_model_arrays(path, "labels")
        model.label_values = data["label_values"]
        models_dir = os.path.join(path, "models")
        model.models = [
            persist.load_stage(os.path.join(models_dir, name),
                               device=device)
            for name in sorted(os.listdir(models_dir))]
        return model


class OneVsRest(HasFeaturesCol, HasLabelCol, HasPredictionCol,
                HasRawPredictionCol, Estimator[OneVsRestModel]):
    """fit(table): one binary model per distinct label value (label k
    becomes 1, the rest 0).  The base estimator is a python object (set
    via ``set_classifier``), like CrossValidator's estimator."""

    def __init__(self, classifier=None):
        super().__init__()
        self._classifier = classifier

    def set_classifier(self, est) -> "OneVsRest":
        self._classifier = est
        return self

    def fit(self, *inputs) -> OneVsRestModel:
        (table,) = inputs
        if self._classifier is None:
            raise ValueError("OneVsRest needs set_classifier")
        y_raw = np.asarray(table[self.get_label_col()])
        label_values = np.unique(y_raw)
        if len(label_values) < 2:
            raise ValueError(
                f"OneVsRest needs >= 2 label values, got {label_values}")

        from ...api.model_selection import _clone_with

        models: List[Model] = []
        for value in label_values:
            sub_est = _clone_with(self._classifier, {})
            sub_est.set_label_col(self.get_label_col())
            sub_est.set_features_col(self.get_features_col())
            if not sub_est.get_raw_prediction_col():
                raise ValueError(
                    "the base classifier must set rawPredictionCol (the "
                    "per-class scores drive the argmax)")
            indicator = (y_raw == value).astype(np.float64)
            relabeled = table.with_column(self.get_label_col(), indicator)
            models.append(sub_est.fit(relabeled))

        model = OneVsRestModel()
        model.copy_params_from(self)
        model.models = models
        model.label_values = label_values
        return model

    def save(self, path: str) -> None:
        import os

        persist.save_metadata(self, path)
        if self._classifier is not None:
            self._classifier.save(os.path.join(path, "classifier"))

    @classmethod
    def load(cls, path: str, device="cuda") -> "OneVsRest":
        import os

        est = persist.load_stage_param(path)
        clf_dir = os.path.join(path, "classifier")
        if os.path.isdir(clf_dir):
            est._classifier = persist.load_stage(clf_dir, device=device)
        return est