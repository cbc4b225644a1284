"""Shared Estimator/Model bases for the linear family (LogisticRegression,
LinearRegression, LinearSVC) — one SGD skeleton, per-model loss + link.

A port of the JAX package's ``models/common/linear.py`` for the mixed
dense + hashed-categorical layout (``{col}_dense`` + ``{col}_indices``).
The dense and sparse feature layouts raise ``NotImplementedError`` until
they are ported (ROADMAP queue A2).  Every stage runs on ``device``
(default ``"cuda"``; raises without a card unless ``"cpu"`` is asked
for).  The device is a runtime choice, not a param, so it is not saved.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.stage import Estimator, Model
from ...data.table import Table
from ...linalg import SparseVector, stack_sparse_vectors, stack_vectors
from ...params.shared import (
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasNumFeatures,
    HasPredictionCol,
    HasRawPredictionCol,
    HasRegParam,
    HasSeed,
    HasTol,
    HasWeightCol,
)
from ...utils import persist
from ...utils.device import resolve_device
from .losses import LOSSES
from .sgd import LinearState, SGDConfig, sgd_fit_mixed

__all__ = ["LinearEstimatorParams", "LinearModelBase", "LinearEstimatorBase",
           "resolve_features", "check_sparse_indices"]


def check_sparse_indices(idx: np.ndarray, num_features: int) -> None:
    """Range-check hashed indices against the weight size, so a
    hasher/model numFeatures mismatch fails with a diagnostic instead of
    an indexing error deep inside a kernel."""
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= num_features):
        raise ValueError(
            f"hashed index out of range for numFeatures={num_features} "
            f"(got index {int(idx.max()) if int(idx.min()) >= 0 else int(idx.min())}); "
            "the hasher and the model disagree on the hash-space size")


def resolve_features(table: Table, col: str):
    """Resolve a features column into its layout.

    Sparse/hashed features appear in a Table either as a column of
    :class:`SparseVector` objects, or as the hashed PAIR convention two
    columns ``{col}_indices (n, nnz) int`` + ``{col}_values (n, nnz)
    float``, or as the MIXED Criteo-native convention ``{col}_dense (n, nd)
    float`` + ``{col}_indices (n, nc) int`` (dense block occupying weight
    slots ``[0, nd)`` plus hashed categorical with implicit value 1.0).

    Returns ``("dense", X)``, ``("sparse", (indices, values, dim))``, or
    ``("mixed", (dense, cat))``."""
    if col not in table:
        idx_col, val_col = f"{col}_indices", f"{col}_values"
        dense_col = f"{col}_dense"
        if dense_col in table and idx_col in table:
            if val_col in table:
                raise ValueError(
                    f"ambiguous feature schema: {dense_col!r}, {idx_col!r} "
                    f"AND {val_col!r} all present — the mixed layout "
                    "carries implicit value 1.0, so it cannot coexist with "
                    "a values column; drop one of them")
            return "mixed", (np.asarray(table[dense_col], np.float32),
                             np.asarray(table[idx_col], np.int32))
        if idx_col in table and val_col in table:
            return "sparse", (np.asarray(table[idx_col], np.int32),
                              np.asarray(table[val_col], np.float32), 0)
        raise KeyError(
            f"No column {col!r} (nor {idx_col!r}/{val_col!r}, nor "
            f"{dense_col!r}/{idx_col!r}); available: "
            f"{table.column_names}")
    column = table[col]
    if column.dtype == object and len(column) \
            and isinstance(column[0], SparseVector):
        return "sparse", stack_sparse_vectors(column)
    return "dense", stack_vectors(column)


def _require_mixed(kind: str, col: str) -> None:
    if kind != "mixed":
        raise NotImplementedError(
            f"the {kind!r} feature layout is not ported to "
            "flink_ml_tpu_torch yet (ROADMAP queue A2); use the mixed "
            f"layout ({col}_dense + {col}_indices)")


class LinearModelParams(HasFeaturesCol, HasPredictionCol, HasRawPredictionCol):
    pass


class LinearEstimatorParams(LinearModelParams, HasLabelCol, HasWeightCol,
                            HasMaxIter, HasLearningRate, HasRegParam,
                            HasElasticNet, HasGlobalBatchSize, HasTol,
                            HasSeed, HasNumFeatures):
    pass


class LinearModelBase(LinearModelParams, Model):
    """Holds (coefficients, intercept); subclasses map margins to the
    prediction / raw-prediction columns."""

    loss_name: str = "squared"

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self._state: Optional[LinearState] = None

    # -- model data ---------------------------------------------------------
    def set_model_data(self, *inputs) -> "LinearModelBase":
        (table,) = inputs
        self._state = LinearState(
            coefficients=np.asarray(table["coefficients"][0], np.float64),
            intercept=float(table["intercept"][0]))
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({
            "coefficients": self._state.coefficients[None, :],
            "intercept": np.array([self._state.intercept]),
        })]

    def _require_model(self):
        if self._state is None:
            raise RuntimeError(
                f"{type(self).__name__} has no model data; fit the estimator "
                "or call set_model_data first")

    @property
    def loss_log(self) -> list:
        """Per-epoch training loss recorded by fit (empty when the model
        was built from set_model_data/load rather than trained)."""
        return list(getattr(self, "_loss_log", []) or [])

    @property
    def planned_impl(self) -> Optional[str]:
        """Which update implementation the fit planned ("ell" / "plain");
        None when the model was loaded rather than trained."""
        return self._state.planned_impl if self._state is not None else None

    # -- inference ----------------------------------------------------------
    def _margins(self, table: Table) -> np.ndarray:
        """``dense @ w[:nd] + sum(w[cat]) + b`` in f32 on the device (the
        JAX package's ``_jit_mixed_margins``), returned as f64 numpy."""
        self._require_model()
        col = self.get_features_col()
        kind, feats = resolve_features(table, col)
        _require_mixed(kind, col)
        dense, cat = feats
        check_sparse_indices(cat, self._state.coefficients.shape[0])
        dev = resolve_device(self.device)
        w = torch.as_tensor(self._state.coefficients, dtype=torch.float32,
                            device=dev)
        b = torch.as_tensor(self._state.intercept, dtype=torch.float32,
                            device=dev)
        dense_t = torch.from_numpy(dense).to(dev)
        cat_t = torch.from_numpy(cat).to(dev).long()
        m = (dense_t @ w[:dense.shape[-1]]
             + torch.sum(w[cat_t], dim=-1) + b)
        return m.cpu().numpy().astype(np.float64)

    def _decision(self, margins: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _raw(self, margins: np.ndarray) -> np.ndarray:
        return margins

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        m = self._margins(table)
        out = table.with_column(self.get_prediction_col(), self._decision(m))
        raw_col = self.get_raw_prediction_col()
        if raw_col:
            out = out.with_column(raw_col, self._raw(m))
        return [out]

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {
            "coefficients": self._state.coefficients,
            "intercept": np.array([self._state.intercept]),
        })

    @classmethod
    def load(cls, path: str, device="cuda"):
        """Load a model saved by this package or by the JAX package."""
        model = persist.load_stage_param(path)
        if not isinstance(model, cls):
            raise IOError(f"Stage at {path} is a {type(model).__name__}, "
                          f"not a {cls.__name__}")
        model.device = device
        data = persist.load_model_arrays(path, "model")
        model._state = LinearState(
            coefficients=data["coefficients"].astype(np.float64),
            intercept=float(data["intercept"][0]))
        return model


class LinearEstimatorBase(LinearEstimatorParams, Estimator):
    """fit(): extract (features, y, weight), run the SGD loop on the
    device, wrap the fitted state in the concrete model class."""

    loss_name: str = "squared"
    model_cls = None  # set by subclasses

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device

    def _labels(self, table: Table) -> np.ndarray:
        return np.asarray(table[self.get_label_col()], np.float64)

    def fit(self, *inputs):
        (table,) = inputs
        col = self.get_features_col()
        kind, feats = resolve_features(table, col)
        _require_mixed(kind, col)
        y = self._labels(table)
        weight_col = self.get_weight_col()
        weights = (np.asarray(table[weight_col], np.float64)
                   if weight_col else None)
        dense, cat = feats
        num_features = self.get_num_features()
        if not num_features:
            raise ValueError(
                "mixed dense+hashed input needs numFeatures (the hash-"
                "space size); call set_num_features")
        state, loss_log = sgd_fit_mixed(
            LOSSES[self.loss_name], dense, cat, y, weights,
            num_features, self._sgd_config(), device=self.device)

        model = self.model_cls(device=self.device)
        model.copy_params_from(self)
        model._state = state
        model._loss_log = loss_log
        return model

    def _sgd_config(self) -> SGDConfig:
        return SGDConfig(
            learning_rate=self.get_learning_rate(),
            reg=self.get_reg(),
            elastic_net=self.get_elastic_net(),
            global_batch_size=self.get_global_batch_size(),
            max_epochs=self.get_max_iter(),
            tol=self.get_tol(),
            seed=self.get_seed(),
        )

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)

    @classmethod
    def load(cls, path: str, device="cuda"):
        stage = persist.load_stage_param(path)
        stage.device = device
        return stage
