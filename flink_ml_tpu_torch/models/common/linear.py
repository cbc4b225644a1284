"""Shared Estimator/Model bases for the linear family (LogisticRegression,
LinearRegression, LinearSVC) — one SGD skeleton, per-model loss + link.

A port of the JAX package's ``models/common/linear.py`` on every feature
layout: dense matrices, sparse ``(indices, values)`` pairs (a column of
:class:`SparseVector` or the ``{col}_indices`` + ``{col}_values`` pair
columns) and the mixed dense + hashed-categorical layout
(``{col}_dense`` + ``{col}_indices``), in memory (``fit``) or streamed
from a reader of host batches (``fit_outofcore``).  Every stage runs on
``device`` (default ``"cuda"``;
raises without a card unless ``"cpu"`` is asked for).  The device is a
runtime choice, not a param, so it is not saved.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.chain import (StageKernel, apply_kernel_or_none, as_matrix,
                          numeric_entry, run_kernel)
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
from ...utils.row_tiles import in_row_tiles
from .losses import LOSSES
from .sgd import (LinearState, SGDConfig, sgd_fit, sgd_fit_mixed,
                  sgd_fit_outofcore, sgd_fit_sparse)

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


def _linear_chain_kernel(static, params, cols):
    """Chain-terminal margins ``X @ w + b`` in f32, staged under a
    private column the host ``post`` maps to prediction/raw columns."""
    (fcol, mcol) = static
    X = as_matrix(cols[fcol]).to(torch.float32)
    return {mcol: X @ params["w"] + params["b"]}


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
    def _margins(self, kind: str, feats) -> np.ndarray:
        """Margins of the sparse layouts in f32 on the device, returned as
        f64 numpy: ``sum(vals * w[idx]) + b`` for sparse pairs, ``dense @
        w[:nd] + sum(w[cat]) + b`` for the mixed layout (the JAX
        package's ``_jit_sparse_margins`` and ``_jit_mixed_margins``), in
        row tiles of one shape so a row's margin has the same bits in any
        batch (``utils/row_tiles.py``).  Dense features score through
        :meth:`transform_kernel`."""
        dev = resolve_device(self.device)
        w = torch.as_tensor(self._state.coefficients, dtype=torch.float32,
                            device=dev)
        b = torch.as_tensor(self._state.intercept, dtype=torch.float32,
                            device=dev)

        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        if kind == "sparse":
            idx, vals, _ = feats
            check_sparse_indices(idx, self._state.coefficients.shape[0])
            m = in_row_tiles(
                lambda v, i: torch.sum(v * w[i], dim=-1) + b,
                put(vals, torch.float32), put(idx, torch.int64))
        else:
            dense, cat = feats
            check_sparse_indices(cat, self._state.coefficients.shape[0])
            nd = dense.shape[-1]
            m = in_row_tiles(
                lambda x, c: x @ w[:nd] + torch.sum(w[c], dim=-1) + b,
                put(dense, torch.float32), put(cat, torch.int64))
        return m.cpu().numpy().astype(np.float64)

    def _decision(self, margins: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _raw(self, margins: np.ndarray) -> np.ndarray:
        return margins

    def transform_kernel(self, schema):
        """Chain TERMINAL for dense features: the in-segment kernel is
        the f32 ``X @ w + b`` of the standalone dense transform, and the
        host ``post`` applies the f64 ``_decision``/``_raw`` mapping —
        fused output is bit-exact with stagewise ``transform``.  Sparse
        pair/mixed feature layouts stay on ``_margins`` (the chain
        substrate is dense column dicts)."""
        self._require_model()
        fcol = self.get_features_col()
        if numeric_entry(schema, fcol) is None:
            return None
        pred_col = self.get_prediction_col()
        raw_col = self.get_raw_prediction_col()
        margin_col = f"__chain_margins__{pred_col}"

        def post(host):
            m = host[margin_col].astype(np.float64)
            out = {pred_col: self._decision(m)}
            if raw_col:
                out[raw_col] = self._raw(m)
            return out

        return StageKernel(
            fn=_linear_chain_kernel, static=(fcol, margin_col),
            params={"w": np.asarray(self._state.coefficients, np.float32),
                    "b": np.float32(self._state.intercept)},
            consumes=(fcol,), produces=(margin_col,), post=post,
            device=self.device)

    def transform(self, *inputs) -> List[Table]:
        """Dense features score through the chain terminal as a one-stage
        segment (rows padded to the shared bucket), so the standalone and
        the fused transform run one product on one shape; a column of
        vectors (or of f32-unsafe integers) is stacked to f32 first.
        Sparse pair/mixed layouts score through :meth:`_margins`."""
        (table,) = inputs
        self._require_model()
        cols = apply_kernel_or_none(self.transform_kernel(table.schema()),
                                    table)
        if cols is None:
            fcol = self.get_features_col()
            kind, feats = resolve_features(table, fcol)
            if kind == "dense":
                stacked = Table({fcol: feats.astype(np.float32)})
                cols = run_kernel(self.transform_kernel(stacked.schema()),
                                  stacked)
            else:
                m = self._margins(kind, feats)
                cols = {self.get_prediction_col(): self._decision(m)}
                if self.get_raw_prediction_col():
                    cols[self.get_raw_prediction_col()] = self._raw(m)
        out = table
        for name in (self.get_prediction_col(),
                     self.get_raw_prediction_col()):
            if name:
                out = out.with_column(name, cols[name])
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

    def fit(self, *inputs, mesh=None):
        """Fit on ``inputs``' one table.  Inside a process group each rank
        passes its own rows and the fit runs data-parallel on ``mesh``
        (default the group's; the hashed layouts also take a ``("data",
        "model")`` mesh: :func:`~.sgd.sgd_fit_mixed`)."""
        (table,) = inputs
        kind, feats = resolve_features(table, self.get_features_col())
        y = self._labels(table)
        weight_col = self.get_weight_col()
        weights = (np.asarray(table[weight_col], np.float64)
                   if weight_col else None)
        loss = LOSSES[self.loss_name]
        if kind == "sparse":
            idx, vals, dim = feats
            num_features = self.get_num_features() or dim
            if not num_features:
                raise ValueError(
                    "hashed pair-column input needs numFeatures (the hash-"
                    "space size); call set_num_features")
            state, loss_log = sgd_fit_sparse(
                loss, idx, vals, y, weights, num_features,
                self._sgd_config(), device=self.device, mesh=mesh)
        elif kind == "mixed":
            dense, cat = feats
            num_features = self.get_num_features()
            if not num_features:
                raise ValueError(
                    "mixed dense+hashed input needs numFeatures (the hash-"
                    "space size); call set_num_features")
            state, loss_log = sgd_fit_mixed(
                loss, dense, cat, y, weights, num_features,
                self._sgd_config(), device=self.device, mesh=mesh)
        else:
            state, loss_log = sgd_fit(loss, feats, y, weights,
                                      self._sgd_config(), device=self.device,
                                      mesh=mesh)

        model = self.model_cls(device=self.device)
        model.copy_params_from(self)
        model._state = state
        model._loss_log = loss_log
        return model

    def fit_outofcore(self, make_reader, *, num_features: int, mesh=None,
                      sparse: bool = False, mixed: bool = False,
                      checkpoint=None, checkpoint_every_steps: int = 0,
                      resume: bool = False, **stream_kwargs):
        """Out-of-core ``fit``: the dataset streams from ``make_reader()``
        (a fresh per-epoch iterator of host batch dicts, e.g. a
        ``DataCacheReader`` or a ``CriteoTSVReader``) instead of living
        in host or device memory — the Criteo-scale input path.  Column
        names follow this estimator's params (featuresCol/labelCol/
        weightCol); with ``sparse=True`` the reader carries the hashed
        pair columns ``{featuresCol}_indices`` / ``{featuresCol}_values``,
        with ``mixed=True`` the Criteo-native ``{featuresCol}_dense`` +
        ``{featuresCol}_indices`` pair (implicit categorical value 1.0).
        globalBatchSize and seed are inert: the reader owns batch size
        and order.  ``mesh`` (several ranks of a process group, each with
        a reader over its own shard) runs the stream data-parallel
        (:func:`~.sgd.sgd_fit_outofcore`).  Runs on this estimator's
        ``device``; extra keyword
        arguments (``cache_decoded``, ``decoded_ram_budget``,
        ``stream_info``, ``prefetch_*``, ``steps_per_dispatch``,
        ``ell_*``, ``retry_policy``, ``plain``, ...) forward to
        :func:`~.sgd.sgd_fit_outofcore`."""
        feat = self.get_features_col()
        stream_kwargs.setdefault("device", self.device)
        state, loss_log = sgd_fit_outofcore(
            LOSSES[self.loss_name], make_reader,
            num_features=num_features, config=self._sgd_config(), mesh=mesh,
            features_key=feat,
            label_key=self.get_label_col(),
            weight_key=self.get_weight_col() or None,
            indices_key=f"{feat}_indices" if (sparse or mixed) else None,
            values_key=f"{feat}_values" if sparse else None,
            dense_key=f"{feat}_dense" if mixed else None,
            checkpoint=checkpoint,
            checkpoint_every_steps=checkpoint_every_steps, resume=resume,
            **stream_kwargs)
        model = self.model_cls(device=stream_kwargs["device"])
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


# ---------------------------------------------------------------------------
# kernel-registry entry: op ``linear_margins`` (stage convention), one
# PyTorch implementation on both devices (no hand kernel)
# ---------------------------------------------------------------------------

def _register_linear_kernels() -> None:
    from ...kernels.registry import register_kernel

    register_kernel("linear_margins", "torch", _linear_chain_kernel,
                    convention="stage")


_register_linear_kernels()
