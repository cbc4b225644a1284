"""Carry weights from the JAX package into the port.

The JAX package's parameters reach this module as numpy arrays (the tests
pass them through ``np.asarray``); nothing here imports JAX."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.common.sgd import LinearState
from .device import resolve_device

__all__ = ["params_from_jax", "model_from_jax_state", "softmax_model_from_jax",
           "kmeans_model_from_jax",
           "widedeep_params_from_jax", "adam_state_from_jax",
           "ivf_index_from_jax", "feature_model_from_jax",
           "model_data_from_jax", "onevsrest_model_from_jax",
           "algo_operator_from_jax", "pipeline_model_from_jax",
           "grad_reduce_state_from_jax"]


def params_from_jax(params: Dict[str, np.ndarray], device="cuda"
                    ) -> Dict[str, torch.Tensor]:
    """``{"w": (d,), "b": ()}`` numpy arrays -> f32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(params[k], np.float32),
                               device=dev) for k in ("w", "b")}


def model_from_jax_state(coefficients: np.ndarray, intercept: float, cls,
                         device="cuda"):
    """A fitted model of the port's class ``cls`` holding the JAX model's
    ``coefficients`` and ``intercept``."""
    model = cls(device=device)
    model._state = LinearState(
        coefficients=np.asarray(coefficients, np.float64),
        intercept=float(intercept))
    return model


def softmax_model_from_jax(coefficients: np.ndarray, intercepts: np.ndarray,
                           labels: np.ndarray, device="cuda"):
    """A fitted port ``SoftmaxRegressionModel`` holding the JAX model's
    ``(d, classes)`` coefficients, ``(classes,)`` intercepts and original
    label values (its ``get_model_data()[0]`` columns, row 0)."""
    from ..data.table import Table
    from ..models.classification.softmaxregression import (
        SoftmaxRegressionModel)

    resolve_device(device)
    coef = np.asarray(coefficients, np.float64)
    bias = np.asarray(intercepts, np.float64)
    if coef.ndim != 2 or bias.shape != coef.shape[1:]:
        raise ValueError(f"coefficients must be (d, classes) and intercepts "
                         f"(classes,), got {coef.shape} and {bias.shape}")
    return SoftmaxRegressionModel(device=device).set_model_data(Table({
        "coefficients": coef[None], "intercepts": bias[None],
        "labels": np.asarray(labels)[None]}))


def kmeans_model_from_jax(centroids: np.ndarray, device="cuda"):
    """A fitted port ``KMeansModel`` holding the JAX model's ``(k, d)``
    centroids (``get_model_data()[0]["centroids"][0]`` of the JAX model)."""
    from ..models.clustering.kmeans import KMeansModel

    resolve_device(device)
    cents = np.asarray(centroids, np.float32)
    if cents.ndim != 2:
        raise ValueError(f"centroids must be (k, d), got shape {cents.shape}")
    model = KMeansModel(device=device)
    model._centroids = cents
    return model


def widedeep_params_from_jax(params, device="cuda"):
    """The JAX package's Wide&Deep parameters (a nested dict of numpy
    arrays, ``mlp`` a list of ``{"w", "b"}``) as f32 tensors on
    ``device``."""
    from ..models.recommendation.widedeep import params_to_device

    return params_to_device(params, resolve_device(device))


def adam_state_from_jax(opt_state, device="cuda"):
    """The port's optimizer state for a JAX package Wide&Deep state, as
    numpy: ``optax.adam``'s ``(ScaleByAdamState(count, mu, nu),
    EmptyState())`` becomes an :class:`~..models.common.adam.AdamState`;
    the lazy step's ``{"rest", "m", "v", "t"}`` becomes the port's lazy
    state."""
    from ..models.common.adam import AdamState
    from ..models.recommendation.widedeep import params_to_device

    dev = resolve_device(device)
    if isinstance(opt_state, dict):
        return {"rest": adam_state_from_jax(opt_state["rest"], dev),
                "m": params_to_device(opt_state["m"], dev),
                "v": params_to_device(opt_state["v"], dev),
                "t": int(np.asarray(opt_state["t"]))}
    adam = opt_state[0]
    return AdamState(count=int(np.asarray(adam.count)),
                     mu=params_to_device(adam.mu, dev),
                     nu=params_to_device(adam.nu, dev))


def ivf_index_from_jax(params, *, nlist: int, block: int, dim: int, k: int,
                       nprobe: int, pq, seed: int, list_slack: int,
                       drift_threshold, max_iter: int, stored,
                       device="cuda"):
    """A port ``IVFIndex`` with the JAX index's posting lists: ``params``
    is the JAX index's ``params`` (numpy), ``stored`` its
    ``stored_vectors()`` ``(ids, vectors)``, ``pq`` its ``PQConfig`` (any
    object with ``m``, ``ksub`` and ``max_iter``) or None; the other
    arguments are the JAX index's attributes of the same names."""
    from ..retrieval.ivf import IVFIndex, PQConfig

    resolve_device(device)
    ids, vectors = stored
    return IVFIndex(
        params={name: np.array(arr) for name, arr in params.items()},
        nlist=nlist, block=block, dim=dim, k=k, nprobe=nprobe,
        pq=None if pq is None else PQConfig(m=int(pq.m), ksub=int(pq.ksub),
                                            max_iter=int(pq.max_iter)),
        seed=seed, list_slack=list_slack, drift_threshold=drift_threshold,
        max_iter=max_iter,
        store={int(i): np.array(v, np.float32)
               for i, v in zip(np.asarray(ids).tolist(), vectors)},
        device=device)


def _port_table(table):
    """A JAX package ``Table`` (any object with ``column_names`` and
    ``__getitem__``) as a port ``Table`` of numpy columns."""
    from ..data.table import Table

    return Table({name: np.asarray(table[name])
                  for name in table.column_names})


def _numpy_tree(tree):
    """Nested dicts/lists of arrays as the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def _with_params(port_stage, jax_stage):
    port_stage.params_from_json(jax_stage.params_to_json())
    return port_stage


def feature_model_from_jax(stage, device="cuda"):
    """The port's counterpart of a JAX package feature stage of
    ``models/feature`` (a fitted ``*Model`` or a stateless transformer)
    or stats test of ``models/stats``: the same class name, params and
    model data."""
    from ..models import feature, stats
    from ..models.feature.transforms import _OnDevice

    resolve_device(device)
    name = type(stage).__name__
    cls = getattr(feature, name, None) or getattr(stats, name, None)
    if cls is None or not name[0].isupper():
        raise TypeError(f"{name} is not a ported feature stage")
    # the host stages (RandomSplitter, the tokenizers, the hashers,
    # SQLTransformer, ChiSqTest) take no device
    out = _with_params(cls(device=device) if issubclass(cls, _OnDevice)
                       else cls(), stage)
    if name == "StringIndexerModel":
        # per-column vocabularies of different lengths: not one Table
        out._vocab = {k: list(v) for k, v in stage._vocab.items()}
    elif name == "IndexToString":
        # labels set through set_labels, not model data
        if stage._labels is not None:
            out.set_labels(np.asarray(stage._labels))
    elif hasattr(stage, "get_model_data") and hasattr(out, "set_model_data"):
        out.set_model_data(*(_port_table(t) for t in stage.get_model_data()))
    if hasattr(stage, "model_version"):
        out.model_version = int(stage.model_version)
    return out


_LINEAR = ("LogisticRegressionModel", "LinearSVCModel",
           "LinearRegressionModel")

#: models carried across by their model-data tables
_MODEL_DATA = ("GBTClassifierModel", "GBTRegressorModel", "NaiveBayesModel",
               "KNNClassifierModel", "ALSModel", "MinHashLSHModel")


def model_data_from_jax(stage, device="cuda"):
    """The port's counterpart of a fitted JAX package
    ``GBTClassifierModel`` (binary or multiclass), ``GBTRegressorModel``,
    ``NaiveBayesModel``, ``KNNClassifierModel``, ``ALSModel`` or
    ``MinHashLSHModel``: the same class name, params and model-data
    tables."""
    from .. import models

    resolve_device(device)
    name = type(stage).__name__
    if name not in _MODEL_DATA:
        raise TypeError(f"{name} is not carried by its model data; "
                        f"expected one of {_MODEL_DATA}")
    cls = getattr(models, name, None) or getattr(models.feature, name)
    out = _with_params(cls(device=device), stage)
    return out.set_model_data(*(_port_table(t)
                                for t in stage.get_model_data()))


def onevsrest_model_from_jax(stage, device="cuda"):
    """The port's ``OneVsRestModel`` for a fitted JAX package one: its
    params, label values and each binary sub-model through its own
    converter."""
    from ..models.classification import OneVsRestModel

    resolve_device(device)
    out = _with_params(OneVsRestModel(), stage)
    out.models = [_stage_from_jax(sub, device) for sub in stage.models]
    out.label_values = np.asarray(stage.label_values)
    return out


#: host AlgoOperators carried across by their params alone
_ALGO_OPERATORS = ("AgglomerativeClustering",)


def algo_operator_from_jax(stage):
    """The port's counterpart of a JAX package host ``AlgoOperator``
    (``AgglomerativeClustering``): the same class name and params.  It
    holds no model data and takes no device."""
    from .. import models

    name = type(stage).__name__
    if name not in _ALGO_OPERATORS:
        raise TypeError(f"{name} is not a ported host AlgoOperator; "
                        f"expected one of {_ALGO_OPERATORS}")
    return _with_params(getattr(models, name)(), stage)


def _stage_from_jax(stage, device):
    from ..api.pipeline import PipelineModel
    from ..models import (LinearRegressionModel, LinearSVCModel,
                          LogisticRegressionModel, WideDeepModel)

    name = type(stage).__name__
    if name == "PipelineModel":
        return PipelineModel([_stage_from_jax(s, device)
                              for s in stage.stages])
    if name in _LINEAR:
        cls = {"LogisticRegressionModel": LogisticRegressionModel,
               "LinearSVCModel": LinearSVCModel,
               "LinearRegressionModel": LinearRegressionModel}[name]
        (data,) = stage.get_model_data()
        return _with_params(model_from_jax_state(
            np.asarray(data["coefficients"])[0],
            float(np.asarray(data["intercept"])[0]), cls, device), stage)
    if name in _MODEL_DATA:
        return model_data_from_jax(stage, device)
    if name == "OneVsRestModel":
        return onevsrest_model_from_jax(stage, device)
    if name in _ALGO_OPERATORS:
        return algo_operator_from_jax(stage)
    if name == "KMeansModel":
        (data,) = stage.get_model_data()
        return _with_params(kmeans_model_from_jax(
            np.asarray(data["centroids"])[0], device), stage)
    if name == "WideDeepModel":
        resolve_device(device)
        out = _with_params(WideDeepModel(device=device), stage)
        out._params = _numpy_tree(stage._params)
        out._vocab_sizes = tuple(int(v) for v in stage._vocab_sizes)
        return out
    if name == "IVFIndex":
        return ivf_index_from_jax(
            stage.params, nlist=stage.nlist, block=stage.block,
            dim=stage.dim, k=stage.k, nprobe=stage.nprobe, pq=stage.pq,
            seed=stage.seed, list_slack=stage.list_slack,
            drift_threshold=stage.drift_threshold, max_iter=stage.max_iter,
            stored=stage.stored_vectors(), device=device)
    return feature_model_from_jax(stage, device)


def pipeline_model_from_jax(pm, device="cuda"):
    """The port's ``PipelineModel`` for a fitted JAX package
    ``PipelineModel``: feature stages through
    :func:`feature_model_from_jax`, the linear family, KMeans, Wide&Deep,
    IVF indexes, the boosted trees, NaiveBayes, KNN, OneVsRest and
    AgglomerativeClustering through their converters (nested pipelines
    too)."""
    resolve_device(device)
    return _stage_from_jax(pm, device)


def grad_reduce_state_from_jax(state, rank: int, config=None,
                               device="cuda") -> dict:
    """Rank ``rank``'s reducer state in the port from the JAX package's
    participant-stacked one (numpy leaves with a leading participant dim,
    ``grad_reduce.init_state(config, like, n)`` or a reduce's output), so
    both packages resume the same schedule: ``ef``, ``pending``, ``ema``,
    ``rung`` (int32), ``tick`` (int32), ``fill`` and ``union`` are row
    ``rank``.  The JAX package's threefry ``key`` has no counterpart (the
    port draws from its own counter-based stream): it becomes the port's
    stream for ``(config.seed, rank)`` at the step ``tick`` gives (0
    without a tick), so ``config`` is needed when ``key`` is there."""
    from ..parallel.grad_reduce import state_participants

    dev = resolve_device(device)
    n = state_participants(state)
    if n is not None and not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside the state's {n} "
                         "participants")

    def row(a):
        if isinstance(a, dict):
            return {k: row(v) for k, v in a.items()}
        arr = np.asarray(a)[rank]
        dtype = np.int32 if arr.dtype.kind in "iu" else np.float32
        return torch.as_tensor(np.array(arr, dtype), device=dev)

    out = {}
    for key, value in state.items():
        if key == "key":
            if config is None:
                raise ValueError("a state with a rounding key needs the "
                                 "GradReduceConfig (its seed)")
            step = int(np.asarray(state["tick"])[rank]) \
                if "tick" in state else 0
            out[key] = torch.tensor([config.seed, rank, step],
                                    dtype=torch.int64, device=dev)
        elif key in ("ef", "pending", "ema", "rung", "tick", "fill",
                     "union"):
            out[key] = row(value)
        else:
            raise ValueError(f"unknown reducer-state leaf {key!r}")
    return out
