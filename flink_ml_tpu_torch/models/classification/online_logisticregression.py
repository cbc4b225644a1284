"""OnlineLogisticRegression — streaming FTRL-proximal training.

BASELINE.json config 4: the unbounded-iteration capability
(``Iterations.iterateUnboundedStreams``, ``Iterations.java:118-127``).  The
reference's unbounded semantics — "epoch = one window of the stream, model
versions emitted continuously" — map to the hosted iteration loop with an
iterator data source: each epoch consumes one window from the stream, runs
one FTRL update (weights and accumulators stay on the device between
windows), and a listener snapshots a model version every
``modelSaveInterval`` windows (the analog of the model-data output stream).

FTRL-Proximal (per McMahan et al., the standard formulation):
    sigma = (sqrt(n + g^2) - sqrt(n)) / alpha
    z    += g - sigma * w
    n    += g^2
    w     = 0                                   if |z| <= l1
          = -(z - sign(z) l1) / ((beta + sqrt(n))/alpha + l2)   otherwise

The hashed update's gradient scatter-add sums in one fixed order on the
card (``sgd._scatter_add_``), so a resumed fit equals an
uninterrupted one bit for bit there as on the CPU.  The JAX package has no
Pallas kernel on this path.

A port of the JAX package's
``models/classification/online_logisticregression.py``.  The model runs on
``device`` (default ``"cuda"``; raises without a card unless ``"cpu"`` is
asked for).
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional

import numpy as np
import torch

from ...api.stage import Estimator
from ...data.stream import cursor_adapter, ensure_cursor_source, windows_of
from ...data.table import Table
from ...iteration import (
    EpochContext,
    IterationBodyResult,
    IterationConfig,
    IterationListener,
    iterate,
)
from ...params.param import FloatParam, IntParam, ParamValidators
from ...params.shared import (
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasNumFeatures,
    HasRegParam,
    HasWeightCol,
)
from ...utils import persist
from ...utils.device import resolve_device
from ..common.linear import check_sparse_indices, resolve_features
from ..common.sgd import DEFAULT_GLOBAL_BATCH, LinearState, _scatter_add_
from .logisticregression import LogisticRegressionModel

__all__ = ["OnlineLogisticRegression", "OnlineLogisticRegressionModel"]


class OnlineLogisticRegressionModel(LogisticRegressionModel):
    """A LogisticRegressionModel that also carries the model version (the
    analog of the versioned model-data stream) and the version history
    captured during the streaming fit.  ``save`` records the version in
    the metadata (``modelVersion``); a model saved without one (the JAX
    package's) loads at version 0."""

    def __init__(self, device="cuda"):
        super().__init__(device=device)
        self.model_version = 0
        self.version_history: List[LinearState] = []

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path, {"modelVersion": self.model_version})
        persist.save_model_arrays(path, "model", {
            "coefficients": self._state.coefficients,
            "intercept": np.array([self._state.intercept]),
        })

    @classmethod
    def load(cls, path: str, device="cuda"):
        model = super().load(path, device=device)
        model.model_version = int(
            persist.load_metadata(path).get("modelVersion", 0))
        return model


class OnlineLogisticRegression(HasFeaturesCol, HasLabelCol, HasWeightCol,
                               HasGlobalBatchSize, HasRegParam, HasElasticNet,
                               HasNumFeatures,
                               Estimator[OnlineLogisticRegressionModel]):
    ALPHA = FloatParam("alpha", "FTRL alpha (learning-rate scale).",
                       default=0.1, validator=ParamValidators.gt(0))
    BETA = FloatParam("beta", "FTRL beta (learning-rate smoothing).",
                      default=0.1, validator=ParamValidators.gt_eq(0))
    MODEL_SAVE_INTERVAL = IntParam(
        "modelSaveInterval",
        "Emit a model version every N batches.",
        default=1, validator=ParamValidators.gt(0))

    def get_alpha(self) -> float:
        return self.get(OnlineLogisticRegression.ALPHA)

    def set_alpha(self, v: float):
        return self.set(OnlineLogisticRegression.ALPHA, v)

    def get_beta(self) -> float:
        return self.get(OnlineLogisticRegression.BETA)

    def set_beta(self, v: float):
        return self.set(OnlineLogisticRegression.BETA, v)

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self._initial_model: Optional[np.ndarray] = None

    def set_initial_model_data(self, table: Table
                               ) -> "OnlineLogisticRegression":
        """Warm-start coefficients (the reference's setInitialModelData)."""
        self._initial_model = np.asarray(table["coefficients"][0], np.float64)
        return self

    # -- streaming fit ------------------------------------------------------
    def _batches(self, source) -> Iterator[tuple]:
        """Normalise the input into an iterator of host batches:
        ``("dense", X, y, w, 0)`` or ``("sparse", (idx, vals), y, w, dim)``
        (hashed pair columns / SparseVector rows — the Criteo shape; the
        mixed layout re-encodes as dense slots ``[0, nd)`` plus unit-value
        hashed ids)."""
        feat, lab = self.get_features_col(), self.get_label_col()
        wcol = self.get_weight_col()
        batch = self.get_global_batch_size() or DEFAULT_GLOBAL_BATCH

        def extract(t: Table):
            kind, feats = resolve_features(t, feat)
            y = np.asarray(t[lab], np.float32)
            w = (np.asarray(t[wcol], np.float32) if wcol
                 else np.ones_like(y))
            if kind == "mixed":
                dense, cat = feats
                nd = dense.shape[1]
                idx = np.concatenate(
                    [np.broadcast_to(np.arange(nd, dtype=np.int32),
                                     dense.shape), cat], axis=1)
                vals = np.concatenate(
                    [dense, np.ones(cat.shape, np.float32)], axis=1)
                return ("sparse", (idx, vals), y, w, 0)
            if kind == "sparse":
                idx, vals, dim = feats
                return ("sparse", (idx, vals), y, w, dim)
            return ("dense", feats.astype(np.float32), y, w, 0)

        for t in windows_of(source, batch):
            yield extract(t)

    def fit(self, *inputs, checkpoint=None,
            resume: bool = False) -> OnlineLogisticRegressionModel:
        """``fit(stream)`` where stream is a Table (windowed by
        globalBatchSize) or any iterable of Tables (a live unbounded feed).
        Returns when the stream ends; the model then holds the latest
        version plus history.

        ``checkpoint`` / ``resume`` make the streaming fit restartable: the
        FTRL state and the SOURCE CURSOR checkpoint together; on resume
        the stream repositions before any window is pulled.  For a live
        (non-replayable) feed, wrap it in
        :class:`flink_ml_tpu_torch.data.wal.WindowLog` so
        consumed-but-uncheckpointed windows replay from its write-ahead
        log.  Checkpointed fits must ``set_num_features`` (sniffing the
        width would consume a live window before the cursor restores).
        A resumed fit's ``version_history`` holds only post-resume
        versions; ``model_version`` still counts all windows."""
        (source,) = inputs
        dev = resolve_device(self.device)
        if checkpoint is not None:
            source = ensure_cursor_source(
                source, self.get_global_batch_size() or DEFAULT_GLOBAL_BATCH)
        reg, alpha_mix = self.get_reg(), self.get_elastic_net()
        l1, l2 = reg * alpha_mix, reg * (1.0 - alpha_mix)
        alpha, beta = self.get_alpha(), self.get_beta()

        d = self.get_num_features()
        lead: list = []   # sniffed batches replayed ahead of the stream
        batches = None    # built lazily inside the adapter
        if not d:
            if checkpoint is not None:
                raise ValueError(
                    "checkpointed streaming fit needs set_num_features: "
                    "sniffing the feature width would consume a window "
                    "before the checkpoint cursor repositions the stream")
            batches = self._batches(source)
            first = next(batches, None)
            if first is None:
                raise ValueError(
                    "OnlineLogisticRegression.fit got an empty stream")
            if first[0] == "sparse":
                d = first[4]
                if not d:
                    raise ValueError(
                        "hashed pair-column input needs numFeatures (the "
                        "hash-space size); call set_num_features")
            else:
                d = first[1].shape[1]
            lead = [first]

        w0 = (np.zeros((d,), np.float32) if self._initial_model is None
              else self._initial_model.astype(np.float32))
        state0 = {"w": torch.from_numpy(w0).to(dev),
                  "z": torch.zeros(d, dtype=torch.float32, device=dev),
                  "n": torch.zeros(d, dtype=torch.float32, device=dev)}
        kind_seen: dict = {}

        def payloads():
            stream = batches if batches is not None \
                else self._batches(source)
            for kind, feats, y, w, *_ in itertools.chain(lead, stream):
                sparse = kind == "sparse"
                if kind_seen.setdefault("sparse", sparse) != sparse:
                    raise ValueError(
                        "stream switched between dense and sparse features "
                        "mid-flight")
                if sparse:
                    check_sparse_indices(feats[0], d)
                elif feats.shape[1] != d:
                    raise ValueError(
                        f"dense stream width {feats.shape[1]} != "
                        f"numFeatures {d}; fix set_num_features (or unset "
                        "it to sniff the width)")
                yield feats, y, w

        def put(a, dtype=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.to(dev, dtype=dtype)

        ftrl = (alpha, beta, l1, l2)

        def body(state, epoch, data):
            feats, y, w = data
            if isinstance(feats, tuple):
                idx, vals = feats
                new_state, loss = sparse_ftrl_step(
                    state, put(idx, torch.int64), put(vals), put(y), put(w),
                    *ftrl)
            else:
                new_state, loss = ftrl_step(state, put(feats), put(y),
                                            put(w), *ftrl)
            return IterationBodyResult(new_state, outputs=loss)

        versions: List[LinearState] = []
        interval = self.get(OnlineLogisticRegression.MODEL_SAVE_INTERVAL)

        class VersionEmitter(IterationListener):
            def on_epoch_watermark_incremented(self, epoch, ctx: EpochContext):
                if (epoch + 1) % interval == 0:
                    versions.append(LinearState(
                        ctx.state["w"].cpu().numpy().astype(np.float64),
                        0.0))

        result = iterate(
            body, state0, cursor_adapter(source, payloads),
            config=IterationConfig(mode="hosted"),
            listeners=[VersionEmitter()],
            checkpoint=checkpoint, resume=resume)
        if result.num_epochs == 0:
            # a real resume always lands at >= 1 (saves fire only after an
            # epoch), so zero epochs means an empty stream either way
            raise ValueError("OnlineLogisticRegression.fit got an empty stream")

        model = OnlineLogisticRegressionModel(device=self.device)
        model.copy_params_from(self)
        model._state = LinearState(
            result.state["w"].cpu().numpy().astype(np.float64), 0.0)
        model.model_version = result.num_epochs
        model.version_history = versions
        return model


def _log_loss(p, y, sample_w, weight_sum):
    return (-torch.sum(sample_w * (y * torch.log(p + 1e-12)
                                   + (1 - y) * torch.log(1 - p + 1e-12)))
            / weight_sum)


def _ftrl_apply(state, g, alpha: float, beta: float, l1: float, l2: float):
    """The per-coordinate FTRL-proximal update from the gradient ``g``."""
    w, z, n = state["w"], state["z"], state["n"]
    sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / alpha
    z = z + g - sigma * w
    n = n + g * g
    new_w = torch.where(
        torch.abs(z) <= l1, 0.0,
        -(z - torch.sign(z) * l1) / ((beta + torch.sqrt(n)) / alpha + l2))
    return {"w": new_w, "z": z, "n": n}


def ftrl_step(state, X, y, sample_w, alpha: float, beta: float, l1: float,
              l2: float):
    """One FTRL-proximal update on a dense window ``X (b, d)``:
    ``(new_state, loss)``."""
    p = torch.sigmoid(X @ state["w"])
    weight_sum = torch.clamp_min(torch.sum(sample_w), 1e-12)
    g = X.T @ ((p - y) * sample_w) / weight_sum
    return (_ftrl_apply(state, g, alpha, beta, l1, l2),
            _log_loss(p, y, sample_w, weight_sum))


def sparse_ftrl_step(state, idx, vals, y, sample_w, alpha: float,
                     beta: float, l1: float, l2: float):
    """FTRL update for a hashed ``(indices, values)`` window (``idx`` int64
    ``(b, nnz)``): the gradient is one scatter-add into the dense
    coordinate space, summed in a fixed order on the card, after which the
    update is the per-coordinate formula; coordinates with ``g = 0`` are
    exact fixed points (sigma 0, z and n unchanged), so the dense formula
    IS the classic sparse/lazy FTRL."""
    w = state["w"]
    p = torch.sigmoid(torch.sum(vals * w[idx], dim=-1))
    weight_sum = torch.clamp_min(torch.sum(sample_w), 1e-12)
    r = (p - y) * sample_w / weight_sum
    g = _scatter_add_(torch.zeros_like(w), idx.reshape(-1),
                      (vals * r[:, None]).reshape(-1))
    return (_ftrl_apply(state, g, alpha, beta, l1, l2),
            _log_loss(p, y, sample_w, weight_sum))
