"""OnlineKMeans — streaming mini-batch KMeans.

The unbounded-iteration counterpart of KMeans (Flink ML pairs each bounded
estimator with an online variant; the capability maps to
``Iterations.iterateUnboundedStreams``, ``Iterations.java:118-127``).  Each
epoch consumes one window of the stream and applies a decayed mini-batch
centroid update

    c_k <- (c_k * n_k * alpha + sum_batch) / (n_k * alpha + count_batch)

where ``alpha`` is the decay factor (alpha=1: running mean over the whole
stream; alpha=0: each batch fully replaces the statistics).  Centroids and
per-cluster weights stay on the device between windows.  The windows are
``max(k, 256)`` rows, below the stats kernel's 65536-row threshold
(``kmeans._KERNEL_MIN_ROWS``), so the update is plain tensor code, as the
JAX package's is ``jnp`` code.

A port of the JAX package's ``models/clustering/online_kmeans.py``.  The
fit and the model run on ``device`` (default ``"cuda"``; raises without a
card unless ``"cpu"`` is asked for).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...api.stage import Estimator
from ...data.stream import cursor_adapter, ensure_cursor_source, windows_of
from ...data.table import Table
from ...distance import DistanceMeasure
from ...iteration import IterationBodyResult, IterationConfig, iterate
from ...linalg import stack_vectors
from ...ops.kmeans import stats_from_assign
from ...params.param import FloatParam, ParamValidators
from ...utils import persist
from ...utils.device import resolve_device
from .kmeans import KMeansModel, KMeansParams, select_random_centroids

__all__ = ["OnlineKMeans", "OnlineKMeansModel", "decayed_update"]


class OnlineKMeansModel(KMeansModel):
    """KMeansModel + the model version counter of the streaming fit."""

    def __init__(self, device="cuda"):
        super().__init__(device=device)
        self.model_version = 0

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path, {"modelVersion": self.model_version})
        persist.save_model_arrays(path, "model",
                                  {"centroids": self._centroids})

    @classmethod
    def load(cls, path: str, device="cuda") -> "OnlineKMeansModel":
        """Load a model saved by this package or by the JAX package."""
        model = super().load(path, device=device)
        model.model_version = int(
            persist.load_metadata(path).get("modelVersion", 0))
        return model


def decayed_update(measure: DistanceMeasure, k: int, alpha: float,
                   centroids: torch.Tensor, weights: torch.Tensor,
                   X: torch.Tensor):
    """One window's decayed mini-batch update: ``(new_centroids,
    new_weights)``.  Clusters the window leaves empty keep their
    centroid."""
    assign = torch.argmin(measure.pairwise(X, centroids), dim=1)
    sums, counts = stats_from_assign(
        k, X, torch.ones(X.shape[0], dtype=X.dtype, device=X.device), assign)
    decayed = weights * alpha
    denom = decayed + counts
    new_centroids = torch.where(
        counts[:, None] > 0,
        (centroids * decayed[:, None] + sums)
        / torch.clamp_min(denom, 1e-12)[:, None],
        centroids)
    return new_centroids, denom


class OnlineKMeans(KMeansParams, Estimator[OnlineKMeansModel]):
    DECAY_FACTOR = FloatParam(
        "decayFactor", "Forgetting factor for old batch statistics.",
        default=1.0, validator=ParamValidators.in_range(0.0, 1.0))

    def get_decay_factor(self) -> float:
        return self.get(OnlineKMeans.DECAY_FACTOR)

    def set_decay_factor(self, v: float):
        return self.set(OnlineKMeans.DECAY_FACTOR, v)

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self._initial_centroids: Optional[np.ndarray] = None

    def set_initial_model_data(self, table: Table) -> "OnlineKMeans":
        self._initial_centroids = np.asarray(table["centroids"][0], np.float32)
        return self

    def fit(self, *inputs, checkpoint=None,
            resume: bool = False) -> OnlineKMeansModel:
        """``fit(stream)``: a Table (windowed by ``max(k, 256)`` rows) or an
        iterable of Tables (windows).  Returns when the stream ends.

        ``checkpoint``/``resume`` cut the (centroids, weights) state and
        the source cursor together (the OnlineLogisticRegression
        contract; wrap live feeds in ``data.wal.WindowLog``).
        Checkpointed fits must warm-start via ``set_initial_model_data``:
        sniffing init centroids from the first window would consume it
        BEFORE the checkpoint cursor repositions the stream."""
        (source,) = inputs
        dev = resolve_device(self.device)
        k = self.get_k()
        alpha = self.get_decay_factor()
        measure = DistanceMeasure.get_instance(self.get_distance_measure())
        feat = self.get_features_col()

        if checkpoint is not None:
            if self._initial_centroids is None:
                raise ValueError(
                    "checkpointed streaming fit needs "
                    "set_initial_model_data: sniffing init centroids "
                    "would consume a window before the cursor restores")
            source = ensure_cursor_source(source, max(k, 256))
            first = None
        else:
            batches_sniff = windows_of(source, max(k, 256))
            first = next(batches_sniff, None)
            if first is None:
                raise ValueError("OnlineKMeans.fit got an empty stream")

        first_X = (stack_vectors(first[feat]).astype(np.float32)
                   if first is not None else None)
        if self._initial_centroids is not None:
            init = self._initial_centroids
            if init.shape[0] != k:
                raise ValueError(
                    f"initial model data has {init.shape[0]} centroids but "
                    f"k={k}")
        else:
            init = select_random_centroids(first_X, k, self.get_seed())

        def payloads():
            if first is not None:
                yield first_X
                stream = batches_sniff
            else:
                stream = windows_of(source, max(k, 256))
            for t in stream:
                yield stack_vectors(t[feat]).astype(np.float32)

        def body(state, epoch, X):
            centroids, weights = state
            X = torch.from_numpy(np.ascontiguousarray(X)).to(dev)
            return IterationBodyResult(decayed_update(
                measure, k, alpha, centroids, weights, X))

        state0 = (torch.from_numpy(np.ascontiguousarray(init)).to(dev),
                  torch.zeros(k, dtype=torch.float32, device=dev))
        result = iterate(body, state0, cursor_adapter(source, payloads),
                         config=IterationConfig(mode="hosted", jit=False),
                         checkpoint=checkpoint, resume=resume)
        if result.num_epochs == 0:
            # a real resume always lands at >= 1 epoch, so zero means an
            # empty stream either way
            raise ValueError("OnlineKMeans.fit got an empty stream")

        model = OnlineKMeansModel(device=self.device)
        model.copy_params_from(self)
        model.set_model_data(Table(
            {"centroids": result.state[0].cpu().numpy()[None]}))
        model.model_version = result.num_epochs
        return model
