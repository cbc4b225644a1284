"""OnlineStandardScaler — streaming mean/variance over table windows.

The online counterpart of StandardScaler (Flink ML 2.x pairs batch feature
estimators with online variants, the way OnlineKMeans pairs with KMeans).

Numerics: per-window centered statistics (count, mean, M2) merge across
windows with Chan's parallel-Welford update, all in host float64.  The
naive E[x^2] - E[x]^2 route in f32 catastrophically cancels for data with
large means (std 1 at mean 1e4 underflows to 0), which is exactly the
regime a streaming scaler exists for.  The stats are pure host numpy: a
mean/M2 pass is PCIe-transfer-bound, so moving the window to the card
would cost more than it saves.  The fitted model transforms on
``device`` like any ``StandardScalerModel``.

A port of the JAX package's ``models/feature/online_scaler.py``, over the
port's ``iteration.iterate`` and ``data/stream.py``.
"""

from __future__ import annotations

import numpy as np

from ...api.stage import Estimator
from ...data.stream import (cursor_adapter,
                            ensure_cursor_source, windows_of)
from ...data.table import Table
from ...iteration import IterationBodyResult, IterationConfig, iterate
from ...linalg import stack_vectors
from ...utils import persist
from .scalers import StandardScalerModel, StandardScalerParams
from .transforms import _OnDevice

__all__ = ["OnlineStandardScaler", "OnlineStandardScalerModel"]


def _window_stats(X: np.ndarray):
    """Per-window (count, mean, M2), centered, float64."""
    X = np.asarray(X, np.float64)
    mean = X.mean(axis=0)
    centered = X - mean
    return float(X.shape[0]), mean, (centered * centered).sum(axis=0)


def _merge(count, mean, m2, wc, wm, wm2):
    """Chan's parallel Welford merge, float64 on host."""
    total = count + wc
    delta = wm - mean
    new_mean = mean + delta * (wc / total)
    new_m2 = m2 + wm2 + delta * delta * (count * wc / total)
    return total, new_mean, new_m2


class OnlineStandardScalerModel(StandardScalerModel):
    """StandardScalerModel + the model version counter of the streaming
    fit (persisted, mirroring ``OnlineKMeansModel``)."""

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.model_version = 0

    def save(self, path: str) -> None:
        persist.save_metadata(self, path,
                              {"modelVersion": self.model_version})
        persist.save_model_arrays(path, "model",
                                  {"mean": self._mean, "std": self._std})

    @classmethod
    def load(cls, path: str, device="cuda") -> "OnlineStandardScalerModel":
        # array restore delegates to the parent (one source of truth for the
        # on-disk layout); only the version counter is ours
        model = super().load(path, device)
        model.model_version = int(
            persist.load_metadata(path).get("modelVersion", 0))
        return model


class OnlineStandardScaler(_OnDevice, StandardScalerParams,
                           Estimator[OnlineStandardScalerModel]):
    WINDOW_ROWS = 4096   # Table windowing granularity

    def fit(self, *inputs, checkpoint=None,
            resume: bool = False) -> OnlineStandardScalerModel:
        """``fit(stream)``: an iterable of Tables (windows), or one Table
        (consumed as batches).  Returns when the stream ends.

        ``checkpoint``/``resume`` follow the online-estimator contract
        (OnlineLogisticRegression/OnlineKMeans): the (count, mean, M2)
        statistics and the source cursor cut together; wrap live feeds
        in ``data.wal.WindowLog``.  No warm-start requirement — the
        zero-count state is a clean merge identity, so nothing needs
        sniffing before the cursor restores."""
        (source,) = inputs
        feat = self.get_features_col()
        if checkpoint is not None:
            source = ensure_cursor_source(source, self.WINDOW_ROWS)

        def payloads():
            for t in windows_of(source, self.WINDOW_ROWS):
                # empty windows pass through (skipping would desync the
                # source cursor from the epoch count); body ignores them
                yield stack_vectors(t[feat])

        def body(state, epoch, X):
            if len(X) == 0:
                return IterationBodyResult(state)
            wc, wm, wm2 = _window_stats(X)
            count, mean, m2 = state
            if count == 0:
                return IterationBodyResult((wc, wm, wm2))
            return IterationBodyResult(_merge(count, mean, m2, wc, wm, wm2))

        state0 = (0.0, np.zeros(0), np.zeros(0))
        result = iterate(
            body, state0, cursor_adapter(source, payloads),
            config=IterationConfig(mode="hosted", jit=False),
            checkpoint=checkpoint, resume=resume)
        count, mean, m2 = result.state
        if count == 0:
            raise ValueError("OnlineStandardScaler.fit got an empty stream")

        model = self._model_of(OnlineStandardScalerModel)
        model.set_model_data(Table({
            "mean": mean[None],
            "std": np.sqrt(np.maximum(m2 / count, 0.0))[None]}))
        model.model_version = result.num_epochs
        return model
