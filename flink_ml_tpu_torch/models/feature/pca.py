"""PCA — principal component analysis.

Estimator/Model pair: fit computes the covariance as ONE ``X^T X`` matmul
over the centered batch plus a (d, d) ``torch.linalg.eigh`` on the device
(symmetric eigendecomposition — d is the feature count, small); transform
is one projection matmul, run as a one-stage segment (``api/chain.py``),
so a standalone transform and the same stage inside a fused segment run
one function on one padded shape.  Components carry a deterministic sign
(largest-|loading| coordinate positive) so refits and reloads score
identically.

A port of the JAX package's ``models/feature/pca.py``.  Both products run
in full f32 (the port never turns on TF32).  Every stage runs on
``device`` (default ``"cuda"``; raises without a card unless ``"cpu"`` is
asked for).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.chain import StageKernel, as_matrix, numeric_entry
from ...api.stage import Estimator, Model
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.param import IntParam, ParamValidators
from ...utils import persist
from ...utils.device import resolve_device
from .transforms import _InOutParams, _kernel_transform, _OnDevice

__all__ = ["PCA", "PCAModel"]


class PCAParams(_InOutParams):
    K = IntParam("k", "Number of principal components.", default=2,
                 validator=ParamValidators.gt(0))

    def get_k(self) -> int:
        return self.get(PCAParams.K)

    def set_k(self, value: int):
        return self.set(PCAParams.K, value)


def _fit_pca(X: torch.Tensor, k: int):
    """Centered covariance -> top-k eigenvectors (descending variance)."""
    n = X.shape[0]
    mean = torch.mean(X, dim=0)
    Xc = X - mean[None, :]
    cov = (Xc.T @ Xc) / max(n - 1, 1)                 # (d, d)
    eigvals, eigvecs = torch.linalg.eigh(cov)          # ascending
    order = torch.argsort(-eigvals, stable=True)[:k]
    components = eigvecs[:, order].T                  # (k, d)
    variances = torch.clamp(eigvals[order], min=0.0)
    # deterministic sign: the largest-|loading| coordinate is positive
    pivot = torch.argmax(torch.abs(components), dim=1)
    signs = torch.sign(torch.take_along_dim(components, pivot[:, None],
                                            dim=1))
    components = components * torch.where(signs == 0, 1.0, signs)
    total = torch.clamp(torch.sum(torch.clamp(eigvals, min=0.0)), min=1e-30)
    return mean, components, variances, variances / total


def _pca_chain_kernel(static, params, cols):
    """The projection ``(X - mean) @ components.T``: one centered matmul."""
    (fcol, ocol) = static
    X = as_matrix(cols[fcol])
    return {ocol: (X - params["mean"][None, :]) @ params["components"].T}


class PCAModel(_OnDevice, PCAParams, Model):
    """Holds (mean, components (k, d), explained variance [ratio])."""

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._mean: Optional[np.ndarray] = None
        self._components: Optional[np.ndarray] = None
        self._variance: Optional[np.ndarray] = None
        self._variance_ratio: Optional[np.ndarray] = None

    def set_model_data(self, *inputs) -> "PCAModel":
        (t,) = inputs
        # single-row layout (each cell holds the whole array), matching
        # the KMeansModel convention — Table requires equal row counts
        self._mean = np.asarray(t["mean"][0], np.float64)
        self._components = np.asarray(t["components"][0], np.float64)
        self._variance = np.asarray(t["explainedVariance"][0], np.float64)
        self._variance_ratio = np.asarray(
            t["explainedVarianceRatio"][0], np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({
            "mean": self._mean[None, :],
            "components": self._components[None, :, :],
            "explainedVariance": self._variance[None, :],
            "explainedVarianceRatio": self._variance_ratio[None, :],
        })]

    @property
    def explained_variance_ratio(self) -> np.ndarray:
        self._require_model()
        return self._variance_ratio.copy()

    def _require_model(self) -> None:
        if self._components is None:
            raise RuntimeError("PCAModel has no model data; fit a PCA or "
                               "call set_model_data first")

    def transform_kernel(self, schema):
        self._require_model()
        fcol = self.get_features_col()
        if numeric_entry(schema, fcol) is None:
            return None
        return StageKernel(
            fn=_pca_chain_kernel,
            static=(fcol, self.get_output_col()),
            params={"mean": np.asarray(self._mean, np.float32),
                    "components": np.asarray(self._components, np.float32)},
            consumes=(fcol,), produces=(self.get_output_col(),),
            device=self.device)

    def _host_apply(self, X: np.ndarray) -> np.ndarray:
        return (X - self._mean[None, :]) @ self._components.T

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        out = _kernel_transform(self, table, self.transform_kernel,
                                self._host_apply)
        return [table.with_column(self.get_output_col(), out)]

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {
            "mean": self._mean, "components": self._components,
            "explainedVariance": self._variance,
            "explainedVarianceRatio": self._variance_ratio,
        })

    @classmethod
    def load(cls, path: str, device="cuda") -> "PCAModel":
        model = super().load(path, device)
        data = persist.load_model_arrays(path, "model")
        model._mean = data["mean"].astype(np.float64)
        model._components = data["components"].astype(np.float64)
        model._variance = data["explainedVariance"].astype(np.float64)
        model._variance_ratio = data["explainedVarianceRatio"].astype(
            np.float64)
        return model


class PCA(_OnDevice, PCAParams, Estimator[PCAModel]):
    def fit(self, *inputs) -> PCAModel:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()]).astype(np.float32)
        k = self.get_k()
        if k > X.shape[1]:
            raise ValueError(
                f"k={k} exceeds the feature dimension {X.shape[1]}")
        X = torch.from_numpy(np.ascontiguousarray(X)).to(
            resolve_device(self.device))
        mean, components, variance, ratio = (
            t.cpu().numpy().astype(np.float64) for t in _fit_pca(X, k))
        model = self._model_of(PCAModel)
        model._mean = mean
        model._components = components
        model._variance = variance
        model._variance_ratio = ratio
        return model
