"""Pluggable-by-name distance measures.

Mirror of ``flink-ml-api/.../distance/DistanceMeasure.java:27-43`` (registry
by name, ``distance(v1, v2)``) with the batched ``pairwise(points,
centroids)`` form that the estimators run: one matrix product per metric
instead of a Python double loop.

A port of the JAX package's ``distance.py``: ``pairwise`` takes and returns
torch tensors; ``pairwise_host64`` is the same numpy float64 form.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["DistanceMeasure", "register_distance_measure"]

_REGISTRY: Dict[str, "DistanceMeasure"] = {}


def register_distance_measure(name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        _REGISTRY[name] = cls()
        cls.name = name
        return cls
    return deco


class DistanceMeasure:
    """Base class; resolve with ``DistanceMeasure.get_instance(name)``
    (``DistanceMeasure.java:27-36``)."""

    name = "base"

    @staticmethod
    def get_instance(name: str) -> "DistanceMeasure":
        if name not in _REGISTRY:
            raise ValueError(
                f"distanceMeasure {name!r} is not supported; "
                f"available: {sorted(_REGISTRY)}")
        return _REGISTRY[name]

    # -- scalar form (API parity) ------------------------------------------
    def distance(self, v1, v2) -> float:
        a = np.asarray(getattr(v1, "values", v1), dtype=np.float64)
        b = np.asarray(getattr(v2, "values", v2), dtype=np.float64)
        return float(self.pairwise_host64(a[None, :], b[None, :])[0, 0])

    # -- batched tensor form (the hot path) --------------------------------
    def pairwise(self, points: torch.Tensor,
                 centroids: torch.Tensor) -> torch.Tensor:
        """``(n, d) x (k, d) -> (n, k)`` distance matrix on the tensors'
        device."""
        raise NotImplementedError

    # -- host float64 form --------------------------------------------------
    def pairwise_host64(self, points, centroids) -> np.ndarray:
        """Full-precision host pairwise matrix, for results that are
        precision-critical: the f32 ||x||^2 - 2xy expansion cancels
        catastrophically for data far from the origin."""
        raise NotImplementedError


@register_distance_measure("euclidean")
class EuclideanDistanceMeasure(DistanceMeasure):
    """``distance/EuclideanDistanceMeasure.java:36-44``.

    The pairwise form is the ||x||² - 2x·c + ||c||² expansion, clamped at 0,
    then sqrt: the expression of the JAX package's, which the workset
    bounds (root distances) and the workset kernel rely on."""

    def pairwise(self, points, centroids):
        p2 = torch.sum(points * points, dim=-1, keepdim=True)         # (n, 1)
        c2 = torch.sum(centroids * centroids, dim=-1)[None, :]        # (1, k)
        cross = points @ centroids.T                                  # (n, k)
        sq = torch.clamp_min(p2 - 2.0 * cross + c2, 0.0)
        return torch.sqrt(sq)

    def pairwise_host64(self, points, centroids) -> np.ndarray:
        p = np.asarray(points, np.float64)
        c = np.asarray(centroids, np.float64)
        sq = ((p * p).sum(1)[:, None] - 2.0 * (p @ c.T)
              + (c * c).sum(1)[None, :])
        return np.sqrt(np.maximum(sq, 0.0))


@register_distance_measure("cosine")
class CosineDistanceMeasure(DistanceMeasure):
    def pairwise(self, points, centroids):
        pn = points / (torch.linalg.norm(points, dim=-1, keepdim=True) + 1e-12)
        cn = centroids / (torch.linalg.norm(centroids, dim=-1, keepdim=True)
                          + 1e-12)
        return 1.0 - pn @ cn.T

    def pairwise_host64(self, points, centroids) -> np.ndarray:
        p = np.asarray(points, np.float64)
        c = np.asarray(centroids, np.float64)
        pn = p / (np.linalg.norm(p, axis=-1, keepdims=True) + 1e-12)
        cn = c / (np.linalg.norm(c, axis=-1, keepdims=True) + 1e-12)
        return 1.0 - pn @ cn.T


@register_distance_measure("manhattan")
class ManhattanDistanceMeasure(DistanceMeasure):
    def pairwise(self, points, centroids):
        # (n, 1, d) - (1, k, d): fine for moderate k; the default metric is
        # euclidean, which avoids the broadcast.
        return torch.sum(torch.abs(points[:, None, :] - centroids[None, :, :]),
                         dim=-1)

    def pairwise_host64(self, points, centroids) -> np.ndarray:
        p = np.asarray(points, np.float64)
        c = np.asarray(centroids, np.float64)
        out = np.empty((len(p), len(c)))
        chunk = max(1, (1 << 24) // max(len(c) * p.shape[1], 1))
        for s0 in range(0, len(p), chunk):  # bound the (chunk, k, d) temp
            out[s0:s0 + chunk] = np.abs(
                p[s0:s0 + chunk, None, :] - c[None, :, :]).sum(-1)
        return out
