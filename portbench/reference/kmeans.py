"""Lloyd's algorithm in plain float32 PyTorch, from its definition.

Init (``initMode`` random, Flink ML's ``selectRandomCentroids``): the
points shuffled by ``numpy.random.default_rng(seed).permutation(n)``, the
first ``k`` taken.  A round assigns each point to its nearest centroid
(the first on a tie) and moves each centroid to the mean of its points; a
centroid with no points stays.  Distances and sums are products: the
scores ``|c|^2 - 2 x.c`` (``|x|^2`` is the same for every centroid) and
the sums ``onehot^T x``, in blocks of rows so that a block's one-hot
matrix fits beside the points.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import products


def init_centroids(points: np.ndarray, k: int, seed: int) -> np.ndarray:
    idx = np.random.default_rng(seed).permutation(points.shape[0])[:k]
    return points[idx]


def lloyd(points: torch.Tensor, init: torch.Tensor, rounds: int, *,
          block: int = 1 << 16, tf32: bool = False,
          keep_half: bool = False, stale_last: int = 0) -> torch.Tensor:
    """``rounds`` of Lloyd's algorithm from ``init`` over ``points``
    (float32, on one device).  ``tf32`` computes the products on the TF32
    tensor cores (the control); ``keep_half`` leaves the second half of
    the points out of every mean, and ``stale_last`` leaves that many
    last centroids where they were (planted faults)."""
    c = init.clone()
    k = c.shape[0]
    moves = torch.arange(k, device=c.device) < k - stale_last
    n = points.shape[0] // 2 if keep_half else points.shape[0]
    cols = torch.arange(k, device=points.device)
    with products(tf32):
        for _ in range(rounds):
            sums = torch.zeros_like(c)
            counts = torch.zeros((k,), dtype=c.dtype, device=c.device)
            c_sq = torch.sum(c * c, dim=1)
            for lo in range(0, n, block):
                x = points[lo:min(n, lo + block)]
                assign = torch.argmin(c_sq[None, :] - 2.0 * (x @ c.T), dim=1)
                onehot = (assign[:, None] == cols[None, :]).to(c.dtype)
                sums += onehot.T @ x
                counts += torch.sum(onehot, dim=0)
            c = torch.where((counts[:, None] > 0) & moves[:, None],
                            sums / torch.clamp(counts, min=1.0)[:, None], c)
    return c


def near_ties(points: torch.Tensor, centroids: torch.Tensor, *,
              rel: float = 1e-5, block: int = 1 << 15) -> torch.Tensor:
    """The centroids that a point near a tie may join, as a boolean mask:
    for each point whose next two centroids include one whose squared
    distance (in float64) exceeds the least by at most ``rel`` times the
    point's and the nearest centroid's squared norms, the nearest and
    each such one.  A float32 round may assign the point to any of
    them."""
    c = centroids.double()
    c_sq = torch.sum(c * c, dim=1)
    tied = torch.zeros((c.shape[0],), dtype=torch.bool, device=c.device)
    for lo in range(0, points.shape[0], block):
        x = points[lo:lo + block].double()
        x_sq = torch.sum(x * x, dim=1)
        d = x_sq[:, None] + c_sq[None, :] - 2.0 * (x @ c.T)
        best, idx = torch.topk(d, min(3, c.shape[0]), dim=1, largest=False)
        tol = rel * (x_sq + c_sq[idx[:, 0]])
        near = best[:, 1:] - best[:, :1] <= tol[:, None]
        tied[idx[:, 1:][near]] = True
        tied[idx[:, 0][near.any(dim=1)]] = True
    return tied


def centroid_gaps(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each centroid's distance from the reference's, over the root mean
    square norm of the reference's centroids."""
    scale = float(np.sqrt(np.mean(np.sum(ref.astype(np.float64) ** 2,
                                         axis=1))))
    return np.linalg.norm(got.astype(np.float64) - ref, axis=1) / scale
