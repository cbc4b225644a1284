"""Mask-aware loss functions for the linear-model family (torch twin of the
JAX package's ``models/common/losses.py``).

All losses share the margin form ``m = X @ w + b`` and are weighted:
padding rows carry weight 0, real rows carry the sample weight
(``HasWeightCol``), so padded batch rows contribute nothing.  The trainer
takes ``dloss/dmargin`` by ``torch.autograd.grad`` over the margin, so any
loss written here with differentiable torch ops plugs in.
"""

from __future__ import annotations

import torch

__all__ = ["logistic_loss", "squared_loss", "hinge_loss", "LOSSES"]


def _weighted_mean(values, weights):
    # Epsilon only guards the all-padding batch (weight sum exactly 0, where
    # the numerator is 0 too); real weighted means keep their scale.
    return torch.sum(values * weights) / torch.clamp(torch.sum(weights),
                                                     min=1e-12)


def logistic_loss(margin, labels, weights):
    """Binary log-loss on +-1 labels: log(1 + exp(-y * m)), computed as
    ``logaddexp(0, -y*m)`` like the JAX package."""
    y = labels * 2.0 - 1.0  # {0,1} -> {-1,+1}
    z = -y * margin
    return _weighted_mean(torch.logaddexp(torch.zeros_like(z), z), weights)


def squared_loss(margin, labels, weights):
    """0.5 * (m - y)^2 (LinearRegression)."""
    return _weighted_mean(0.5 * torch.square(margin - labels), weights)


def hinge_loss(margin, labels, weights):
    """max(0, 1 - y * m) on +-1 labels (LinearSVC)."""
    y = labels * 2.0 - 1.0
    z = 1.0 - y * margin
    return _weighted_mean(torch.maximum(torch.zeros_like(z), z), weights)


LOSSES = {
    "logistic": logistic_loss,
    "squared": squared_loss,
    "hinge": hinge_loss,
}
