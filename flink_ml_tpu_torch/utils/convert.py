"""Carry weights from the JAX package into the port.

The JAX package's parameters reach this module as numpy arrays (the tests
pass them through ``np.asarray``); nothing here imports JAX."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.common.sgd import LinearState
from .device import resolve_device

__all__ = ["params_from_jax", "model_from_jax_state"]


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
