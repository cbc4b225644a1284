"""Device resolution for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU
(``device="cpu"``, as the tests do).  Without a card, a request for CUDA
raises: the port never carries on silently on the CPU."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises
    ``RuntimeError`` for a CUDA device when PyTorch sees no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flink_ml_tpu_torch: CUDA was requested but no GPU is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
