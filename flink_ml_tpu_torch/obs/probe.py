"""StepProbe — named per-step scalars in one device buffer.

K named channels pack into ONE ``(capacity, K)`` f32 tensor on the device
plus a host cursor, so

- **recording is a device write** (one packed row at the cursor, no host
  read inside a step), and
- **fetching is one transfer**: :meth:`fetch` copies the recorded rows to
  the host once, at a chunk or loop boundary, and splits them into
  per-channel arrays — never K transfers, never one per step.

NaN prefill marks rows never written (a channel a step did not provide).
``sgd_fit_outofcore(step_probe=True)`` records the per-step ``loss`` of
every live step (the chunk loop skips dead padded steps, so the series is
the same for any W) and surfaces the concatenated series as
``stream_info["step_trace"]``.

A port of the JAX package's ``obs/probe.py`` on torch tensors.  The JAX
probe is an immutable carry; this one writes its buffer in place, and
``record``/``reset`` return the probe to use next, so code written for
either reads the same.  (``record_at``, the JAX fused loop's, has no
caller here: the port's fused loop keeps its trace in a list.)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["StepProbe"]


class StepProbe:
    """K named per-step f32 scalars in one ``(capacity, K)`` device
    buffer and a host cursor (rows written so far)."""

    __slots__ = ("names", "capacity", "buf", "cursor")

    def __init__(self, names: Tuple[str, ...], capacity: int,
                 buf: Optional[torch.Tensor] = None, cursor: int = 0,
                 device: Any = "cpu"):
        self.names = tuple(names)
        self.capacity = int(capacity)
        if not self.names:
            raise ValueError("StepProbe needs at least one channel name")
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"duplicate channel names: {self.names}")
        if self.capacity <= 0:
            raise ValueError("capacity must be positive")
        self.buf = (buf if buf is not None else
                    torch.full((self.capacity, len(self.names)), float("nan"),
                               dtype=torch.float32, device=device))
        self.cursor = int(cursor)

    @classmethod
    def create(cls, names: Sequence[str], capacity: int,
               device: Any = "cpu") -> "StepProbe":
        return cls(tuple(names), capacity, device=device)

    def _row(self, scalars: Dict[str, Any]) -> torch.Tensor:
        unknown = set(scalars) - set(self.names)
        if unknown:
            raise ValueError(
                f"unknown probe channel(s) {sorted(unknown)}; this probe "
                f"records {self.names}")
        dev = self.buf.device
        return torch.stack([
            torch.as_tensor(scalars[n], dtype=torch.float32,
                            device=dev).reshape(())
            if n in scalars else torch.full((), float("nan"), device=dev)
            for n in self.names])

    def record(self, **scalars) -> "StepProbe":
        """Write one packed row at the cursor and advance it.  Channels
        not provided stay NaN for this step; past-capacity records are
        dropped (callers size ``capacity`` to the loop bound)."""
        if self.cursor < self.capacity:
            self.buf[self.cursor] = self._row(scalars)
            self.cursor += 1
        return self

    def reset(self) -> "StepProbe":
        """A fresh probe (NaN rows, cursor 0) on the same device."""
        return StepProbe(self.names, self.capacity, device=self.buf.device)

    def fetch(self) -> Dict[str, np.ndarray]:
        """Every channel's recorded steps, in ONE device-to-host copy."""
        buf = self.buf[:self.cursor].cpu().numpy()
        return {name: buf[:, i] for i, name in enumerate(self.names)}
