"""Profiler hooks: the port of the JAX package's ``utils/profiler.py``.

Thin wrappers over ``torch.profiler``: :func:`trace` records the host and,
where a card is present, its kernels into a Chrome trace (view it in
Perfetto or ``chrome://tracing``); :func:`annotate` names a host span on
that timeline; :class:`StepTimer` and :func:`fenced_call` time a call on
the host's clock behind a device fence, so the time covers the work the
call queued on the card.
"""

from __future__ import annotations

import contextlib
import os
import time

from typing import Any, Callable, Iterator, Optional, Tuple

import torch

__all__ = ["trace", "annotate", "StepTimer", "fenced_call"]

#: The trace file :func:`trace` writes into its ``log_dir``.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a host (and, with a card, device) profile into
    ``log_dir/trace.json`` (a Chrome trace).  Usage: ``with
    profiler.trace("prof"): fit()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named host annotation that shows up on the trace timeline (a
    context manager)."""
    return torch.profiler.record_function(name)


def _fence(probe: Any) -> None:
    """Wait for the work queued on a CUDA probe's card; nothing for a host
    value (its value is already there)."""
    if isinstance(probe, torch.Tensor) and probe.is_cuda:
        torch.cuda.synchronize(probe.device)


class StepTimer:
    """Wall-clock timer with a device fence: ``stop(probe)`` synchronizes
    the card a CUDA ``probe`` lives on before it reads the clock (a kernel
    launch returns before the kernel runs)."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None
        self.laps = []

    def start(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def stop(self, probe=None) -> float:
        if probe is not None:
            _fence(probe)
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        elapsed = time.perf_counter() - self._t0
        self.laps.append(elapsed)
        self._t0 = None
        return elapsed


def _default_probe(result: Any) -> Any:
    """The completion probe when the caller names none: the first tensor
    leaf of the result (dicts, lists and tuples walked in order)."""
    if isinstance(result, torch.Tensor):
        return result
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for leaf in result:
            probe = _default_probe(leaf)
            if probe is not None:
                return probe
    return None


def fenced_call(fn: Callable, *args: Any,
                probe_of: Optional[Callable[[Any], Any]] = None,
                **kwargs: Any) -> Tuple[Any, float]:
    """Run ``fn(*args, **kwargs)``, fence completion on a probe from the
    result (``probe_of(result)``, default its first tensor leaf) and return
    ``(result, seconds)``: the device-fenced wall-timing idiom in one
    copy.  The fence belongs on the host side of a step, never inside
    one."""
    timer = StepTimer().start()
    result = fn(*args, **kwargs)
    probe = probe_of(result) if probe_of is not None \
        else _default_probe(result)
    return result, timer.stop(probe)
