"""The iteration loop: a single-device epoch loop in Python.

A port of the JAX package's ``iteration/core.py`` for what the KMeans fit
uses: the semantics of its fused mode, written as a plain loop (PyTorch
runs eagerly; there is nothing to compile).

- Without a termination criterion the loop runs ``max_epochs`` epochs and
  never waits for the device: the state stays on it and the host only
  enqueues work.
- With one (a body's ``termination`` vote, or a workset) the loop reads
  one scalar per epoch, "continue?", to decide its exit; the JAX package
  makes that decision on the device inside ``lax.while_loop``.  The
  per-epoch ``active_fraction`` and vote stay on the device until the end
  and come back in ``side["epoch_trace"]``.

Listeners, the hosted mode, per-round lifecycles, per-epoch data sources
and checkpoints are ROADMAP queue A3 and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .body import (
    IterationBodyResult,
    Workset,
    active_fraction,
    normalize_body_result,
)

__all__ = ["iterate", "IterationResult"]


@dataclass
class IterationResult:
    """Final state and outputs.  ``workset`` is the final :class:`Workset`
    of a workset iteration (None otherwise); ``side["epoch_trace"]`` of a
    criteria-driven loop holds ``{"active_fraction": (num_epochs,),
    "termination": (num_epochs,)}`` host arrays."""

    state: Any
    outputs: Any
    num_epochs: int
    side: dict
    workset: Any = None


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to flink_ml_tpu_torch yet (ROADMAP queue "
        "A3: the iteration runtime)")


def _call_body(body: Callable, state, epoch: int, data) -> IterationBodyResult:
    if data is None:
        return normalize_body_result(body(state, epoch))
    return normalize_body_result(body(state, epoch, data))


def iterate(body: Callable, initial_state: Any, data: Any = None, *,
            max_epochs: int, workset: Optional[Workset] = None,
            workset_tol: float = 0.0, mode: str = "fused",
            listeners: Sequence[Any] = (), checkpoint: Any = None
            ) -> IterationResult:
    """Run ``body`` from ``initial_state`` over device-resident ``data``.

    ``body(state, epoch[, data]) -> IterationBodyResult | state``; the
    state entering epoch ``e`` produces the state for epoch ``e + 1``.
    Ends when ``max_epochs`` epochs ran, when the body's ``termination``
    vote is zero, or, for a workset iteration, when the active fraction
    falls to ``workset_tol``.

    Workset iterations (``workset=``): the body is ``body(state, workset,
    epoch[, data])`` and its feedback is ``(new_state, new_workset)``."""
    if mode not in ("fused", "auto"):
        raise _not_ported(f"iteration mode {mode!r}")
    if listeners:
        raise _not_ported("iteration listeners")
    if checkpoint is not None:
        raise _not_ported("iteration checkpoints")
    if callable(data) or hasattr(data, "__next__"):
        raise _not_ported("per-epoch data sources")
    if max_epochs is None or max_epochs < 0:
        raise ValueError(f"max_epochs must be >= 0, got {max_epochs}")

    frac_fn = None
    if workset is not None:
        if not isinstance(workset, Workset):
            raise TypeError(
                f"workset= expects a Workset, got {type(workset).__name__}")
        ws_body, ws_tol = body, float(workset_tol)

        def body(carry, epoch, *rest):  # noqa: F811
            # the workset rides next to the state; continue while active
            # elements remain, AND-ed with any vote of the body
            state, ws = carry
            res = normalize_body_result(ws_body(state, ws, epoch, *rest))
            new_state, new_ws = res.feedback
            cont = active_fraction(new_ws) > ws_tol
            if res.termination is not None:
                cont = torch.logical_and(
                    cont, torch.as_tensor(res.termination).bool().reshape(()))
            return IterationBodyResult((new_state, new_ws), res.outputs, cont)

        initial_state = (initial_state, workset)
        frac_fn = lambda carry: active_fraction(carry[1])  # noqa: E731

    state, outputs, side = initial_state, [], {}
    num_epochs = 0
    fracs, votes = [], []
    for epoch in range(max_epochs):
        res = _call_body(body, state, epoch, data)
        state = res.feedback
        num_epochs = epoch + 1
        if res.termination is None:
            outputs.append(res.outputs)
            continue
        vote = torch.as_tensor(res.termination).reshape(())
        votes.append(vote.to(torch.float32))
        fracs.append(frac_fn(state) if frac_fn is not None
                     else torch.full((), float("nan"), device=vote.device))
        outputs = [res.outputs]
        if not bool(vote):        # the loop's one host read per epoch
            break
    if votes:
        side["epoch_trace"] = {
            "active_fraction": torch.stack(fracs).cpu().numpy().astype(
                np.float32),
            "termination": torch.stack(votes).cpu().numpy()}
        out = outputs[0] if outputs else None
    elif all(o is None for o in outputs):
        out = None
    else:
        out = _stack(outputs)
    if workset is not None:
        state, final_ws = state
        return IterationResult(state, out, num_epochs, side, final_ws)
    return IterationResult(state, out, num_epochs, side)


def _stack(outputs: list) -> Any:
    """Per-epoch outputs stacked along a new leading axis (the fused
    scan's stacking)."""
    first = outputs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outputs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([o[i] for o in outputs])
                           for i in range(len(first)))
    return torch.stack([torch.as_tensor(o) for o in outputs])
