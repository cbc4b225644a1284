"""Iteration body contract: the result type and the workset.

A port of the part of the JAX package's ``iteration/body.py`` that the
KMeans fit uses (``Workset``, ``active_fraction``, ``IterationBodyResult``).
The body is a function, ``body(state, epoch, data) ->
IterationBodyResult``; ``state`` is the feedback state, tensors that stay
on the device between epochs.  Listeners, epoch contexts and lifecycles
are ROADMAP queue A3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

__all__ = ["IterationBodyResult", "Workset", "active_fraction",
           "normalize_body_result"]


@dataclass
class Workset:
    """Device-resident active set riding the iteration state: the delta
    iteration's workset as a mask over data that stays on the device.

    - ``mask``: per-element activity, a float32 0/1 (or bool) tensor, or a
      dict/list/tuple of them.  An element with mask 0 is settled this
      round: the body reuses its cached contribution.
    - ``bounds``: optional per-element state the body uses to decide
      settlement (KMeans: cached assignment, Hamerly upper/lower bounds).

    The loop stops when :func:`active_fraction` falls to ``workset_tol``
    (default exactly zero: the empty-workset criterion)."""

    mask: Any
    bounds: Any = None


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def active_fraction(workset: Workset) -> torch.Tensor:
    """Fraction of active elements as a 0-d float32 tensor on the masks'
    device: total mask mass over the element count of every mask leaf."""
    leaves = _leaves(workset.mask)
    total = sum(x.numel() for x in leaves)
    if total == 0:
        dev = leaves[0].device if leaves else None
        return torch.zeros((), dtype=torch.float32, device=dev)
    act = sum(torch.sum(x.to(torch.float32)) for x in leaves)
    return act / float(total)


@dataclass
class IterationBodyResult:
    """(feedback, outputs, termination):

    - ``feedback``: the next epoch's state;
    - ``outputs``: a per-epoch emission (or None);
    - ``termination``: optional scalar vote; zero/false ends the
      iteration."""

    feedback: Any
    outputs: Any = None
    termination: Optional[Any] = None


def normalize_body_result(result: Any) -> IterationBodyResult:
    """Accept an ``IterationBodyResult`` or a bare state (never unpacked)."""
    if isinstance(result, IterationBodyResult):
        return result
    return IterationBodyResult(result)
