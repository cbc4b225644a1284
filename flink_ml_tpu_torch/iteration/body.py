"""Iteration body contract: result type, workset, listeners, epoch context.

A port of the JAX package's ``iteration/body.py`` (the reference's
``IterationBody.java:54-98``, ``IterationBodyResult.java:28-76``,
``IterationListener.java:30-74``, ``IterationConfig.java:22-66``).  The
body is a function, ``body(state, epoch, data) -> IterationBodyResult``;
``state`` is the feedback state, tensors that stay on the device between
epochs.
"""

from __future__ import annotations

import enum

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

__all__ = ["IterationBodyResult", "IterationListener", "FnListener",
           "EpochContext", "OperatorLifeCycle", "IterationConfig",
           "Workset", "active_fraction", "normalize_body_result"]


class OperatorLifeCycle(enum.Enum):
    """``IterationConfig.OperatorLifeCycle`` (``IterationConfig.java:22-66``):
    ALL_ROUND state is carried across epochs; PER_ROUND state is
    re-initialised every epoch (the analog of the reference scrubbing
    per-round operator state,
    ``perround/AbstractPerRoundWrapperOperator.java:579-650``)."""

    ALL_ROUND = "all_round"
    PER_ROUND = "per_round"


@dataclass
class IterationConfig:
    """Mirror of ``IterationConfig.java`` with the epoch loop's knobs.

    - ``mode``: ``"hosted"`` (a Python epoch loop with listeners,
      per-epoch data and checkpoints), ``"fused"`` (the loop without any
      of them: no host read per epoch unless a criterion votes) or
      ``"auto"`` (fused when there are no listeners, checkpoints,
      per-epoch data or PER_ROUND lifecycle and the body casts no vote —
      the JAX package's rule).
    - ``jit``: kept for API parity with the JAX package, where it chose a
      jitted step; PyTorch runs the body eagerly either way, so it only
      enters the ``"auto"`` rule as there (``jit=False`` -> hosted).
    - ``donate_state``: kept for API parity (the JAX package donates the
      state buffers to its jitted step).  Eager bodies build new tensors,
      so nothing is donated; an async checkpoint save copies the state to
      the host before it returns.
    - ``steps_per_dispatch`` (W): the hosted loop reads the termination
      vote on the host once per W epochs instead of every epoch.  A vote
      to stop inside a chunk freezes the state there (the chunk's later
      epochs run on the frozen state and are discarded), so results are
      bit for bit those of W = 1; listeners and checkpoint cuts move to
      chunk boundaries.
    """

    lifecycle: OperatorLifeCycle = OperatorLifeCycle.ALL_ROUND
    max_epochs: Optional[int] = None
    mode: str = "auto"
    jit: bool = True
    donate_state: bool = True
    steps_per_dispatch: int = 1

    def __post_init__(self):
        if self.mode not in ("auto", "hosted", "fused"):
            raise ValueError(f"Unknown iteration mode {self.mode!r}")
        if self.steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got "
                f"{self.steps_per_dispatch}")


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


@dataclass
class EpochContext:
    """Handed to listeners between epochs (hosted mode) — the analog of the
    ``IterationListener.Context`` + Collector pair."""

    epoch: int
    state: Any
    outputs: Any = None
    terminated: bool = False
    side: dict = field(default_factory=dict)

    def output(self, key: str, value: Any) -> None:
        """Side-output channel (the analog of ``ctx.output(OutputTag, v)``)."""
        self.side.setdefault(key, []).append(value)


class IterationListener:
    """Epoch-watermark callbacks (``IterationListener.java:30-74``), fired
    on the host between epochs of the hosted loop (at chunk boundaries
    with ``steps_per_dispatch > 1``)."""

    def on_epoch_watermark_incremented(self, epoch: int,
                                       context: EpochContext) -> None:
        pass

    def on_checkpoint_saved(self, epoch: int,
                            context: EpochContext) -> None:
        """Fires right after a checkpoint cut lands (hosted mode only).
        At this point the (state, source cursor) pair is durable, so a
        publish of exactly this state composes with crash recovery into
        exactly-once: a crash after the cut re-publishes the same step."""
        pass

    def on_iteration_terminated(self, context: EpochContext) -> None:
        pass


class FnListener(IterationListener):
    """Adapter: wrap plain callables as a listener."""

    def __init__(
            self,
            on_epoch: Optional[Callable[[int, EpochContext], None]] = None,
            on_terminated: Optional[Callable[[EpochContext], None]] = None):
        self._on_epoch = on_epoch
        self._on_terminated = on_terminated

    def on_epoch_watermark_incremented(self, epoch, context):
        if self._on_epoch:
            self._on_epoch(epoch, context)

    def on_iteration_terminated(self, context):
        if self._on_terminated:
            self._on_terminated(context)
