"""Iteration runtime: ``iterate`` (fused and hosted loops, listeners,
per-round state, per-epoch data) and validated checkpoints."""

from .body import (  # noqa: F401
    EpochContext,
    FnListener,
    IterationBodyResult,
    IterationConfig,
    IterationListener,
    OperatorLifeCycle,
    Workset,
    active_fraction,
    normalize_body_result,
)
from .checkpoint import (  # noqa: F401
    CheckpointConfig,
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from .core import IterationResult, PerEpoch, Replayed, iterate  # noqa: F401
