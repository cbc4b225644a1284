"""Iteration runtime (ported so far: the single-device loop the KMeans fit
uses; ROADMAP queue A3 holds the rest)."""

from .body import (  # noqa: F401
    IterationBodyResult,
    Workset,
    active_fraction,
    normalize_body_result,
)
from .core import IterationResult, iterate  # noqa: F401
