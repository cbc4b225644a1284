"""Continuous learning: train-while-serve with incremental delta
publishes.  A port of the JAX package's ``online/`` (host code; the
training it drives runs the streamed fit's kernels on the card).

- :mod:`.delta` — bit-exact param-delta codec with digest verification
- :mod:`.publish` — producer/consumer publish protocol; rebinds of the
  live kernel servables (new params on the card once a generation)
- :mod:`.staleness` — publish cadence + delta-vs-full decision rule
- :mod:`.driver` — the supervised forever-loop off the WAL, and the
  hosted-``iterate`` publishing listener
"""

from .delta import (
    DeltaBaseMismatch,
    DeltaCorrupt,
    DeltaShapeChanged,
    FullUpdate,
    ParamDelta,
    apply_delta,
    diff_params,
    flatten_params,
    full_update,
    tree_digest,
    unflatten_params,
)
from .driver import ContinuousLearner, PublishingListener, encode_and_publish
from .publish import (
    DeltaEncoder,
    DeltaPublisher,
    DeterminismViolation,
    PublishResult,
    model_with_params,
    params_of_model,
)
from .staleness import PublishStats, StalenessPolicy

__all__ = [
    "ContinuousLearner", "DeltaBaseMismatch", "DeltaCorrupt",
    "DeltaEncoder", "DeltaPublisher", "DeltaShapeChanged",
    "DeterminismViolation", "FullUpdate", "ParamDelta", "PublishResult",
    "PublishStats", "PublishingListener", "StalenessPolicy",
    "apply_delta", "diff_params", "encode_and_publish", "flatten_params",
    "full_update", "model_with_params", "params_of_model", "tree_digest",
    "unflatten_params",
]
