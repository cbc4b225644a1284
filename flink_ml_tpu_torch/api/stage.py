"""The Stage hierarchy: Estimator / AlgoOperator / Transformer / Model.

Re-design of ``flink-ml-api/.../api/core/`` (``Stage.java:34-45``,
``Estimator.java:31-38``, ``AlgoOperator.java:31-38``,
``Transformer.java:31-32``, ``Model.java:31-51``).

Differences from the reference, by design:
- Stages operate on in-memory columnar
  :class:`~flink_ml_tpu_torch.data.table.Table` objects (host numpy
  columns) instead of lazy Flink ``Table``s — fit/transform are eager
  PyTorch.
- ``load`` is a classmethod taking only a path (no execution environment).

A copy of the JAX package's ``api/stage.py``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Generic, List, TypeVar

from ..params.with_params import WithParams
from ..utils import persist

M = TypeVar("M", bound="Model")

__all__ = ["Stage", "AlgoOperator", "Transformer", "Model", "Estimator"]


class Stage(WithParams, ABC):
    """Base node of a pipeline.  Contract (``Stage.java:34-45``): subclasses
    are constructible with no args, support ``save(path)`` and a classmethod
    ``load(path)``."""

    def save(self, path: str) -> None:
        """Default: persist params-only stages via metadata alone
        (``ReadWriteUtils.saveMetadata``).  Stages with model data override
        and additionally write ``{path}/data``."""
        persist.save_metadata(self, path)

    @classmethod
    def load(cls, path: str) -> "Stage":
        stage = persist.load_stage_param(path)
        if not isinstance(stage, cls):
            raise IOError(f"Stage at {path} is a {type(stage).__name__}, "
                          f"not a {cls.__name__}")
        return stage


class AlgoOperator(Stage):
    """A stage that maps tables to tables (``AlgoOperator.java:31-38``)."""

    @abstractmethod
    def transform(self, *inputs) -> List:
        """Apply to one or more tables, returning one or more tables."""

    def transform_one(self, table):
        """Convenience for the common single-in/single-out case."""
        return self.transform(table)[0]


class Transformer(AlgoOperator):
    """Marker specialization (``Transformer.java:31-32``): a one-pass,
    model-free or model-backed table mapping."""


class Model(Transformer, Generic[M]):
    """A Transformer with explicit model data (``Model.java:31-51``)."""

    def set_model_data(self, *inputs) -> "Model":
        raise NotImplementedError(
            f"{type(self).__name__} does not support setModelData")

    def get_model_data(self) -> List:
        raise NotImplementedError(
            f"{type(self).__name__} does not support getModelData")


class Estimator(Stage, Generic[M]):
    """Fits tables into a Model (``Estimator.java:31-38``)."""

    @abstractmethod
    def fit(self, *inputs) -> M:
        ...
