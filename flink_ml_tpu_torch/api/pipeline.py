"""Pipeline and PipelineModel.

Mirror of ``api/core/Pipeline.java`` and ``api/core/PipelineModel.java``:
``Pipeline.fit`` walks the stage list, fits every Estimator into a Model,
and keeps transforming the inputs through each produced/passed stage up to
(and excluding) the last Estimator (``Pipeline.java:74-103``).  The result is
a ``PipelineModel`` chaining ``transform`` across all resulting stages
(``PipelineModel.java:58-64``).

A copy of the JAX package's ``api/pipeline.py`` without the fused chain
branch.
"""

from __future__ import annotations

from typing import List, Sequence

from ..utils import persist
from .stage import AlgoOperator, Estimator, Model, Stage

__all__ = ["Pipeline", "PipelineModel"]


def _stagewise(stages, tables: List) -> List:
    """The classic per-stage path.  A multi-output stage (RandomSplitter)
    fans the flow out; single-input stages then map over every table
    independently — the columnar-batch extension of
    ``PipelineModel.java:58-64`` (previously a >1-table flow had no
    defined semantics here)."""
    for stage in stages:
        if len(tables) == 1:
            tables = list(stage.transform(*tables))
        else:
            fanned: List = []
            for t in tables:
                fanned.extend(stage.transform(t))
            tables = fanned
    return tables


class Pipeline(Estimator["PipelineModel"]):
    def __init__(self, stages: Sequence[Stage] = ()):  # no-arg constructible
        super().__init__()
        self._stages: List[Stage] = list(stages)

    @property
    def stages(self) -> List[Stage]:
        return list(self._stages)

    def fit(self, *inputs) -> "PipelineModel":
        """``Pipeline.java:74-103`` semantics: only transform inputs while
        stages before the *last* Estimator still need them."""
        last_estimator_idx = -1
        for i, stage in enumerate(self._stages):
            if isinstance(stage, Estimator):
                last_estimator_idx = i

        transformed = list(inputs)
        model_stages: List[AlgoOperator] = []
        for i, stage in enumerate(self._stages):
            # AlgoOperator takes precedence over Estimator for dual-typed
            # stages, matching ``Pipeline.java:89-93``.
            if isinstance(stage, AlgoOperator):
                fitted: AlgoOperator = stage
            elif isinstance(stage, Estimator):
                fitted = stage.fit(*transformed)
            else:
                raise TypeError(
                    f"Pipeline stage {i} ({type(stage).__name__}) is neither "
                    "an Estimator nor an AlgoOperator")
            model_stages.append(fitted)
            if i < last_estimator_idx:
                transformed = list(fitted.transform(*transformed))
        return PipelineModel(model_stages)

    def save(self, path: str) -> None:
        persist.save_pipeline(self, self._stages, path)

    @classmethod
    def load(cls, path: str) -> "Pipeline":
        return cls(persist.load_pipeline(path, cls))


class PipelineModel(Model):
    def __init__(self, stages: Sequence[AlgoOperator] = ()):  # no-arg constructible
        super().__init__()
        self._stages: List[AlgoOperator] = list(stages)

    @property
    def stages(self) -> List[AlgoOperator]:
        return list(self._stages)

    def transform(self, *inputs) -> List:
        """Sequentially feed outputs of stage i into stage i+1
        (``PipelineModel.java:58-64``).  Stagewise only: the JAX package's
        fused chain path (``api/chain.py``) is not ported yet."""
        return _stagewise(self._stages, list(inputs))

    def save(self, path: str) -> None:
        persist.save_pipeline(self, self._stages, path)

    @classmethod
    def load(cls, path: str) -> "PipelineModel":
        return cls(persist.load_pipeline(path, cls))
