"""Pipeline and PipelineModel.

Mirror of ``api/core/Pipeline.java`` and ``api/core/PipelineModel.java``:
``Pipeline.fit`` walks the stage list, fits every Estimator into a Model,
and keeps transforming the inputs through each produced/passed stage up to
(and excluding) the last Estimator (``Pipeline.java:74-103``).  The result is
a ``PipelineModel`` chaining ``transform`` across all resulting stages
(``PipelineModel.java:58-64``).

A copy of the JAX package's ``api/pipeline.py``: runs of chainable stages
execute as fused device segments (``api/chain.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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


def _place(stages, device) -> List:
    """Set ``device`` on every loaded stage that runs on one (nested
    pipelines included); ``None`` keeps the stages' load default."""
    if device is not None:
        for stage in stages:
            if isinstance(stage, (Pipeline, PipelineModel)):
                _place(stage._stages, device)
            elif hasattr(stage, "device"):
                stage.device = device
    return stages


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
    def load(cls, path: str, device=None) -> "Pipeline":
        return cls(_place(persist.load_pipeline(path, cls), device))


class PipelineModel(Model):
    def __init__(self, stages: Sequence[AlgoOperator] = ()):  # no-arg constructible
        super().__init__()
        self._stages: List[AlgoOperator] = list(stages)

    @property
    def stages(self) -> List[AlgoOperator]:
        return list(self._stages)

    def transform(self, *inputs) -> List:
        """Sequentially feed outputs of stage i into stage i+1
        (``PipelineModel.java:58-64``).

        When every stage in a run is chainable (``api/chain.py`` kernel
        protocol), the run executes as ONE device segment instead of
        per-stage copies in and out — bit-exact with the stagewise path,
        auto-selected, cached per input schema."""
        tables = list(inputs)
        plan = self._chain_plan(tables)
        if plan is not None:
            return plan.transform(*tables)
        return _stagewise(self._stages, tables)

    def _chain_plan(self, tables) -> Optional[object]:
        """The cached fused plan for this input schema, or None when the
        chain is disabled, no segment merges >= 2 stages, or plan build
        fails (every one of these runs the stagewise path).

        The cache key includes every stage's live param values, so a
        post-build ``set_threshold(...)`` / ``set_prediction_col(...)``
        builds a fresh plan instead of serving the stale kernels the old
        values were baked into.  (Mutating fitted MODEL DATA in place via
        ``set_model_data`` after a transform is not fingerprinted —
        reload or rebuild the PipelineModel for that.)"""
        from ..data.table import Table
        from . import chain

        if not chain._enabled() or not self._stages or not tables:
            return None
        if not all(isinstance(t, Table) for t in tables):
            return None
        keys = {chain.raw_schema(t) for t in tables}
        if len(keys) != 1:
            return None          # mixed-schema flows stay stagewise
        # a stage's device steers its kernel's device, so it keys too
        params_key = tuple(
            (tuple(sorted((p.name, repr(v))
                          for p, v in s._ensure_param_map().items())),
             str(getattr(s, "device", None)))
            if hasattr(s, "_ensure_param_map") else id(s)
            for s in self._stages)
        (schema_key,) = keys
        key = (schema_key, params_key)
        cache = self.__dict__.setdefault("_chain_plans", {})
        if key in cache:
            return cache[key]
        if len(cache) > 32:      # param-churn guard: plans are rebuildable
            cache.clear()
        example = tables[0].take(min(tables[0].num_rows, 8))
        try:
            plan = chain.compile_pipeline(self, example)
            plan = plan if plan.worthwhile else None
        except Exception:        # unported config/schema: stagewise
            plan = None
        cache[key] = plan
        return plan

    def save(self, path: str) -> None:
        persist.save_pipeline(self, self._stages, path)

    @classmethod
    def load(cls, path: str, device=None) -> "PipelineModel":
        """Load a pipeline saved by this package or by the JAX package;
        ``device`` places every stage (default: each stage's own)."""
        return cls(_place(persist.load_pipeline(path, cls), device))
