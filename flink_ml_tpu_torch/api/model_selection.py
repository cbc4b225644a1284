"""Model selection: ParamGridBuilder + CrossValidator / TrainValidationSplit.

Beyond-reference surface (the flink-ml snapshot has no model selection;
the capability is table stakes for a pipeline framework — the Spark ML
`CrossValidator` shape, expressed over this repo's Stage/Param API).

Each candidate fit runs over the SAME fold tables, sliced once on the
host with the JAX package's seeded shuffle (so the folds are identical)
and reused across the whole grid; nothing here adds device state of its
own.  Scoring goes through any evaluator stage whose ``transform`` emits
a single-row metrics Table (the ``models/evaluation`` family).  Cloned
candidates keep the original stage's ``device``.

A copy of the JAX package's ``api/model_selection.py``; the fitted
:class:`CrossValidatorModel` also keeps each candidate's per-fold
metrics (``fold_metrics``).
"""

from __future__ import annotations

import itertools

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.table import Table
from ..params.param import BoolParam, FloatParam, IntParam, Param, \
    ParamValidators, StringParam
from ..params.shared import HasSeed
from .stage import AlgoOperator, Estimator, Model

__all__ = ["ParamGridBuilder", "CrossValidator", "CrossValidatorModel",
           "TrainValidationSplit"]


class ParamGridBuilder:
    """Cartesian product of per-param value lists (the Spark ML idiom)::

        grid = (ParamGridBuilder()
                .add_grid(LogisticRegression.REG, [0.0, 0.01, 0.1])
                .add_grid(LogisticRegression.MAX_ITER, [10, 50])
                .build())          # 6 param maps
    """

    def __init__(self):
        self._grid: List[Tuple[Param, Sequence[Any]]] = []

    def add_grid(self, param: Param, values: Sequence[Any]
                 ) -> "ParamGridBuilder":
        if not isinstance(param, Param):
            raise TypeError(f"add_grid needs a Param, got {type(param)}")
        if len(values) == 0:
            raise ValueError(f"empty value list for {param.name}")
        # repeated add_grid for a param REPLACES its values (the Spark
        # behavior) instead of silently multiplying duplicate candidates
        self._grid = [(p, v) for p, v in self._grid if p is not param]
        self._grid.append((param, list(values)))
        return self

    def build(self) -> List[Dict[Param, Any]]:
        if not self._grid:
            return [{}]
        params = [p for p, _ in self._grid]
        return [dict(zip(params, combo))
                for combo in itertools.product(
                    *(vals for _, vals in self._grid))]


def _declares(stage, param: Param) -> bool:
    """Does this stage's class hierarchy declare THIS param object?
    (Identity over the MRO — name collisions between unrelated params
    never match; shared Has* mixin params match every inheriting stage.)
    A nested Pipeline declares whatever its descendants declare."""
    from .pipeline import Pipeline

    if isinstance(stage, Pipeline):
        return any(_declares(s, param) for s in stage.stages)
    return any(v is param for klass in type(stage).__mro__
               for v in vars(klass).values())


def _bind_in_children(children, param: Param, value) -> bool:
    from .pipeline import Pipeline

    hit = False
    for child in children:
        if isinstance(child, Pipeline):
            hit |= _bind_in_children(child.stages, param, value)
        elif _declares(child, param):
            child.set(param, value)
            hit = True
    return hit


def _fresh(stage):
    """A new instance of ``stage``'s class with its params and its
    ``device``."""
    clone = type(stage)()
    clone.copy_params_from(stage)
    if hasattr(stage, "device"):
        clone.device = stage.device
    return clone


def _clone_with(stage, param_map: Dict[Any, Any], _grid_params=None):
    """Fresh stage with ``stage``'s params plus ``param_map`` overrides.

    A Pipeline candidate clones its ESTIMATOR children (nested pipelines
    recursively) and any transformer/model child that declares a bound
    grid param (so ``child.set`` on a candidate never mutates the
    caller's original pipeline, and candidates don't share one mutable
    stage).  A fitted Model clones as a shallow copy with its own param
    map — its fitted data is shared by reference (fit never mutates it;
    re-instantiating would drop it).  Grid-untouched transformer/model
    children are reused as-is.  Grid keys bind by param-object IDENTITY
    on every declaring descendant (a shared ``Has*`` mixin param
    therefore reaches all stages inheriting it); to pin a value to one
    top-level child, use a ``(child_index, Param)`` tuple key.  A key
    binding nowhere is an error."""
    from .pipeline import Pipeline
    from .stage import Model

    # The full set of grid params steers transformer cloning through
    # nested-pipeline recursion (where param_map is empty but the outer
    # _bind_in_children will still reach the descendants).
    grid_params = (_grid_params if _grid_params is not None else
                   [key[1] if isinstance(key, tuple) else key
                    for key in param_map])

    def _clone_transformer(t):
        if isinstance(t, Model):
            # keep the fitted data (re-instantiating would drop it):
            # shallow-copy the instance and give it an independent param
            # map so grid binds never reach the caller's original
            import copy

            clone = copy.copy(t)
            clone.__dict__["_param_map"] = dict(t.get_param_map())
            return clone
        return _fresh(t)

    if isinstance(stage, Pipeline):
        children = [
            _clone_with(s, {}, grid_params)
            if isinstance(s, (Pipeline, Estimator))
            else _clone_transformer(s)
            if any(_declares(s, p) for p in grid_params)
            else s
            for s in stage.stages]
        clone = Pipeline(children)
        clone.copy_params_from(stage)
        for key, value in param_map.items():
            if isinstance(key, tuple):
                idx, param = key
                target = children[idx]
                if not (_declares(target, param)
                        and _bind_in_children([target], param, value)):
                    raise ValueError(
                        f"pipeline stage {idx} does not declare "
                        f"{param.name!r}")
            elif not _bind_in_children(children, key, value):
                raise ValueError(
                    f"grid param {key.name!r} matches no pipeline stage")
        return clone
    clone = _fresh(stage)
    for key, value in param_map.items():
        if isinstance(key, tuple):
            raise ValueError(
                "(child_index, Param) grid keys only apply to Pipeline "
                "estimators")
        clone.set(key, value)   # set() resolves by name and validates
    return clone


def _score(evaluator, table: Table, metric: Optional[str]) -> float:
    """One scalar from an evaluator stage's single-row metrics Table."""
    (out,) = evaluator.transform(table)
    names = out.column_names
    if metric is None:
        if len(names) != 1:
            raise ValueError(
                f"evaluator emitted metrics {names}; set metricName to "
                "pick one")
        metric = names[0]
    if metric not in names:
        raise ValueError(f"metric {metric!r} not in evaluator output "
                         f"{names}")
    return float(np.asarray(out[metric])[0])


class _SelectorBase(HasSeed, Estimator["CrossValidatorModel"]):
    """Shared machinery: candidate grid x fold loop -> best model."""

    METRIC_NAME = StringParam(
        "metricName",
        "Column of the evaluator's metrics Table to optimize (None: the "
        "evaluator must emit exactly one).", default=None,
        validator=ParamValidators.always_true())
    LARGER_IS_BETTER = BoolParam(
        "largerIsBetter", "Maximize the metric (else minimize).",
        default=True)

    def __init__(self, estimator=None, evaluator=None, param_grid=None):
        super().__init__()
        self._estimator = estimator
        self._evaluator = evaluator
        self._param_grid = param_grid or [{}]

    # estimator/evaluator/grid are python objects, not serializable params
    def set_estimator(self, est):
        self._estimator = est
        return self

    def set_evaluator(self, ev):
        self._evaluator = ev
        return self

    def set_param_grid(self, grid: List[Dict[Param, Any]]):
        self._param_grid = list(grid) or [{}]
        return self

    def set_metric_name(self, name: str):
        return self.set(_SelectorBase.METRIC_NAME, name)

    def set_larger_is_better(self, larger: bool):
        return self.set(_SelectorBase.LARGER_IS_BETTER, bool(larger))

    def _check(self):
        if self._estimator is None or self._evaluator is None:
            raise ValueError(
                f"{type(self).__name__} needs set_estimator and "
                "set_evaluator")

    def _splits(self, table: Table) -> List[Tuple[Table, Table]]:
        raise NotImplementedError

    def fit(self, *inputs) -> "CrossValidatorModel":
        (table,) = inputs
        self._check()
        splits = self._splits(table)
        larger = self.get(_SelectorBase.LARGER_IS_BETTER)
        metric = self.get(_SelectorBase.METRIC_NAME)

        avg_metrics: List[float] = []
        fold_metrics: List[List[float]] = []
        for param_map in self._param_grid:
            scores = []
            for train, val in splits:
                candidate = _clone_with(self._estimator, param_map)
                model = candidate.fit(train)
                # Pipeline candidates score through the fused chain
                # (api/chain.py): every fold's model has the same stage
                # types, column names and shapes, and its params reach the
                # device once per plan
                (pred,) = model.transform(val)
                scores.append(_score(self._evaluator, pred, metric))
            fold_metrics.append(scores)
            avg_metrics.append(float(np.mean(scores)))

        best_idx = int(np.argmax(avg_metrics) if larger
                       else np.argmin(avg_metrics))
        best_est = _clone_with(self._estimator, self._param_grid[best_idx])
        best_model = best_est.fit(table)   # refit on ALL rows

        out = CrossValidatorModel()
        out.copy_params_from(self)
        out.best_model = best_model
        out.best_index = best_idx
        out.best_params = self._param_grid[best_idx]
        out.avg_metrics = avg_metrics
        out.fold_metrics = fold_metrics
        return out


class CrossValidator(_SelectorBase):
    """k-fold cross validation over a candidate param grid: every
    candidate trains k times (fold i held out for scoring), the best
    average metric wins, and the winner refits on the full table."""

    NUM_FOLDS = IntParam("numFolds", "Number of folds.", default=3,
                         validator=ParamValidators.gt_eq(2))

    def set_num_folds(self, k: int):
        return self.set(CrossValidator.NUM_FOLDS, k)

    def get_num_folds(self) -> int:
        return self.get(CrossValidator.NUM_FOLDS)

    def _splits(self, table: Table) -> List[Tuple[Table, Table]]:
        k = self.get_num_folds()
        n = table.num_rows
        if n < k:
            raise ValueError(f"{n} rows cannot make {k} folds")
        shuffled = table.shuffle(self.get_seed())
        bounds = np.linspace(0, n, k + 1).astype(int)
        out = []
        for i in range(k):
            lo, hi = bounds[i], bounds[i + 1]
            val = shuffled.slice(lo, hi)
            if lo == 0:
                train = shuffled.slice(hi, n)
            elif hi == n:
                train = shuffled.slice(0, lo)
            else:
                train = shuffled.slice(0, lo).concat(shuffled.slice(hi, n))
            out.append((train, val))
        return out


class TrainValidationSplit(_SelectorBase):
    """Single seeded train/validation split (the cheap cousin of
    CrossValidator for large tables: each candidate trains once)."""

    TRAIN_RATIO = FloatParam(
        "trainRatio", "Fraction of rows in the training split.",
        default=0.75, validator=ParamValidators.in_range(0.0, 1.0))

    def set_train_ratio(self, r: float):
        return self.set(TrainValidationSplit.TRAIN_RATIO, r)

    def _splits(self, table: Table) -> List[Tuple[Table, Table]]:
        n = table.num_rows
        cut = int(n * self.get(TrainValidationSplit.TRAIN_RATIO))
        if not 0 < cut < n:
            raise ValueError(
                f"trainRatio leaves an empty split for {n} rows")
        shuffled = table.shuffle(self.get_seed())
        return [(shuffled.slice(0, cut), shuffled.slice(cut, n))]


class CrossValidatorModel(Model):
    """Wraps the winning refitted model; transform delegates to it.
    Persistence delegates to the best model (reload with that model's
    class — the selector itself holds non-serializable python stages)."""

    def __init__(self):
        super().__init__()
        self.best_model = None
        self.best_index: int = -1
        self.best_params: Dict[Param, Any] = {}
        self.avg_metrics: List[float] = []
        #: per candidate, its metric on each fold (in fold order)
        self.fold_metrics: List[List[float]] = []

    def transform(self, *inputs) -> List[Table]:
        if self.best_model is None:
            raise ValueError("CrossValidatorModel has no best model; fit "
                             "a CrossValidator first")
        return self.best_model.transform(*inputs)

    def save(self, path: str) -> None:
        if self.best_model is None:
            raise ValueError("nothing to save")
        self.best_model.save(path)