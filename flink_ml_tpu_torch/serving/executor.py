"""Servable executors: ``ServableModel`` wraps a fitted Model for serving.

A port of the JAX package's ``serving/executor.py``.  The adapter's
contract:

- **Bucketed shapes.**  Every predict pads its rows to a power-of-two
  bucket (``utils/padding.py``), so the request/batch sizes in
  ``[1, max_batch_rows]`` map onto ``log2`` many shapes.
- **Eager warm-up.**  ``warm_up()`` runs one predict per bucket BEFORE the
  endpoint reports ready (kernel libraries are loaded and cuBLAS has seen
  every shape before the first request).
- **Bit-exact with offline ``transform()``.**  The served computation is
  either literally ``model.transform`` (the generic adapter) or the
  model's own chain-terminal kernel (``transform_kernel``), the function
  its ``transform`` runs; pad rows are inert in every row-independent
  predict, and every terminal scores a row with the same bits in any
  bucket (Wide&Deep in fixed row tiles, ``SCORE_TILE``), so serving a
  request returns exactly the rows offline ``transform`` would.
- **Params once a generation.**  The kernel servables copy their model's
  kernel params to its device once, when they bind (a synchronous copy
  on the current stream, so a generation's params are on the card before
  its first request); each request then pays one copy in, the kernel
  function and one copy out.

A kernel's build or launch error propagates to the request: nothing here
catches one and scores through another path.
"""

from __future__ import annotations

import copy
import dataclasses
import time

from typing import Any, Optional, Sequence

import numpy as np

from ..data.table import Table
from ..robustness.faults import fault_point
from ..utils.device import resolve_device
from ..utils.padding import (
    DEFAULT_BUCKET_CAP,
    DEFAULT_MIN_BUCKET,
    bucket_rows,
    bucket_sizes,
)

__all__ = ["ServableModel", "make_servable"]


class ServableModel:
    """A fitted Model adapted for online serving: schema-checked,
    bucket-padded, warmed predict.

    ``example`` is a small Table carrying the REQUEST schema (the columns
    clients send — typically one row of the training table minus the
    label); warm-up tiles it to every bucket size.  The generic adapter
    serves ANY stage whose ``transform`` is row-independent; the kernel
    subclasses below score through the model's chain-terminal kernel.
    """

    #: precisions this executor family can serve at.  "int8" means the
    #: bind path quantizes the model's kernel params (per-channel max-abs,
    #: ``kernels/quantize.py``) and scores through the op's int8 function
    #: (``ops/int8_serving.py``); the generic ``model.transform`` adapter
    #: and the fused pipeline plan have no quantized param seam, so they
    #: refuse at construction rather than silently serving f32.
    supported_precisions = ("f32",)

    def __init__(self, model, example: Table, *,
                 max_batch_rows: int = 256,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 output_cols: Optional[Sequence[str]] = None,
                 precision: str = "f32"):
        if precision not in self.supported_precisions:
            raise TypeError(
                f"{type(self).__name__} cannot serve at precision "
                f"{precision!r} (supports {self.supported_precisions}); "
                "int8 covers the kernel-served families only")
        self.precision = precision
        if not hasattr(model, "transform"):
            raise TypeError(
                f"{type(model).__name__} has no transform(); only fitted "
                "Models/Transformers are servable")
        if example.num_rows == 0:
            raise ValueError("example must carry at least one row")
        if max_batch_rows > DEFAULT_BUCKET_CAP:
            raise ValueError(
                f"max_batch_rows={max_batch_rows} exceeds the bucket cap "
                f"({DEFAULT_BUCKET_CAP}) above which predict paths keep "
                "exact shapes — the bucket warm-up cannot cover it")
        self.model = model
        self.example = example
        self.min_bucket = min_bucket
        self.max_batch_rows = max_batch_rows
        self.buckets = bucket_sizes(max_batch_rows, min_bucket)
        self.output_cols = tuple(output_cols) if output_cols else None
        self._schema = set(example.column_names)
        self._ready = False
        #: readiness accounting: wall time to ready and, per bucket, the
        #: warm-up predict's ms (populated by :meth:`warm_up`)
        self.warmup_report: Optional[dict] = None

    #: True for executor families that bind their params apart from the
    #: model (the kernel servables): a same-shape new generation can
    #: :meth:`rebind` without a warm-up.  The generic adapter serves
    #: through ``model.transform`` and stays False.
    rebind_safe = False

    def rebind(self, model) -> "ServableModel":
        """A ready clone of this servable scoring with ``model`` (same
        example, buckets and output schema), without a warm-up: the
        clone's bind copies the new params to the device.  Callers own
        the same-shape contract; a shape change goes through the full
        deploy path instead."""
        if not self.rebind_safe:
            raise TypeError(
                f"{type(self).__name__} is not rebind-safe: it serves "
                "through the model's own transform — deploy the new "
                "version through the registry (load->warm->swap)")
        clone = copy.copy(self)
        clone.model = model
        return clone

    # -- predict ------------------------------------------------------------
    def check_schema(self, table: Table) -> None:
        names = set(table.column_names)
        if names != self._schema:
            raise ValueError(
                f"request schema {sorted(names)} does not match the "
                f"endpoint's example schema {sorted(self._schema)}")

    def bucket_for(self, rows: int) -> int:
        return bucket_rows(rows, min_bucket=self.min_bucket)

    def predict(self, table: Table) -> Table:
        """Serve one (micro-)batch: returns the transform output for
        exactly ``table``'s rows, computed at the padded bucket shape."""
        fault_point("serving.predict")
        out = self._run(table)
        if self.output_cols:
            out = out.select(*self.output_cols)
        return out

    def _run(self, table: Table) -> Table:
        # generic adapter: the model's own transform, which pads to the
        # bucket internally and is bit-exact with offline transform by
        # construction
        return self.model.transform(table)[0]

    # -- warm-up ------------------------------------------------------------
    def _tiled_example(self, rows: int) -> Table:
        reps = -(-rows // self.example.num_rows)
        return Table({
            name: np.concatenate([col] * reps, axis=0)[:rows]
            for name, col in self.example.to_dict().items()})

    def warm_up(self) -> "ServableModel":
        """Run one predict per bucket of the ladder, so the endpoint only
        reports ready once every serving shape has run (libraries loaded,
        cuBLAS handles and plans made).  Runs on the deploying thread —
        OFF the serving path, so a hot swap warms the incoming version
        while the old one keeps serving.

        Populates :attr:`warmup_report` with the JAX package's keys: total
        wall to ready plus, per bucket, whether it was the first run of
        its ``(plan, shapes)`` key in the process (**compile**), loaded a
        kernel library from the cache root (**aot**, ``kernels/aot.py``)
        or reran a key already run (**cache**), diffed from the
        registry's THIS-THREAD counters (``kernel_stats.thread_counts``),
        so a hot swap warming on the deploy thread is never credited
        with the old generation's concurrent dispatches.  Servables whose
        predict does not go through the registry's dispatch (the generic
        ``model.transform`` adapter) report ``untracked``."""
        from ..kernels.registry import kernel_stats

        fault_point("serving.warm_up")
        report: dict = {"wall_s": None, "precision": self.precision,
                        "buckets": {}}
        t_start = time.perf_counter()
        for bucket in self.buckets:
            compiles0, aot0, hits0 = kernel_stats.thread_counts()
            t0 = time.perf_counter()
            self._run(self._tiled_example(bucket))
            ms = (time.perf_counter() - t0) * 1e3
            compiles1, aot1, hits1 = kernel_stats.thread_counts()
            if compiles1 > compiles0:
                source = "compile"
            elif aot1 > aot0:
                source = "aot"
            elif hits1 > hits0:
                source = "cache"
            else:
                source = "untracked"
            report["buckets"][bucket] = {"source": source,
                                         "ms": round(ms, 3),
                                         "precision": self.precision}
        report["wall_s"] = round(time.perf_counter() - t_start, 4)
        sources = [b["source"] for b in report["buckets"].values()]
        report["compiled"] = sources.count("compile")
        report["aot_loaded"] = sources.count("aot")
        report["cache_hits"] = sources.count("cache")
        self.warmup_report = report
        self._ready = True
        return self

    @property
    def ready(self) -> bool:
        return self._ready


# -- kernel executors ---------------------------------------------------------

def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0 if tree is None else tree.numel() * tree.element_size()


class _KernelServable(ServableModel):
    """Families whose model exposes a chain ``transform_kernel``: serving
    runs that kernel as a one-stage segment (``api/chain.py::run_kernel``),
    the function the model's own ``transform`` runs.

    The kernel is built once per generation from the EXAMPLE schema and
    its params are copied to the model's device once, so steady-state
    requests pay no host->device param traffic.  ``rebind`` rebuilds only
    the kernel and its device params."""

    rebind_safe = True
    op_label: Optional[str] = None
    supported_precisions = ("f32", "int8")

    def __init__(self, model, example: Table, **kwargs: Any):
        super().__init__(model, example, **kwargs)
        self._build_kernel()

    def _build_kernel(self) -> None:
        from ..api.chain import params_to_device

        # transform_kernel's "no kernel for this config" signal is
        # returning None; a RAISE here is a genuine defect (e.g. an
        # unfitted model) and surfaces at construction
        kernel = self.model.transform_kernel(self.example.schema())
        if kernel is None and self.precision == "int8":
            # no chain kernel (e.g. sparse linear layouts) means no
            # quantized path either; serving f32 under an int8 contract
            # would misreport the footprint
            raise TypeError(
                f"{type(self.model).__name__} has no chain kernel for "
                "this example schema — precision='int8' requires the "
                "kernel-served plan; serve this config at f32")
        if kernel is not None and self.precision == "int8":
            # the calibration point: quantize this generation's params
            # and swap in the op's int8 function; rebind() re-runs this
            # bind on the clone, so scales always come from the params
            # they serve
            from ..kernels.quantize import quantize_stage_params
            from ..kernels.registry import lookup

            entry = lookup(self.op_label, backend="int8")
            kernel = dataclasses.replace(
                kernel, fn=entry.fn,
                params=quantize_stage_params(self.op_label, kernel.params))
        self._kernel = kernel
        # one synchronous copy on the current stream: the params are on
        # the device before this generation's first request
        self._kernel_params = (
            params_to_device(kernel.params, resolve_device(kernel.device))
            if kernel is not None else None)

    def rebind(self, model) -> "ServableModel":
        clone = super().rebind(model)
        clone._build_kernel()
        return clone

    @property
    def param_bytes(self) -> int:
        """Bytes of the device-resident params this servable scores
        with (0 on the ``model.transform`` route)."""
        return _tree_bytes(self._kernel_params)

    def _run(self, table: Table) -> Table:
        from ..api.chain import UnsafeColumnValues, run_kernel

        kernel = self._kernel
        if kernel is None:
            return self.model.transform(table)[0]
        # kernel admissibility was decided on the EXAMPLE schema; a
        # request re-spelling a consumed column as object dtype (e.g. a
        # column of vectors under the same name) routes to the model's
        # own transform
        if any(np.asarray(table[n]).dtype.kind not in "fiub"
               for n in kernel.consumes):
            return self.model.transform(table)[0]
        try:
            cols = run_kernel(kernel, table, params=self._kernel_params,
                              min_bucket=self.min_bucket, op=self.op_label)
        except (UnsafeColumnValues, KeyError):
            # an f32-unsafe int batch, or a request schema the kernel's
            # columns don't cover: the model's own transform owns those
            return self.model.transform(table)[0]
        out = table
        for name in (n for n in cols if n not in kernel.produces):
            out = out.with_column(name, cols[name])
        return out


class _LinearServable(_KernelServable):
    """Linear family (LogisticRegression / LinearRegression / LinearSVC):
    dense features score through the margin terminal; sparse and mixed
    layouts serve through the model's own transform (their
    ``transform_kernel`` is None)."""

    op_label = "linear_margins"


class _KMeansServable(_KernelServable):
    """KMeansModel: the nearest-centroid terminal, on the card the
    ``kmeans_assign_reduce`` kernel (B5), one launch a batch."""

    op_label = "kmeans_assign"


class _WideDeepServable(_KernelServable):
    """WideDeepModel: the ``sigmoid(forward)`` terminal (the id range
    check runs as the kernel's host ``pre``)."""

    op_label = "widedeep_scores"


class _RetrieveServable(_KernelServable):
    """IVFIndex, a NON-model servable: the IVF / IVF-PQ search terminal
    (on the card the retrieve kernels, B8 / B9, one call a batch) serves
    through the seams the model families use.  No int8 function: PQ codes
    ARE the compressed representation."""

    op_label = "retrieve"
    supported_precisions = ("f32",)


class _PipelineServable(ServableModel):
    """PipelineModel: the whole chain (preprocess + score) compiles into
    fused segments (``api/chain.py``) at deploy time — a fully chainable
    pipeline serves every micro-batch in ONE segment run.  ``warm_up``
    (inherited) tiles the example through every bucket."""

    def __init__(self, model, example: Table, **kwargs: Any):
        super().__init__(model, example, **kwargs)
        from ..api.chain import compile_pipeline, raw_schema

        self._plan_schema = raw_schema(example)
        try:
            # the plan pads with THIS servable's bucket floor, the ladder
            # warm_up ran
            plan = compile_pipeline(model, example,
                                    min_bucket=self.min_bucket)
            self._plan = plan if plan.worthwhile else None
        except Exception:           # unported stage mix: stagewise serve
            self._plan = None

    def _run(self, table: Table) -> Table:
        # the plan's kernel admissibility was decided on the EXAMPLE's raw
        # dtypes (exact-compare stages decline f64); a request with a
        # different raw schema routes through model.transform
        if self._plan is not None:
            from ..api.chain import raw_schema

            if raw_schema(table) == self._plan_schema:
                return self._plan.transform(table)[0]
        return self.model.transform(table)[0]


def make_servable(model, example: Table, *, emb_cache: bool = False,
                  **kwargs: Any) -> ServableModel:
    """Adapt a fitted Model for serving, picking the kernel executor for
    the covered families (linear / KMeans / Wide&Deep / IVF index; whole
    PipelineModels fuse their chainable stage runs into segments; every
    other row-independent transform serves through the generic adapter).

    ``emb_cache=True`` (Wide&Deep only) serves through the device-resident
    embedding-row cache (``serving/embcache.py``): only the hot table
    blocks live on the card; ``cache_block_rows`` / ``cache_capacity_blocks``
    size it.

    ``precision="int8"`` (the linear, KMeans and Wide&Deep kernels and the
    cached Wide&Deep path) quantizes the params at bind time and scores
    through the op's int8 function — about 4x smaller resident params (2x
    for the row cache's codes + scales pools) at the accuracy envelope
    the tests gate.  Families without a quantized seam raise TypeError."""
    from ..api.pipeline import PipelineModel
    from ..models.clustering.kmeans import KMeansModel
    from ..models.common.linear import LinearModelBase
    from ..models.recommendation.widedeep import WideDeepModel
    from ..retrieval.ivf import IVFIndex

    if isinstance(model, PipelineModel):
        cls: type = _PipelineServable
    elif isinstance(model, LinearModelBase):
        cls = _LinearServable
    elif isinstance(model, KMeansModel):
        cls = _KMeansServable
    elif isinstance(model, IVFIndex):
        cls = _RetrieveServable
    elif isinstance(model, WideDeepModel):
        if emb_cache:
            from .embcache import CachedWideDeepServable

            return CachedWideDeepServable(model, example, **kwargs)
        cls = _WideDeepServable
    else:
        cls = ServableModel
    if emb_cache:
        raise TypeError(
            f"emb_cache=True only applies to WideDeepModel (its stacked "
            f"vocab tables are the cacheable operand), not "
            f"{type(model).__name__}")
    return cls(model, example, **kwargs)
