"""Operator chaining: run runs of row-wise pipeline stages as one device
segment.

The stagewise ``PipelineModel.transform`` pays one host→device→host round
trip per stage: every feature transform copies its input column to the
card and its output back.  This module removes that boundary:

- **Kernel protocol.**  A stage advertises chainability by implementing
  ``transform_kernel(schema) -> StageKernel | None`` (stages without it,
  and configurations or schemas a pure device function cannot express —
  string-domain columns, ``handleInvalid="error"`` policies whose raise
  is host control flow — return ``None``).  A :class:`StageKernel` is a
  module-level ``columns -> columns`` function on torch tensors plus a
  dict of parameter tensors; all instance state lives in ``params``, all
  shape/name configuration in a hashable ``static`` tuple.

- **Segments.**  :func:`compile_pipeline` walks the stage list and
  greedily groups maximal runs of chainable row-independent stages into
  segments.  A segment run moves its stages' params to the device once,
  at plan build; pads the entry columns on the host to the shared row
  bucket; makes one host→device copy per entry column; runs the stage
  functions in order on device tensors; and makes one device→host copy
  per fetched column, after which a terminal's ``post`` runs on the
  host.  Intermediate columns never reach the host.  Non-chainable
  stages (``RandomSplitter``) break the chain and run stagewise between
  segments.

- **Bit-exactness.**  A stage's standalone ``transform`` runs its own
  kernel as a one-stage segment (:func:`apply_kernel_or_none`): the same
  function on the same padded shapes as inside a fused segment, so fused
  and stagewise outputs agree bit for bit.  Eager PyTorch rounds every
  operation's output, so no rounding barrier between stages is needed.
  Host-side exact-compare stages carry f32 edge *surrogates*
  (:func:`f32_ceil`/:func:`f32_floor`).

- **Dtype hygiene.**  Segment entry casts floating columns to
  :attr:`ChainConfig.dtype` (f32) and integer/bool columns to int32 on
  the HOST, halving the copy for f64 inputs.

Segments and single-stage runs go through the kernel registry's
dispatch surface (``kernels/registry.py::dispatch``), which counts them
(:func:`dispatch_count`, re-exported from there) and keeps the
compile / cache-hit accounting.

A port of the JAX package's ``api/chain.py``, with its shared
plan-static jit replaced by an eager run of the stage functions.
"""

from __future__ import annotations

import threading

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.table import Table
from ..kernels.registry import dispatch, dispatch_count
from ..obs.trace import tracer
from ..utils.device import resolve_device
from ..utils.padding import DEFAULT_MIN_BUCKET, pad_rows_to_bucket

__all__ = ["StageKernel", "ChainConfig", "CompiledSegment",
           "CompiledPipeline", "UnsafeColumnValues", "apply_kernel",
           "apply_kernel_or_none", "as_matrix", "numeric_entry",
           "compile_pipeline", "run_kernel", "run_normalized", "raw_schema",
           "chain_disabled", "dispatch_count", "f32_ceil", "f32_floor"]


def as_matrix(col):
    """Chain-side mirror of ``linalg.stack_vectors``'s 1-D promotion: a
    scalar column is n samples of dim 1, not one n-dim row."""
    return col.reshape(-1, 1) if col.ndim == 1 else col


def numeric_entry(schema, col: str, *, exact_compare: bool = False):
    """The ``(shape, dtype)`` schema entry when ``col`` is
    chain-admissible — present and plain numeric (object/string columns
    stay stagewise) — else ``None``.

    ``exact_compare=True`` additionally rejects float64 columns: segment
    entry rounds them to f32, and a kernel whose OUTPUT is an exact
    comparison decision (threshold crossing, bucket index, vocabulary
    equality) could round a value across the boundary the host-f64
    stagewise compare respects.  Such stages decline to chain on f64
    columns and run stagewise at full precision instead."""
    entry = schema.get(col)
    if entry is None or entry[1].kind not in "fiub":
        return None
    if exact_compare and entry[1].kind == "f" and entry[1].itemsize > 4:
        return None
    return entry


# --------------------------------------------------------------------------
# protocol
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class StageKernel:
    """One stage's pure device kernel.

    ``fn(static, params, cols) -> {produced name: tensor}`` is a
    module-level function; everything it reads beyond the column dict
    goes through ``static`` (hashable, shape/name-level) or ``params``
    (a dict of arrays or tensors, nested dicts and lists allowed, moved
    to ``device`` once at plan build).

    ``post`` (host, optional) marks a chain TERMINAL: it receives the
    host copies of this stage's produced columns and returns the final
    output columns.  Nothing may consume a terminal's device outputs
    in-segment — the segment ends at the terminal.

    ``pre`` (host, optional) validates raw input columns.  It runs on the
    segment's HOST entry columns, so a stage with a ``pre`` only chains
    while every column named in ``pre_cols`` is a segment-entry
    passthrough.

    ``device`` is where the stage runs (its ``device`` attribute); all
    kernels of one segment share it.
    """

    fn: Callable[[tuple, Any, Dict[str, Any]], Dict[str, Any]]
    static: tuple
    params: Any
    consumes: Tuple[str, ...]
    produces: Tuple[str, ...]
    post: Optional[Callable[[Dict[str, np.ndarray]],
                            Dict[str, np.ndarray]]] = None
    pre: Optional[Callable[[Dict[str, np.ndarray]], None]] = None
    pre_cols: Tuple[str, ...] = ()
    device: Any = "cuda"


@dataclass(frozen=True)
class ChainConfig:
    """Plan-build configuration (defaults match the standalone
    transforms, so fused and stagewise pad to identical shapes)."""

    dtype: Any = np.float32
    min_bucket: int = DEFAULT_MIN_BUCKET


# --------------------------------------------------------------------------
# enable/disable switch (tests and the A/B baseline)
# --------------------------------------------------------------------------

_STATE = threading.local()


def _enabled() -> bool:
    return getattr(_STATE, "enabled", True)


class chain_disabled:
    """Context manager forcing the stagewise path — the A/B baseline and
    the bit-exactness oracle in tests."""

    def __enter__(self):
        self._prev = _enabled()
        _STATE.enabled = False
        return self

    def __exit__(self, *exc):
        _STATE.enabled = self._prev
        return False


# --------------------------------------------------------------------------
# exact f32 comparison surrogates
# --------------------------------------------------------------------------

def f32_ceil(x: np.ndarray) -> np.ndarray:
    """Smallest float32 >= x (elementwise).  For any f32 value ``v`` and
    f64 threshold ``t``: ``t <= v  ⟺  f32_ceil(t) <= v`` — there is no
    f32 value strictly between ``t`` and ``f32_ceil(t)``."""
    x = np.asarray(x, np.float64)
    c = x.astype(np.float32)
    low = c.astype(np.float64) < x
    out = c.copy()
    out[low] = np.nextafter(c[low], np.float32(np.inf))
    return out


def f32_floor(x: np.ndarray) -> np.ndarray:
    """Largest float32 <= x (elementwise): ``v > t  ⟺  v > f32_floor(t)``
    for f32 ``v``."""
    x = np.asarray(x, np.float64)
    c = x.astype(np.float32)
    high = c.astype(np.float64) > x
    out = c.copy()
    out[high] = np.nextafter(c[high], np.float32(-np.inf))
    return out


# --------------------------------------------------------------------------
# host <-> device
# --------------------------------------------------------------------------

def _tensor(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    arr = np.ascontiguousarray(a)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev)


def params_to_device(params, dev: torch.device):
    """A kernel's params (arrays or tensors in nested dicts and lists)
    as tensors on ``dev``."""
    if isinstance(params, dict):
        return {k: params_to_device(v, dev) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_device(v, dev) for v in params]
    return _tensor(params, dev)


def _fetch(out: Dict[str, torch.Tensor], names, n: int
           ) -> Dict[str, np.ndarray]:
    """One device→host copy per fetched column, pad rows left behind."""
    return {name: out[name][:n].cpu().numpy() for name in names}


def run_kernel(kernel: StageKernel, table: Table, *,
               params: Any = None, min_bucket: int = DEFAULT_MIN_BUCKET,
               op: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Run ONE stage's kernel as a single-stage segment (normalize -> pre
    -> bucket-pad -> copy in -> run -> fetch -> post), padded as a fused
    segment pads (:class:`ChainConfig`'s defaults).  ``params`` replaces
    ``kernel.params`` with tensors already on the kernel's device (a
    servable copies its params once a generation instead of once a
    request); ``min_bucket`` is the bucket floor (a servable's).

    Raises :class:`UnsafeColumnValues` when a consumed integer column
    carries values outside the f32-exact range — callers fall back to
    their host path for that call (see :func:`apply_kernel_or_none`)."""
    host = {n: _normalize_col(table[n], ChainConfig.dtype)
            for n in kernel.consumes}
    return run_normalized(kernel, host, params=params,
                          min_bucket=min_bucket, op=op)


def run_normalized(kernel: StageKernel, host: Dict[str, np.ndarray], *,
                   params: Any = None, min_bucket: int = DEFAULT_MIN_BUCKET,
                   op: Optional[str] = None) -> Dict[str, np.ndarray]:
    """:func:`run_kernel` on host columns the caller has already cast to
    the segment's dtypes (f32 floats, int32 ids), without the +-2^24
    guard: for a kernel that only adds and gathers with its integers."""
    if kernel.pre is not None:
        kernel.pre(host)
    dev = resolve_device(kernel.device)
    with tracer.span("bucket_pad", cat="kernel", op=op):
        padded, n = pad_rows_to_bucket(tuple(host.values()),
                                       min_bucket=min_bucket)
        cols = {name: _tensor(a, dev) for name, a in zip(host, padded)}
    if params is None:
        params = params_to_device(kernel.params, dev)
    # the fetch is the completion fence: this span covers the queue, the
    # device compute and the copy of the produced columns
    with tracer.span("device_execute", cat="kernel", op=op,
                     bucket=int(next(iter(cols.values())).shape[0])
                     if cols else 0):
        out = dispatch(((kernel.fn, kernel.static),), (params,), cols,
                       op=op)
        fetched = _fetch(out, kernel.produces, n)
    if kernel.post is not None:
        fetched.update(kernel.post(fetched))
    return fetched


def apply_kernel(kernel: StageKernel, table: Table) -> Dict[str, np.ndarray]:
    """Run ONE stage's kernel stagewise (a single-stage segment).  The
    stages' standalone ``transform``s route through this, so the
    stagewise and fused paths run one function on one padded shape."""
    return run_kernel(kernel, table)


#: integers beyond +-2^24 are not exactly representable in the f32 the
#: kernels compare/promote with (and 2^31 would overflow the int32 cast);
#: a batch carrying them falls back stagewise
_INT_EXACT_BOUND = 1 << 24


class UnsafeColumnValues(Exception):
    """Batch values the f32 segment cannot represent exactly — the caller
    falls back to the stagewise path for THIS call (plan stays valid)."""


def _normalize_col(arr: np.ndarray, dtype) -> np.ndarray:
    """Host-side dtype hygiene: floating -> config dtype, int/bool ->
    int32.  Casting BEFORE the copy halves the bytes for f64 inputs."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "f" and arr.dtype != np.dtype(dtype):
        return arr.astype(dtype)
    if arr.dtype.kind in "iu":
        if arr.size and (int(arr.min()) < -_INT_EXACT_BOUND
                         or int(arr.max()) > _INT_EXACT_BOUND):
            raise UnsafeColumnValues(
                f"integer column values exceed +-2^24 "
                f"({int(arr.min())}..{int(arr.max())})")
        if arr.dtype != np.dtype(np.int32):
            return arr.astype(np.int32)
    elif arr.dtype.kind == "b":
        return arr.astype(np.int32)
    return arr


def apply_kernel_or_none(kernel: Optional[StageKernel], table: Table
                         ) -> Optional[Dict[str, np.ndarray]]:
    """:func:`apply_kernel` that answers ``None`` instead of raising when
    the kernel is absent or this batch's values are f32-unsafe — the
    standalone stage transforms branch to their host math on ``None``."""
    if kernel is None:
        return None
    try:
        return apply_kernel(kernel, table)
    except UnsafeColumnValues:
        return None


def raw_schema(table: Table) -> tuple:
    """Hashable (name, trailing shape, RAW dtype) signature.  Plan caches
    key on this: kernel admissibility depends on the input float width
    (exact-compare stages decline f64, see :func:`numeric_entry`)."""
    return tuple((n, s, dt.str) for n, (s, dt)
                 in sorted(table.schema().items()))


# --------------------------------------------------------------------------
# compiled plan
# --------------------------------------------------------------------------

class CompiledSegment:
    """A maximal run of chainable stages run as one device segment.

    ``run`` normalizes + pads the entry columns on host, copies each to
    the device once, runs the stage functions, fetches only the columns
    the output (or a terminal's host ``post``) needs, and reassembles the
    Table in the stagewise column order.  Entry columns that no kernel
    replaces are reattached from the ORIGINAL host arrays."""

    def __init__(self, stages: Sequence, kernels: Sequence[StageKernel],
                 out_names: Sequence[str], config: ChainConfig):
        self.stages = list(stages)
        self.kernels = list(kernels)
        self.config = config
        devices = {resolve_device(k.device) for k in kernels}
        if len(devices) != 1:
            raise ValueError(
                f"the stages of one segment run on different devices "
                f"{sorted(map(str, devices))}")
        (self.device,) = devices
        self.plan = tuple((k.fn, k.static) for k in kernels)
        # to the device once: params ride every run as device tensors
        self.params = tuple(params_to_device(k.params, self.device)
                            for k in kernels)
        produced: set = set()
        for k in kernels:
            produced.update(k.produces)
        self.produced = produced
        # columns that must cross host->device: everything any kernel
        # consumes that an earlier kernel did not itself produce
        entry: List[str] = []
        seen: set = set()
        for k in kernels:
            for name in k.consumes:
                if name not in seen and name not in entry:
                    entry.append(name)
            seen.update(k.produces)
        self.entry_cols = tuple(entry)
        for k in kernels:
            missing = [c for c in k.pre_cols if c not in self.entry_cols]
            if missing:
                raise ValueError(
                    f"StageKernel pre_cols {missing} are not entry columns "
                    f"of their segment — a host pre hook can only validate "
                    f"columns some kernel in the segment consumes from the "
                    f"segment input")
        self.out_names = tuple(out_names)
        terminal = kernels[-1] if kernels and kernels[-1].post else None
        # device->host fetch set: final columns a kernel produced, plus
        # the terminal's staging outputs its host post reads
        fetch = [n for n in self.out_names if n in produced]
        if terminal is not None:
            fetch += [n for n in terminal.produces if n not in fetch]
        self.fetch_cols = tuple(fetch)
        self.posts = [k.post for k in kernels if k.post]
        self.pres = [k.pre for k in kernels if k.pre]

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def transfer_bytes(self, num_rows: int) -> Tuple[int, int]:
        """(host->device, device->host) bytes this segment moves for a
        ``num_rows`` batch — exact shape math for the byte accounting."""
        itemsize = np.dtype(self.config.dtype).itemsize

        def _nbytes(names, schema):
            total = 0
            for n in names:
                shape, dt = schema.get(n, ((), np.dtype(self.config.dtype)))
                width = int(np.prod(shape)) if shape else 1
                size = itemsize if dt.kind == "f" else 4
                total += num_rows * width * size
            return total

        return (_nbytes(self.entry_cols, self._entry_schema),
                _nbytes(self.fetch_cols, self._out_schema))

    def bind_schemas(self, entry_schema: dict, out_schema: dict) -> None:
        self._entry_schema = dict(entry_schema)
        self._out_schema = dict(out_schema)

    def run(self, table: Table) -> Table:
        cfg = self.config
        try:
            host = {n: _normalize_col(table[n], cfg.dtype)
                    for n in self.entry_cols}
        except UnsafeColumnValues:
            # this batch carries integers f32 cannot represent exactly —
            # run the segment's own stages stagewise (per call; the plan
            # stays valid for safe batches)
            for stage in self.stages:
                (table,) = stage.transform(table)
            return table
        for pre in self.pres:
            pre(host)
        n = table.num_rows
        if host:
            padded, n = pad_rows_to_bucket(
                tuple(host.values()), min_bucket=cfg.min_bucket)
            cols = {name: _tensor(a, self.device)
                    for name, a in zip(host, padded)}
        else:
            cols = {}
        out = dispatch(self.plan, self.params, cols)
        fetched = _fetch(out, self.fetch_cols, n)
        for post in self.posts:
            fetched.update(post(fetched))
        final: Dict[str, np.ndarray] = {}
        for name in self.out_names:
            final[name] = (fetched[name] if name in fetched
                           else table[name])
        return Table(final)


class _HostStage:
    """A non-chainable stage in the plan: runs its own transform
    (possibly multiplying tables, e.g. RandomSplitter)."""

    def __init__(self, stage):
        self.stage = stage

    def run_all(self, tables: List[Table]) -> List[Table]:
        out: List[Table] = []
        for t in tables:
            out.extend(self.stage.transform(t))
        return out


class CompiledPipeline:
    """The fused execution plan: segments interleaved with stagewise
    stages, applied table-wise (a multi-output host stage fans the flow
    out; later items map over every table)."""

    def __init__(self, items: List, config: ChainConfig,
                 schema_key: tuple):
        self.items = items
        self.config = config
        self.schema_key = schema_key

    @property
    def segments(self) -> List[CompiledSegment]:
        return [i for i in self.items if isinstance(i, CompiledSegment)]

    @property
    def num_fused_stages(self) -> int:
        return sum(s.num_stages for s in self.segments)

    @property
    def worthwhile(self) -> bool:
        """Fusing pays once any segment merges >= 2 stages; a plan of
        singletons is the stagewise path with extra bookkeeping."""
        return any(s.num_stages >= 2 for s in self.segments)

    def describe(self) -> List[Tuple[str, int]]:
        """[('segment', n_stages) | ('stage', 1)] in pipeline order."""
        return [("segment", i.num_stages) if isinstance(i, CompiledSegment)
                else ("stage", 1) for i in self.items]

    def transform(self, *inputs) -> List[Table]:
        tables = list(inputs)
        for item in self.items:
            if isinstance(item, CompiledSegment):
                tables = [item.run(t) for t in tables]
            else:
                tables = item.run_all(tables)
        return tables


def _device_schema(table: Table, dtype) -> tuple:
    """The normalized (name, trailing shape, device dtype) signature."""
    sig = []
    for name, (shape, dt) in table.schema().items():
        if dt.kind == "f":
            dt = np.dtype(dtype)
        elif dt.kind in "iub":
            dt = np.dtype(np.int32)
        sig.append((name, shape, dt.str))
    return tuple(sig)


def compile_pipeline(pipeline_model, example: Table, *,
                     min_bucket: int = DEFAULT_MIN_BUCKET) -> CompiledPipeline:
    """Compile a fitted ``PipelineModel`` into a fused plan.

    Walks the stage list with ``example`` (any table carrying the request
    schema — row VALUES only steer non-chainable stages), asking each
    stage for its kernel at the current schema and greedily grouping
    maximal chainable runs into :class:`CompiledSegment`\\s.  A terminal
    kernel (one with a host ``post``) closes its segment; a stage without
    a kernel breaks the chain and runs stagewise.  Segments pad rows to
    buckets from ``min_bucket`` up (a servable passes its own floor).
    """
    config = ChainConfig(min_bucket=min_bucket)
    items: List = []
    current = example
    run_stages: List = []
    run_kernels: List[StageKernel] = []
    run_entry: Table = example
    produced_in_run: set = set()

    def flush(out_table: Table) -> None:
        nonlocal run_stages, run_kernels, produced_in_run
        if not run_stages:
            return
        seg = CompiledSegment(run_stages, run_kernels,
                              out_table.column_names, config)
        seg.bind_schemas(run_entry.schema(), out_table.schema())
        items.append(seg)
        run_stages, run_kernels, produced_in_run = [], [], set()

    for stage in pipeline_model.stages:
        kernel = None
        if hasattr(stage, "transform_kernel"):
            try:
                kernel = stage.transform_kernel(current.schema())
            except NotImplementedError:
                kernel = None
        if kernel is not None and kernel.pre is not None and \
                any(c in produced_in_run for c in kernel.pre_cols):
            # host pre-validation needs raw entry columns; a mid-segment
            # input only exists on device — close the running segment so
            # its outputs reach the host and this stage opens a fresh one
            flush(current)
        next_table = stage.transform(current)[0]
        if kernel is not None:
            if not run_stages:
                run_entry = current
            run_stages.append(stage)
            run_kernels.append(kernel)
            produced_in_run.update(kernel.produces)
            current = next_table
            if kernel.post is not None:       # terminal closes the segment
                flush(current)
        else:
            flush(current)
            items.append(_HostStage(stage))
            current = next_table
    flush(current)
    return CompiledPipeline(items, config,
                            _device_schema(example, config.dtype))
