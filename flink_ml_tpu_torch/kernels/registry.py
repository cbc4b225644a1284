"""Unified kernel registry: one table of implementations for pipelines,
serving and training.

Two faces, as in the JAX package's ``kernels/registry.py``:

- **Implementation lookup** (:func:`lookup`): ``(op, signature, backend)
  -> KernelEntry``.  Every hand-written CUDA kernel registers its launcher
  as backend ``"cuda"`` (B3's gather + pair launch as ``"cuda-pair"``)
  beside its eager twin ``"plain"``; an op with no hand kernel keeps one
  entry per PyTorch implementation (``linear_margins`` and
  ``widedeep_scores`` one ``"torch"`` entry each, GBT's histograms
  ``"segsum"`` and ``"mxu"``).  The ops wrappers, the training step
  builders and the chain stages resolve through here, never through a
  branch of their own on the tensors' device.

- **Dispatch surface** (:func:`dispatch`): the segment runner of
  ``api/chain.py``.  A plan is a tuple of ``(fn, static)`` stage pairs
  run in order over a column dict, with compile / cache-hit / latency
  accounting on :data:`kernel_stats`.

**The device is part of the signature.**  The last element of every
signature the port passes is the operand's device type (``"cuda"`` or
``"cpu"``), and a ``"cuda"`` entry's ``supports`` requires ``"cuda"``
there.  Availability alone (:func:`cuda_only`) would not do: on a machine
with a card, a call on CPU tensors (the CPU tests, the plain oracles of
``chip_smoke.py``) would resolve to the kernel and hand host pointers to
a launch.  A forced ``lookup(op, sig=(..., "cpu"), backend="cuda")``
raises ``ValueError``, as a shape outside a kernel's contract does.

**No hidden fallback.**  ``available`` says whether the backend can run
on this machine at all (a card is present), never whether its library
built: an ``nvcc`` failure raises from ``kernels/build.py`` at the first
launch instead of turning into a quiet drop to the plain twin.
"""

from __future__ import annotations

import threading
import time

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from ..obs.trace import tracer

__all__ = [
    "KernelEntry",
    "KernelStats",
    "backends",
    "cuda_only",
    "dispatch",
    "dispatch_count",
    "kernel_stats",
    "lookup",
    "ops",
    "register_kernel",
]


def cuda_only() -> bool:
    """The default availability gate of ``"cuda"`` entries: a card is
    present (``torch.cuda.is_available()``).  It takes the place of the
    JAX package's ``tpu_only``, which asks for the TPU backend; the
    port's kernels need a CUDA device instead.  It says nothing of the
    operand's device, which the signature carries (module docstring)."""
    import torch

    return torch.cuda.is_available()


def on_cuda(sig: tuple) -> bool:
    """``supports`` helper: the signature's last element (the operand's
    device type) is ``"cuda"``."""
    return bool(sig) and sig[-1] == "cuda"


@dataclass(frozen=True)
class KernelEntry:
    """One registered implementation of an op on one backend.

    ``fn``'s calling convention is per-``convention``:

    - ``"impl"``: a function on device tensors that the ops wrappers and
      the training step builders call directly.  Every backend of an op
      takes one signature, documented at its registration.
    - ``"stage"``: the chain ``StageKernel`` convention
      ``fn(static, params, cols) -> {name: tensor}``, run through
      :func:`dispatch`.

    ``supports(sig)`` is the shape and device contract; ``available()``
    the machine gate (``"cuda"`` entries: :func:`cuda_only`).  A *forced*
    backend lookup bypasses ``available`` (the tests' oracles) but never
    ``supports``: a signature the implementation cannot take fails
    loudly."""

    op: str
    backend: str
    fn: Callable
    priority: int = 0
    supports: Optional[Callable[[tuple], bool]] = None
    available: Optional[Callable[[], bool]] = None
    convention: str = "impl"   # "impl" | "stage"

    def supports_sig(self, sig: tuple) -> bool:
        return self.supports is None or bool(self.supports(sig))

    def is_available(self) -> bool:
        return self.available is None or bool(self.available())


_REGISTRY: Dict[str, Dict[str, KernelEntry]] = {}
_REG_LOCK = threading.Lock()
# The catalog import has its OWN reentrant lock: the catalog's modules call
# register_kernel, which takes _REG_LOCK, and a registering module that
# looks something up at import time must not deadlock on itself.
_CATALOG_LOCK = threading.RLock()
_CATALOG_LOADED = [False]


def _ensure_catalog() -> None:
    """Import the registering modules once, at the first lookup (not at
    package import: no cycle between ``kernels`` and the modules that
    register into it).  Concurrent first lookups wait on the catalog
    lock, and the loaded flag latches only after a successful import, so
    a failed import surfaces on every lookup until one succeeds."""
    if _CATALOG_LOADED[0]:
        return
    with _CATALOG_LOCK:
        if _CATALOG_LOADED[0]:
            return
        from . import catalog  # noqa: F401  (imports register as a side effect)
        _CATALOG_LOADED[0] = True


def register_kernel(op: str, backend: str, fn: Callable, *,
                    priority: int = 0,
                    supports: Optional[Callable[[tuple], bool]] = None,
                    available: Optional[Callable[[], bool]] = None,
                    convention: str = "impl") -> KernelEntry:
    """Register (or replace: a module reload must not duplicate) the
    implementation of ``op`` on ``backend``."""
    if convention not in ("impl", "stage"):
        raise ValueError(f"unknown convention {convention!r}")
    entry = KernelEntry(op=op, backend=backend, fn=fn, priority=priority,
                        supports=supports, available=available,
                        convention=convention)
    with _REG_LOCK:
        _REGISTRY.setdefault(op, {})[backend] = entry
    return entry


def ops() -> Tuple[str, ...]:
    _ensure_catalog()
    return tuple(sorted(_REGISTRY))


def backends(op: str) -> Tuple[str, ...]:
    _ensure_catalog()
    if op not in _REGISTRY:
        raise KeyError(f"unknown kernel op {op!r}; registered: {ops()}")
    return tuple(sorted(_REGISTRY[op]))


def lookup(op: str, sig: tuple = (), *,
           backend: Optional[str] = None) -> KernelEntry:
    """Resolve ``(op, signature)`` to the best registered entry.

    Candidates are the entries that are available and support ``sig``,
    ordered by priority (highest first) with the backend name as the
    tiebreak; a persisted autotune decision for ``(op, sig)`` on this
    device (``kernels/autotune.py``) wins when several qualify.
    ``backend`` forces one entry: availability is bypassed, but a given
    ``sig`` still gates through ``supports`` (``ValueError`` outside the
    contract); with no ``sig`` the caller owns the choice.  An unknown op
    or backend raises ``KeyError``, no candidate ``ValueError``."""
    _ensure_catalog()
    table = _REGISTRY.get(op)
    if table is None:
        raise KeyError(f"unknown kernel op {op!r}; registered: {ops()}")
    if backend is not None:
        entry = table.get(backend)
        if entry is None:
            raise KeyError(
                f"op {op!r} has no backend {backend!r}; registered: "
                f"{tuple(sorted(table))}")
        if sig != () and not entry.supports_sig(sig):
            raise ValueError(
                f"op {op!r} backend {backend!r} does not support "
                f"signature {sig!r}")
        return entry
    cands = [e for e in table.values()
             if e.is_available() and e.supports_sig(sig)]
    if not cands:
        raise ValueError(
            f"no available backend of op {op!r} supports signature "
            f"{sig!r} (registered: {tuple(sorted(table))})")
    if len(cands) > 1:
        # a measured decision (None without a cache root or a record)
        from . import autotune

        tuned = autotune.decided_backend(op, sig)
        if tuned is not None:
            for e in cands:
                if e.backend == tuned:
                    return e
    cands.sort(key=lambda e: (-e.priority, e.backend))
    return cands[0]


def kernel_or_plain(op: str, sig: tuple, kernel: Callable,
                    plain: Callable) -> Callable:
    """A kernel wrapper's implementation: ``plain`` (the kernel's eager
    twin) where ``lookup(op, sig)`` resolves to ``"plain"``, else
    ``kernel`` (the launcher the wrapper names).  The wrapper checks its
    operands; the registry alone decides between the two."""
    return plain if lookup(op, sig).backend == "plain" else kernel


# --------------------------------------------------------------------------
# observability
# --------------------------------------------------------------------------

def _launch_counts() -> Dict[str, int]:
    """Every CUDA kernel's launches since its module's last
    ``reset_launch_counts`` (the ops modules' ``LAUNCHES``)."""
    from ..ops import ell_scatter, emb_grad, kmeans, retrieve

    launches: Dict[str, int] = {}
    for module in (ell_scatter, kmeans, emb_grad, retrieve):
        launches.update(module.LAUNCHES)
    return launches


class KernelStats:
    """Dispatcher-level accounting: how many distinct ``(plan, shapes)``
    keys ran for the first time (``compiles``), how often a later dispatch
    ran a key again (``cache_hits``), and what a dispatch costs on the
    host clock; where the kernel libraries came from (``aot``: loaded from
    the cache root, built live, stored, quarantined); which ops were
    autotuned; and (the port's addition) every kernel's launches.

    Eager PyTorch compiles no program per key: ``compiles`` keeps the JAX
    package's keying so a consumer's warm-up and a later consumer's reuse
    read the same way in both packages.  Latency is time to return, which
    for a CUDA stage is the host's enqueue time."""

    def __init__(self):
        self._lock = threading.Lock()
        self.compiles = 0
        self.cache_hits = 0
        self.dispatches = 0
        self._lat_ema_ms = 0.0
        self._last_ms = 0.0
        self.per_op: Dict[str, Dict[str, int]] = {}
        #: where the libraries came from: cache-root loads vs live nvcc
        #: builds, plus the failure ledger (quarantines never crash, so
        #: they must count)
        self.aot_hits = 0
        self.aot_misses = 0
        self.aot_stores = 0
        self.aot_store_failed = 0
        self.aot_quarantined = 0
        self.aot_unserializable = 0
        self._aot_load_ms = 0.0
        self._compile_ms = 0.0
        #: autotune decisions seen in this process: "op|sig" -> choice,
        #: source and search cost
        self.tuned_ops: Dict[str, Dict[str, Any]] = {}
        #: per-THREAD mirrors of (compiles, aot_hits, cache_hits): the
        #: serving warm-up attributes each bucket from these, so a deploy
        #: thread warming a new generation is not credited with the old
        #: generation's concurrent dispatches
        self._tls = threading.local()

    def _tls_bump(self, field: str) -> None:
        counts = getattr(self._tls, "counts", None)
        if counts is None:
            counts = self._tls.counts = {"compiles": 0, "aot_hits": 0,
                                         "cache_hits": 0}
        counts[field] += 1

    def thread_counts(self) -> Tuple[int, int, int]:
        """(compiles, aot_hits, cache_hits) recorded by THIS thread."""
        counts = getattr(self._tls, "counts", None)
        if counts is None:
            return (0, 0, 0)
        return (counts["compiles"], counts["aot_hits"],
                counts["cache_hits"])

    def record_aot(self, op: str, *, event: str,
                   seconds: float = 0.0) -> None:
        """One cache event: ``hit`` (a library loaded from the cache root,
        ``seconds`` = verify + load), ``miss`` (a live nvcc build,
        ``seconds`` = its wall), ``store``, ``store_failed``,
        ``quarantine`` (a damaged or skewed entry moved aside) or
        ``unserializable`` (kept for the JAX package's keys; the port's
        artifacts are files, so it stays 0)."""
        ms = seconds * 1e3
        with self._lock:
            if event == "hit":
                self.aot_hits += 1
                self._aot_load_ms += ms
            elif event == "miss":
                self.aot_misses += 1
                self._compile_ms += ms
            elif event == "store":
                self.aot_stores += 1
            elif event == "store_failed":
                self.aot_store_failed += 1
            elif event == "quarantine":
                self.aot_quarantined += 1
            elif event == "unserializable":
                self.aot_unserializable += 1
            else:
                raise ValueError(f"unknown AOT event {event!r}")
            if event == "hit":
                self._tls_bump("aot_hits")
            if event in ("hit", "miss"):
                rec = self.per_op.setdefault(
                    op, {"dispatches": 0, "compiles": 0, "cache_hits": 0})
                rec["aot_hits"] = rec.get("aot_hits", 0) \
                    + (1 if event == "hit" else 0)
                rec["aot_misses"] = rec.get("aot_misses", 0) \
                    + (1 if event == "miss" else 0)
                which = "aot_load_ms" if event == "hit" else "compile_ms"
                rec[which] = round(rec.get(which, 0.0) + ms, 3)

    def record_autotune(self, op: str, sig: tuple, choice: str, *,
                        kind: str, source: str, search_ms: float,
                        timings: Dict[str, float]) -> None:
        """One autotune resolution: ``source`` "measured" (a search ran
        and was persisted where a cache root is set) or "cache" (a
        recorded winner, no search)."""
        with self._lock:
            self.tuned_ops[f"{op}|{sig!r}"] = {
                "choice": choice, "kind": kind, "source": source,
                "search_ms": round(search_ms, 2), "timings_ms": timings,
            }

    def counts(self) -> Tuple[int, int, int]:
        """(compiles, aot_hits, cache_hits), process-wide."""
        with self._lock:
            return (self.compiles, self.aot_hits, self.cache_hits)

    def record(self, op: str, *, compiled: bool, seconds: float) -> None:
        ms = seconds * 1e3
        with self._lock:
            self.dispatches += 1
            if compiled:
                self.compiles += 1
                self._tls_bump("compiles")
            else:
                self.cache_hits += 1
                self._tls_bump("cache_hits")
            self._last_ms = ms
            self._lat_ema_ms = (0.8 * self._lat_ema_ms + 0.2 * ms
                                if self._lat_ema_ms else ms)
            rec = self.per_op.setdefault(
                op, {"dispatches": 0, "compiles": 0, "cache_hits": 0})
            rec["dispatches"] += 1
            rec["compiles" if compiled else "cache_hits"] += 1

    @property
    def dispatch_latency_ms(self) -> float:
        return self._lat_ema_ms

    def snapshot(self) -> Dict[str, Any]:
        launches = _launch_counts()
        with self._lock:
            return {
                "compiles": self.compiles,
                "cache_hits": self.cache_hits,
                "dispatches": self.dispatches,
                "dispatch_latency_ms": round(self._lat_ema_ms, 4),
                "last_dispatch_ms": round(self._last_ms, 4),
                "aot": {
                    "hits": self.aot_hits,
                    "misses": self.aot_misses,
                    "stores": self.aot_stores,
                    "store_failed": self.aot_store_failed,
                    "quarantined": self.aot_quarantined,
                    "unserializable": self.aot_unserializable,
                    "load_ms": round(self._aot_load_ms, 3),
                    "compile_ms": round(self._compile_ms, 3),
                },
                "tuned_ops": {k: dict(v)
                              for k, v in self.tuned_ops.items()},
                "per_op": {k: dict(v) for k, v in self.per_op.items()},
                "launches": launches,
            }

    def publish(self, group) -> None:
        """Refresh gauges on ``group`` (a ``MetricGroup``): the JAX
        package's gauges, plus a ``launches`` subgroup."""
        snap = self.snapshot()
        for name in ("compiles", "cache_hits", "dispatches",
                     "dispatch_latency_ms", "last_dispatch_ms"):
            group.gauge(name).set(snap[name])
        for name in ("hits", "misses", "stores", "store_failed",
                     "quarantined", "unserializable", "load_ms",
                     "compile_ms"):
            group.gauge(f"aot_{name}").set(snap["aot"][name])
        group.gauge("tuned_ops").set(len(snap["tuned_ops"]))
        group.gauge("ops_seen").set(len(snap["per_op"]))
        launches = group.add_group("launches")
        for name, count in snap["launches"].items():
            launches.gauge(name).set(count)


#: THE process-wide stats instance.
kernel_stats = KernelStats()


# --------------------------------------------------------------------------
# the shared dispatch surface (api/chain.py's segment runner)
# --------------------------------------------------------------------------

_KEY_LOCK = threading.Lock()
_SEEN_KEYS: set = set()
_DISPATCHES = [0]


def _leaf_key(x) -> Any:
    if isinstance(x, dict):
        return ("d",) + tuple((k, _leaf_key(x[k])) for k in sorted(x))
    if isinstance(x, (list, tuple)):
        return ("l",) + tuple(_leaf_key(v) for v in x)
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype))
    return type(x).__name__


def _dispatch_key(plan: tuple, params_seq, cols) -> Any:
    """``(plan, shapes)``: the plan's identity plus the structure, shapes
    and dtypes of its params and columns, the JAX package's jit key."""
    key = (plan, _leaf_key(params_seq), _leaf_key(cols))
    try:
        hash(key)
    except TypeError:
        # a static that is not hashable: key it by its repr
        key = (tuple((fn, repr(static)) for fn, static in plan),) + key[1:]
    return key


def _run_plan(plan: tuple, params_seq, cols: Dict[str, Any]
              ) -> Dict[str, Any]:
    import torch

    out = dict(cols)
    with torch.no_grad():
        for (fn, static), params in zip(plan, params_seq):
            out.update(fn(static, params, out))
    return out


def dispatch(plan: tuple, params_seq, cols: Dict[str, Any], *,
             op: Optional[str] = None) -> Dict[str, Any]:
    """Run ``plan`` over ``cols``: each stage's ``fn(static, params,
    out)`` in order, its outputs merged into the column dict, with
    compile / cache-hit / latency accounting on :data:`kernel_stats`
    (``op`` labels the per-op counters; default the stage functions'
    names).

    Nothing is compiled: ``compiles`` counts the first run in this
    process of a ``(plan, shapes)`` key, the JAX package's keying
    (``kernels/registry.py:444-449, 497-515`` there), and ``cache_hits``
    every later run of it.  The JAX runner also multiplies every float
    output by a runtime 1.0, a rounding barrier against the compiler
    contracting a stage's trailing multiply into the next stage's add;
    eager PyTorch runs and rounds every operation on its own, so no
    contraction can cross a stage boundary and no barrier is needed
    (the chain's stagewise-equals-fused tests hold it bit for bit)."""
    label = op or "+".join(fn.__name__ for fn, _ in plan)
    key = _dispatch_key(plan, params_seq, cols)
    with _KEY_LOCK:
        seen = key in _SEEN_KEYS
        _SEEN_KEYS.add(key)
        _DISPATCHES[0] += 1
    t0 = time.perf_counter()
    try:
        with tracer.span("registry_dispatch", cat="kernel", op=label):
            return _run_plan(plan, params_seq, cols)
    finally:
        # a stage that raised still counts, so the ledger's dispatches
        # stay dispatch_count()
        kernel_stats.record(label, compiled=not seen,
                            seconds=time.perf_counter() - t0)


def dispatch_count() -> int:
    """Dispatches so far (one per segment or single-stage run)."""
    return _DISPATCHES[0]
