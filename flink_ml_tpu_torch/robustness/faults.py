"""Deterministic fault injection — failure as a reproducible test input.

A :class:`FaultPlan` schedules faults against named **scopes** — the
instrumented seams of the stack::

    source.pull        data-source pulls (plan.wrap_source(reader))
    checkpoint.write   checkpoint commit (iteration/checkpoint.py)
    wal.append         window-log appends (data/wal.py)
    persist.write      stage model-array saves (utils/persist.py)
    serving.load       registry model loads (serving/registry.py)
    serving.warm_up    executor warm-up (serving/executor.py)
    serving.predict    executor predict calls
    serving.publish    registry publish_servable swaps
    serving.dispatch   the serving loops' dispatch boundary (endpoint
                       and scheduler)
    iterate.epoch      hosted iteration epochs (iteration/core.py)

The port instruments every scope above, under the JAX package's names,
so a plan written for that package runs unchanged.

Each scope keeps an invocation counter; a fault fires when the counter
hits a scheduled index.  Explicit schedules (:meth:`FaultPlan.inject`)
and seeded random ones (:meth:`FaultPlan.inject_random`) are both fully
deterministic — same plan, same faults, so every recovery test replays
bit-identically.  MLFabric's stance applies: training must tolerate a
lossy substrate rather than assume a perfect one, and the only way to
*test* that is to make the substrate lossy on demand.

Fault kinds:

- ``"transient"`` — raises :class:`InjectedTransientError` (an
  ``IOError`` with ``transient = True``, the marker
  :func:`~.retry.default_classify` treats as retryable) *before* the
  wrapped operation runs, so a retry is lossless;
- ``"crash"`` — raises :class:`InjectedCrash`: the simulated process
  death the supervisor (:func:`~.supervisor.resilient_fit`) heals;
- ``"enospc"`` — raises :class:`InjectedDiskFullError`
  (``errno.ENOSPC``; classified fatal, not retryable);
- ``"torn"`` / ``"flip"`` — **data** faults at file scopes: the bytes
  just written are truncated / bit-flipped *before* the commit rename,
  producing a committed-but-invalid artifact that only manifest/CRC
  validation (:mod:`.durability`) can catch;
- ``"preempt"`` / ``"join"`` — **membership** faults (elastic fleets):
  raise :class:`InjectedPreemption` / :class:`InjectedJoin` at the
  seam, which the elastic coordinator's chunk-boundary ``poll``
  (the JAX package's ``parallel/elastic.py``; ROADMAP queue A10
  in the port) translates into a deterministic
  leave/join transition.  Seedable like every other kind
  (:meth:`FaultPlan.inject_random` works unchanged), and — because
  :meth:`FaultPlan.fire` runs BEFORE the wrapped operation —
  ``wrap_source``-style wrappers stay lossless across a resize: a
  membership fault never consumes an item;
- ``"chip_down"`` / ``"chip_flap"`` — **fleet** faults (serving
  failover): raise :class:`InjectedChipDown` /
  :class:`InjectedChipFlap` at a serving scheduler's dispatch boundary,
  before ``predict`` runs, so the picked micro-batch is requeued intact
  and the schedule stays lossless/replayable.

Control faults (transient/crash/enospc, the membership pair, and the
fleet pair) are valid at every scope; data faults only where a file
path reaches the injection point.

A copy of the JAX package's ``robustness/faults.py`` (host-only): the same
seed gives the same schedule in both packages.
"""

from __future__ import annotations

import errno
import os

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "FaultPlan", "InjectedChipDown", "InjectedChipFlap", "InjectedCrash",
    "InjectedDiskFullError", "InjectedJoin", "InjectedPreemption",
    "InjectedTransientError", "corrupt_file", "fault_point", "active_plan",
]


class InjectedTransientError(IOError):
    """A retryable injected fault (``transient = True`` is the marker
    :func:`~.retry.default_classify` keys on)."""

    transient = True


class InjectedCrash(RuntimeError):
    """Simulated process death: not retryable at the call site (a retry
    loop must NOT swallow it), recoverable by the supervisor via
    checkpoint restore + replay."""


class InjectedDiskFullError(OSError):
    def __init__(self, message: str):
        super().__init__(errno.ENOSPC, message)


class InjectedPreemption(RuntimeError):
    """A membership fault: the scheduler reclaimed a worker.  Raised at
    the seam BEFORE the wrapped operation (nothing is consumed — the
    lossless ``wrap_source`` contract holds across a resize) and
    translated by the elastic coordinator's ``poll`` into a
    deterministic leave transition; it is NOT a retryable error and
    must never be swallowed by a retry loop."""


class InjectedJoin(RuntimeError):
    """The membership fault dual of :class:`InjectedPreemption`: a new
    worker asks to join.  Same raise-before-the-operation contract;
    translated by the coordinator's ``poll`` into a join transition."""


class InjectedChipDown(RuntimeError):
    """A fleet fault: one serving chip died.  Raised at the DISPATCH
    boundary BEFORE the micro-batch's predict runs (nothing is served,
    nothing is lost — the scheduler requeues the picked requests with
    their futures intact) and translated by the serving failover layer
    into a deterministic chip-death transition; NOT retryable at
    the call site and never swallowed by a retry loop."""


class InjectedChipFlap(RuntimeError):
    """The flapping dual of :class:`InjectedChipDown`: the chip dies and
    comes back shortly after (a deterministic number of health polls
    later).  Same raise-before-dispatch lossless contract; the failover
    layer's hysteresis is what keeps the flap from thrashing
    placements."""


_CONTROL_KINDS = ("transient", "crash", "enospc", "preempt", "join",
                  "chip_down", "chip_flap")
_DATA_KINDS = ("torn", "flip")


def _flip_offset(path: str, size: int, draw: int) -> int:
    """A seeded offset guaranteed to hit PAYLOAD bytes.  Zip containers
    (npz) get a flip inside the largest member's CRC-covered data — a
    blind offset could land in header/directory slack the reader
    tolerates, making the 'corruption' a silent no-op; other formats get
    the middle third (clear of magic bytes and trailers)."""
    import zipfile

    try:
        with zipfile.ZipFile(path) as zf:
            info = max(zf.infolist(), key=lambda z: z.compress_size,
                       default=None)
        if info is not None and info.compress_size > 0:
            with open(path, "rb") as f:
                f.seek(info.header_offset)
                hdr = f.read(30)
            name_len = hdr[26] | (hdr[27] << 8)
            extra_len = hdr[28] | (hdr[29] << 8)
            start = info.header_offset + 30 + name_len + extra_len
            return start + draw % info.compress_size
    except (zipfile.BadZipFile, OSError, IndexError):
        pass
    span = max(1, size // 3)
    return size // 3 + draw % span


def corrupt_file(path: str, mode: str = "flip", seed: int = 0) -> None:
    """Deterministically damage ``path`` in place: ``"flip"`` XORs one
    byte at a seeded offset in the file's middle third (the payload
    region — container formats like zip tolerate flips in their header/
    directory slack, which would make the corruption a no-op), ``"torn"``
    truncates to a seeded fraction (a torn write's committed prefix).
    The standalone helper tests and bench use to corrupt
    *already-committed* artifacts."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path!r}")
    # LCG on the seed: cheap, deterministic, no RNG object needed
    draw = seed * 2654435761 + 12345
    if mode == "flip":
        offset = _flip_offset(path, size, draw)
        with open(path, "r+b") as f:
            f.seek(offset)
            byte = f.read(1)
            f.seek(offset)
            f.write(bytes([byte[0] ^ 0xFF]))
    elif mode == "torn":
        # keep at least one byte, drop at least one: a prefix, never all
        keep = max(1, min(size - 1, draw % size))
        with open(path, "r+b") as f:
            f.truncate(keep)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")


@dataclass
class _FaultSpec:
    scope: str
    indices: Tuple[int, ...]
    kind: str
    remaining: int


@dataclass
class FaultPlan:
    """A reproducible schedule of faults over scoped invocation counters.

    Activate with ``with plan: ...`` (sets the process-wide active plan
    the :func:`fault_point` seams consult — worker threads inside the
    block see it too), or pass the plan explicitly where an API takes
    one (``plan.wrap_source``).  ``fires`` records every fault that
    actually fired as ``(scope, index, kind)`` — the audit log recovery
    tests and the bench's steps-replayed accounting read."""

    seed: int = 0
    _specs: List[_FaultSpec] = field(default_factory=list)
    _counters: Dict[str, int] = field(default_factory=dict)
    fires: List[Tuple[str, int, str]] = field(default_factory=list)

    # -- scheduling --------------------------------------------------------
    def inject(self, scope: str, *, at: int, kind: str = "transient",
               times: int = 1) -> "FaultPlan":
        """Fire ``kind`` at invocation ``at`` of ``scope`` (0-based), and
        at each subsequent invocation until it has fired ``times`` times
        — ``times=2`` at a retried call site exercises back-to-back
        transient failures."""
        if kind not in _CONTROL_KINDS + _DATA_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        if times < 1:
            raise ValueError("times must be >= 1")
        self._specs.append(_FaultSpec(
            scope, tuple(range(at, at + times)), kind, times))
        return self

    def inject_random(self, scope: str, *, rate: float, horizon: int,
                      kind: str = "transient") -> "FaultPlan":
        """Seeded Bernoulli schedule: each of the first ``horizon``
        invocations of ``scope`` fires with probability ``rate``.  The
        draw depends only on ``(seed, scope, kind)`` — same plan, same
        fault indices, run after run."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        import numpy as np
        import zlib

        # crc32, not hash(): str hashing is salted per-process, which
        # would make the schedule unreproducible across runs
        key = zlib.crc32(f"{self.seed}:{scope}:{kind}".encode())
        draws = np.random.default_rng(key).random(horizon)
        indices = tuple(int(i) for i in np.nonzero(draws < rate)[0])
        if indices:
            self._specs.append(_FaultSpec(scope, indices, kind,
                                          len(indices)))
        return self

    def scheduled(self, scope: str) -> List[Tuple[int, str]]:
        """The (index, kind) schedule for ``scope`` — what WILL fire."""
        out = [(i, s.kind) for s in self._specs if s.scope == scope
               for i in s.indices]
        return sorted(out)

    # -- firing ------------------------------------------------------------
    def fire(self, scope: str, path: Optional[str] = None) -> None:
        """One invocation of ``scope``: bump the counter and fire any
        scheduled fault.  Control faults raise; data faults damage
        ``path`` in place and return (the caller then commits the
        damaged bytes — the torn-write model)."""
        idx = self._counters.get(scope, 0)
        self._counters[scope] = idx + 1
        for spec in self._specs:
            if (spec.scope != scope or spec.remaining <= 0
                    or idx not in spec.indices):
                continue
            spec.remaining -= 1
            self.fires.append((scope, idx, spec.kind))
            if spec.kind == "transient":
                raise InjectedTransientError(
                    f"injected transient fault at {scope}[{idx}]")
            if spec.kind == "crash":
                raise InjectedCrash(
                    f"injected crash at {scope}[{idx}]")
            if spec.kind == "enospc":
                raise InjectedDiskFullError(
                    f"injected ENOSPC at {scope}[{idx}]")
            if spec.kind == "preempt":
                raise InjectedPreemption(
                    f"injected preemption at {scope}[{idx}]")
            if spec.kind == "join":
                raise InjectedJoin(
                    f"injected join at {scope}[{idx}]")
            if spec.kind == "chip_down":
                raise InjectedChipDown(
                    f"injected chip death at {scope}[{idx}]")
            if spec.kind == "chip_flap":
                raise InjectedChipFlap(
                    f"injected chip flap at {scope}[{idx}]")
            if path is None:
                raise ValueError(
                    f"data fault {spec.kind!r} scheduled at {scope}[{idx}] "
                    "but the injection point carries no file path; data "
                    "faults only apply to file-write scopes")
            corrupt_file(path, mode=spec.kind, seed=self.seed + idx)

    def wrap_source(self, source: Any,
                    scope: str = "source.pull") -> "FaultySource":
        """Wrap an iterable so each pull passes through :meth:`fire`
        BEFORE the underlying ``next`` — a transient fault never consumes
        an item, so retrying the pull is lossless."""
        return FaultySource(source, self, scope)

    # -- activation --------------------------------------------------------
    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("another FaultPlan is already active")
        _ACTIVE = self
        return self

    def __exit__(self, *exc_info) -> None:
        global _ACTIVE
        _ACTIVE = None


class FaultySource:
    """Iterator wrapper from :meth:`FaultPlan.wrap_source`.  Deliberately
    a class, not a generator: a generator that raises is dead forever,
    while this ``__next__`` can raise a transient fault and then serve
    the SAME item on the retried call."""

    def __init__(self, source: Any, plan: FaultPlan, scope: str):
        self._it = iter(source)
        self._plan = plan
        self._scope = scope

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        self._plan.fire(self._scope)
        return next(self._it)


#: The process-wide active plan (``with plan:``).  A plain global, not a
#: thread-local, on purpose: faults must reach the prefetch/serve worker
#: threads spawned inside the activation block.
_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def fault_point(scope: str, path: Optional[str] = None) -> None:
    """The injection seam the durability/serving layers call at their
    I/O boundaries.  No active plan (production) = one ``is None`` check
    and out."""
    if _ACTIVE is not None:
        _ACTIVE.fire(scope, path)
