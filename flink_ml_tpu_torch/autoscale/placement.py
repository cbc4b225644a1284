"""Versioned placement map — who owns which chips, this generation.

A copy of the JAX package's ``autoscale/placement.py``.  The control
plane's single source of truth: a :class:`PlacementMap` assigns every
servable tenant a **chip set** and the continuous learner a **fleet
extent** (workers of ``chips_per_worker`` chips).  The multi-tenant
scheduler and the learner's fleet both READ the live map; only the controller writes it, and every write is an atomic
generation-by-generation publish through a :class:`PlacementStore`:

- **Immutable maps, lock-free reads.**  A published map is frozen; the
  store's ``current()`` is one reference read (the
  ``serving/registry.py`` atomicity stance — a consumer captures the
  reference once per decision and never sees a half-built placement).
- **Durable publish via the checkpoint commit protocol.**  With a ``path``
  configured, each publish serializes the map to ``<path>.tmp`` and
  ``os.replace``\\s it over ``path`` BEFORE the in-memory swap — a crash
  between the two leaves a newer map on disk than in memory, which
  :meth:`PlacementStore.load` reconciles at restart (re-publishing a
  placement is idempotent: actuators converge on whatever the live map
  says).  A half-written file can never sit at the trusted path.
- **Single-writer generations.**  ``publish`` is compare-and-swap
  against the generation the caller based its edit on
  (``expected_generation``) — a racing writer gets
  :class:`PlacementConflict`, the ``serving/registry.py``
  ``GenerationConflict`` stance, never a silent clobber.

Capacity invariant, validated at every publish: the serving chip union
and the learner's chips (``learner_workers * chips_per_worker``) must
fit ``total_chips`` together.  Tenant chip sets MAY overlap each other
(two servables sharing a chip is exactly the multi-tenant
scheduler's posture); serving and the learner never share a chip — that boundary
is the thing the controller exists to move deliberately.
"""

from __future__ import annotations

import json
import os
import threading
import time

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

__all__ = ["PlacementConflict", "PlacementMap", "PlacementStore"]


class PlacementConflict(RuntimeError):
    """A conditional publish lost the race: the live placement
    generation is not the one the caller edited against."""


@dataclass(frozen=True)
class PlacementMap:
    """One published placement: frozen, so a reference captured by a
    scheduler tick or a chunk-boundary poll stays internally consistent
    for as long as the consumer holds it."""

    generation: int
    #: tenant name -> sorted chip ids its servable is placed on
    servables: Mapping[str, Tuple[int, ...]]
    #: the continuous learner's fleet extent, in coordinator worker units
    learner_workers: int
    #: store-clock stamp of the publish (the controller's clock domain)
    published_at: float = 0.0

    def chips_for(self, tenant: str) -> Tuple[int, ...]:
        return tuple(self.servables.get(tenant, ()))

    def serving_chips(self) -> Tuple[int, ...]:
        """The union of every tenant's chip set, sorted."""
        out = set()
        for chips in self.servables.values():
            out.update(chips)
        return tuple(sorted(out))

    def as_dict(self) -> Dict[str, Any]:
        return {
            "generation": self.generation,
            "servables": {name: list(chips)
                          for name, chips in sorted(self.servables.items())},
            "learner_workers": self.learner_workers,
            "published_at": self.published_at,
        }

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "PlacementMap":
        return cls(
            generation=int(data["generation"]),
            servables={str(name): tuple(int(c) for c in chips)
                       for name, chips in dict(data["servables"]).items()},
            learner_workers=int(data["learner_workers"]),
            published_at=float(data.get("published_at", 0.0)),
        )


class PlacementStore:
    """The one writer-side object: validates, persists, and swaps
    placement generations.  Reads (``current()``) are a single
    reference fetch of an immutable map — no lock, the registry's
    ``live_generation`` stance — so the scheduler's dispatch loop and
    the coordinator's chunk-boundary poll can consult the placement at
    full rate."""

    def __init__(self, total_chips: int, *, chips_per_worker: int = 1,
                 path: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        if total_chips < 1:
            raise ValueError("total_chips must be >= 1")
        if chips_per_worker < 1:
            raise ValueError("chips_per_worker must be >= 1")
        self.total_chips = int(total_chips)
        self.chips_per_worker = int(chips_per_worker)
        self.path = path
        self.clock = clock
        self._lock = threading.Lock()
        self._current = PlacementMap(generation=0, servables={},
                                     learner_workers=0)
        self.publishes = 0

    # -- reads -------------------------------------------------------------
    def current(self) -> PlacementMap:
        """The live map — one reference read, immutable thereafter."""
        return self._current

    @property
    def generation(self) -> int:
        return self._current.generation

    # -- validation --------------------------------------------------------
    def _validate(self, servables: Mapping[str, Sequence[int]],
                  learner_workers: int) -> Dict[str, Tuple[int, ...]]:
        if learner_workers < 0:
            raise ValueError("learner_workers must be >= 0")
        norm: Dict[str, Tuple[int, ...]] = {}
        union = set()
        for name, chips in servables.items():
            chips = tuple(sorted(int(c) for c in chips))
            if len(set(chips)) != len(chips):
                raise ValueError(
                    f"tenant {name!r} placement repeats a chip: {chips}")
            for c in chips:
                if not 0 <= c < self.total_chips:
                    raise ValueError(
                        f"tenant {name!r} placed on chip {c} outside the "
                        f"pool [0, {self.total_chips})")
            norm[name] = chips
            union.update(chips)
        learner_chips = learner_workers * self.chips_per_worker
        if len(union) + learner_chips > self.total_chips:
            raise ValueError(
                f"placement overcommits the fleet: {len(union)} serving "
                f"chip(s) + {learner_workers} learner worker(s) x "
                f"{self.chips_per_worker} chip(s) > {self.total_chips} "
                "total — serving and the learner never share a chip")
        return norm

    # -- the publish protocol ----------------------------------------------
    def publish(self, servables: Mapping[str, Sequence[int]],
                learner_workers: int, *,
                expected_generation: Optional[int] = None) -> PlacementMap:
        """Validate, persist (tmp -> ``os.replace``), then swap the live
        reference as the next generation.  ``expected_generation`` makes
        the swap conditional (compare-and-swap against the generation the
        caller edited) — a concurrent publish raises
        :class:`PlacementConflict` instead of silently clobbering."""
        norm = self._validate(servables, learner_workers)
        with self._lock:
            base = self._current.generation
            if expected_generation is not None \
                    and base != expected_generation:
                raise PlacementConflict(
                    f"placement publish expected generation "
                    f"{expected_generation} but {base} is live; re-read "
                    "current() and re-derive the edit")
            pmap = PlacementMap(
                generation=base + 1, servables=norm,
                learner_workers=int(learner_workers),
                published_at=self.clock())
        # durable BEFORE visible (the checkpoint commit order): a crash here
        # leaves generation N+1 on disk and N live in memory — load()
        # reconciles forward, and republishing a placement is idempotent
        if self.path is not None:
            self._write(pmap)
        with self._lock:
            if self._current.generation != base:
                raise PlacementConflict(
                    f"placement publish raced: generation moved "
                    f"{base} -> {self._current.generation} during the "
                    "durable write")
            self._current = pmap        # THE swap: one reference assign
            self.publishes += 1
        from ..obs.trace import tracer

        tracer.instant("placement_publish", cat="autoscale",
                       generation=pmap.generation,
                       x_learner_workers=str(pmap.learner_workers),
                       x_serving_chips=str(len(pmap.serving_chips())))
        return pmap

    def _write(self, pmap: PlacementMap) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(pmap.as_dict(), f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def load(self) -> Optional[PlacementMap]:
        """Restart reconciliation: adopt the on-disk map when it is ahead
        of memory (the crash-between-write-and-swap window).  Returns
        the adopted map, or ``None`` when there was nothing newer."""
        if self.path is None or not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            pmap = PlacementMap.from_dict(json.load(f))
        with self._lock:
            if pmap.generation <= self._current.generation:
                return None
            self._current = pmap
        return pmap

    # -- observability -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        pmap = self._current
        return {
            "generation": pmap.generation,
            "learner_workers": pmap.learner_workers,
            "serving_chips": len(pmap.serving_chips()),
            "total_chips": self.total_chips,
            "publishes": self.publishes,
        }
