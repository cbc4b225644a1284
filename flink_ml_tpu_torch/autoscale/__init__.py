"""Unified autoscaling control plane.

A port of the JAX package's ``autoscale/`` (host code on an injectable
clock).  One controller reads the metrics tree (``obs/tree.py``),
publishes a versioned :class:`PlacementMap` splitting the chip budget
between the multi-tenant scheduler and a continuous learner's fleet, and
rebalances continuously — serving scales out as diurnal traffic ramps,
the trough yields to training, and interactive load preempts it back —
with hysteresis so noise never thrashes the fleet.  The learner side is
any object with ``request_resize`` (the JAX package's elastic
coordinator is not ported).

Modules: :mod:`~.placement` (the versioned map + durable store),
:mod:`~.signals` (typed frames over ``MetricsTree.snapshot()``),
:mod:`~.policy` (deadband + min-dwell decision loop),
:mod:`~.controller` (the actuation loop; every decision a tracer
instant).
"""

from .controller import AutoscaleController
from .placement import PlacementConflict, PlacementMap, PlacementStore
from .policy import (DECISION_HOLD, DECISION_SCALE_SERVING,
                     DECISION_YIELD_TO_TRAINING, AutoscalePolicy,
                     Decision, PolicyConfig)
from .signals import SignalFrame, SignalSource, TenantSignal

__all__ = [
    "AutoscaleController",
    "AutoscalePolicy",
    "Decision",
    "DECISION_HOLD",
    "DECISION_SCALE_SERVING",
    "DECISION_YIELD_TO_TRAINING",
    "PlacementConflict",
    "PlacementMap",
    "PlacementStore",
    "PolicyConfig",
    "SignalFrame",
    "SignalSource",
    "TenantSignal",
]
