"""Online serving runtime: fitted models behind endpoints that keep the
card busy under many small concurrent requests while bounding tail
latency.  A port of the JAX package's ``serving/``:

- :mod:`.batcher` — bounded request queue + dynamic micro-batcher
  (max-wait coalescing, shed-on-full admission control),
- :mod:`.executor` — ``ServableModel``: bucketed power-of-two batch
  shapes, eager per-bucket warm-up, the model's chain-terminal kernel
  with its params on the device once a generation; bit-exact with
  offline ``transform()``,
- :mod:`.registry` — versioned model registry with atomic hot swap under
  a generation counter (warm-up off the serving path; in-flight batches
  finish on the version they started on),
- :mod:`.endpoint` — the serve loop wiring them together,
- :mod:`.metrics` — latency/throughput instrumentation, the ``health``
  gauge and the rollback counter of the self-healing hot swap,
- :mod:`.scheduler` — the multi-tenant scheduler: one admission layer
  over many servables on one device, SLO classes with priority
  shedding, weighted fair queuing within a class, per-tenant metric
  subtrees and ``tenant``-keyed trace spans,
- :mod:`.embcache` — device-resident LRU embedding-row blocks for
  Wide&Deep's long-tail vocab, bit-exact with offline ``transform``,
- :mod:`.failover` — serving fleet failover: a chip-lease health table
  (seeded ``chip_down``/``chip_flap`` faults, lease expiry on an
  injected clock), re-placement through the autoscale placement store's
  CAS, re-admission, the SLO-aware brownout ladder with hysteresis, and
  N-way replication of high-SLO tenants.

Continuous publishes into a live generation (``endpoint.delta_publisher()``,
``scheduler.delta_publisher(name)``) come from ``online/``.

Quick start::

    from flink_ml_tpu_torch.serving import serve_model

    endpoint = serve_model(fitted_model, example_request_table)
    prediction = endpoint.predict(request_table)     # == offline transform
    endpoint.hot_swap("/path/v2")                    # atomic hot swap
    endpoint.close()

Multi-tenant (one process, many models, one device)::

    from flink_ml_tpu_torch.serving import SharedScheduler

    sched = SharedScheduler(queue_capacity=4096)
    sched.add_tenant("checkout", model_a, example_a, slo="interactive")
    sched.add_tenant("nightly", model_b, example_b, slo="bulk", weight=0.5)
    sched.start()
    prediction = sched.predict("checkout", request_table)
    sched.close()
"""

from .batcher import MicroBatcher, ServingOverloadedError, ServingRequest
from .embcache import CachedWideDeepServable, EmbeddingRowCache
from .endpoint import ServingEndpoint, serve_model
from .executor import ServableModel, make_servable
from .failover import (CHIP_SCOPE, FailoverDriver, FailoverReport,
                       FleetHealth)
from .metrics import (HEALTH_DEGRADED, HEALTH_SERVING, LatencyTracker,
                      ServingMetrics)
from .registry import DeployedModel, GenerationConflict, ModelRegistry
from .scheduler import (DISPATCH_SCOPE, SLO_BULK, SLO_CLASSES,
                        SLO_INTERACTIVE, SLO_STANDARD, SharedScheduler,
                        Tenant)

__all__ = [
    "MicroBatcher", "ServingOverloadedError", "ServingRequest",
    "ServingEndpoint", "serve_model",
    "ServableModel", "make_servable",
    "LatencyTracker", "ServingMetrics",
    "HEALTH_SERVING", "HEALTH_DEGRADED",
    "DeployedModel", "GenerationConflict", "ModelRegistry",
    "SharedScheduler", "Tenant",
    "SLO_INTERACTIVE", "SLO_STANDARD", "SLO_BULK", "SLO_CLASSES",
    "EmbeddingRowCache", "CachedWideDeepServable",
    "CHIP_SCOPE", "DISPATCH_SCOPE",
    "FleetHealth", "FailoverDriver", "FailoverReport",
]
