"""Parallelism over a ``torch.distributed`` process group, one rank a
device: the port of the JAX package's ``parallel/``.  The mesh of named
axes, the dense, compressed and differentiable collectives (with the ring
permute and the all-to-all), the multi-process runtime, the configurable
gradient reduction (``grad_reduce``) and elastic fleets (``elastic``, with
``grad_reduce.reshard_state``); and the model-parallel families, each
running per rank on its own shard: pipeline parallelism
(``pipeline_parallel``), ring and Ulysses attention over a sequence axis
(``ring_attention``, ``ulysses``) and the routed mixture of experts over an
expert axis (``moe``)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    axis_process_count,
    default_mesh,
    device_mesh,
    fetch_replicated,
    fleet_mesh,
    local_axis_multiple,
    local_device_count,
    local_mesh,
    mesh_process_count,
    put_sharded,
    replicate,
    shard_batch,
)
from . import collectives  # noqa: F401
from . import distributed  # noqa: F401
from . import elastic  # noqa: F401
from . import grad_reduce  # noqa: F401
from .elastic import (  # noqa: F401
    MEMBERSHIP_SCOPE,
    ElasticCoordinator,
    FleetView,
    ResizeRequested,
    WorkerLease,
)
from .moe import (  # noqa: F401
    EXPERT_AXIS,
    MoEParams,
    init_moe,
    moe_apply,
    moe_sharding,
    shard_moe,
)
from .pipeline_parallel import (  # noqa: F401
    PIPE_AXIS,
    build_pipeline,
    pipeline_apply,
)
from .ring_attention import attention_reference, ring_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
