"""Data parallelism over a ``torch.distributed`` process group, one rank
a device: the port of the JAX package's ``parallel/`` as far as data
parallelism needs it (the mesh of named axes, the dense and compressed
collectives, the multi-process runtime and the configurable gradient
reduction, ``grad_reduce``, and elastic fleets, ``elastic``, with
``grad_reduce.reshard_state``).  ``moe``, ``pipeline_parallel``,
``ring_attention`` and ``ulysses`` are not ported (ROADMAP A10)."""

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
