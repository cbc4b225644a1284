"""Data parallelism over a ``torch.distributed`` process group, one rank
a device: the port of the JAX package's ``parallel/`` as far as KMeans
needs it (the mesh, the dense collectives and the multi-process runtime).
``grad_reduce``, ``elastic``, ``moe``, ``pipeline_parallel``,
``ring_attention`` and ``ulysses`` are not ported (ROADMAP A10)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    axis_process_count,
    default_mesh,
    device_mesh,
    fetch_replicated,
    local_axis_multiple,
    local_device_count,
    mesh_process_count,
    put_sharded,
    replicate,
    shard_batch,
)
from . import collectives  # noqa: F401
from . import distributed  # noqa: F401
