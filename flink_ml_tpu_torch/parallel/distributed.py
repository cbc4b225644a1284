"""The multi-process runtime: one ``torch.distributed`` rank a device.

The JAX package joins the JAX distributed runtime (one process a host,
ICI collectives inside a slice); the port starts one process for each
device and joins them in a ``torch.distributed`` process group: NCCL
between cards, gloo between CPU processes (the tests' ranks).  This module
is the control plane around the group: initialization, the rank's facts,
the barrier, host 0's value on every rank, host values gathered from every
rank, and the local <-> global view of a sharded batch (a rank's shard is
its own rows on its own device: nothing to assemble).

Usage, one process a rank:

    from flink_ml_tpu_torch.parallel import distributed as dist
    dist.initialize("tcp://localhost:29500", num_processes=2, process_id=r)
    est = KMeans(device="cuda").set_k(256)
    model = est.fit(Table({"features": my_rows}))  # each rank its shard

Without a group everything runs in this one process.  A group of one rank
runs the collectives too (the NCCL branch on one card).  A port of the JAX
package's ``parallel/distributed.py``; ``global_mesh`` and ``hybrid_mesh``
are the mesh module's :func:`~.mesh.device_mesh` here.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "is_initialized",
    "shutdown",
    "ProcessInfo",
    "process_info",
    "rank_device",
    "host_local_to_global",
    "global_to_host_local",
    "barrier",
    "broadcast_from_host0",
    "process_allgather",
]

_RANK_DEVICE: Optional[torch.device] = None

# torchrun's environment (MASTER_ADDR and the rest): the launcher case
_LAUNCHER_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device=None, backend: Optional[str] = None,
               timeout_s: float = 600.0) -> None:
    """Join the process group as rank ``process_id`` of ``num_processes``.

    ``coordinator_address`` is rank 0's ``host:port`` (or a
    ``tcp://``/``env://`` URL).  ``device`` is the device this rank drives
    (default the card; ``"cpu"`` for CPU processes); ``backend`` defaults
    to NCCL for a CUDA device and gloo for the CPU.  Two ranks on one card
    need gloo: NCCL refuses two ranks on one device.  With explicit
    arguments the call must succeed; with none it joins when torchrun's
    environment is set, and is otherwise a no-op (one process).  A second
    call is a no-op."""
    global _RANK_DEVICE
    if dist.is_initialized():
        return
    explicit = (coordinator_address is not None
                or num_processes not in (None, 1)
                or process_id is not None)
    if not explicit and not all(v in os.environ for v in _LAUNCHER_ENV):
        return
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", (process_id or 0)
                               % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(
        backend, init_method=init_method,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _RANK_DEVICE = dev


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _RANK_DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE = None


def is_initialized() -> bool:
    return dist.is_initialized()


def rank_device() -> Optional[torch.device]:
    """The device this rank drives (None without a group)."""
    return _RANK_DEVICE if dist.is_initialized() else None


@dataclass
class ProcessInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def process_info() -> ProcessInfo:
    """This rank's index and the group's size (one device a rank)."""
    if not dist.is_initialized():
        return ProcessInfo(0, 1, 1, 1)
    world = dist.get_world_size()
    return ProcessInfo(dist.get_rank(), world, 1, world)


def _comm_device(group) -> torch.device:
    """Where host values travel: the card for NCCL, the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _group(mesh):
    if mesh is not None:
        return mesh.group
    return dist.group.WORLD if dist.is_initialized() else None


def barrier(tag: str = "flink_ml_tpu_torch", *, mesh=None) -> None:
    """Every rank waits here for the others (``tag`` names the point in
    errors only); a no-op without a group."""
    group = _group(mesh)
    if group is not None:
        dist.barrier(group=group)


def process_allgather(x, *, mesh=None) -> np.ndarray:
    """Host value ``x`` (an array of the same shape on every rank)
    gathered from every rank: ``(world, *x.shape)`` in rank order, on
    every rank.  The counterpart of ``multihost_utils.process_allgather``
    that the JAX fit calls on its row counts."""
    arr = np.asarray(x)
    group = _group(mesh)
    if group is None:
        return arr[None]
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(_comm_device(group))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return np.stack([o.cpu().numpy() for o in out])


def broadcast_from_host0(tree: Any, *, mesh=None) -> Any:
    """Rank 0's value on every rank: tensors stay on their device (each
    rank passes one of the same shape and type), host arrays come back as
    host arrays.  Returns the tree unchanged without a group."""
    from .mesh import _tree_map

    group = _group(mesh)
    if group is None:
        return tree

    def bcast(x):
        if isinstance(x, torch.Tensor):
            out = x.detach().clone().contiguous()
            dist.broadcast(out, src=0, group=group)
            return out
        arr = np.asarray(x)
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(
            _comm_device(group))
        dist.broadcast(t, src=0, group=group)
        return t.cpu().numpy()

    return _tree_map(bcast, tree)


def host_local_to_global(tree: Any, mesh=None, axis: str = "data") -> Any:
    """This rank's batch as its shard of the global batch: its rows on its
    device (:func:`~.mesh.shard_batch` without padding)."""
    from .mesh import shard_batch

    return shard_batch(tree, mesh, axis=axis, pad=False)


def global_to_host_local(tree: Any, mesh=None, axis: str = "data") -> Any:
    """Inverse of :func:`host_local_to_global`: this rank's shard as host
    arrays."""
    from .mesh import fetch_replicated

    return fetch_replicated(tree)
