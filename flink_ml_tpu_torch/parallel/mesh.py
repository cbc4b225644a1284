"""The data axis over a process group: the port's mesh.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` and lets
XLA insert the collectives.  The port runs one process (a rank of a
``torch.distributed`` process group) for each device, so its mesh is a
small description of the group: one ``"data"`` axis whose size is the
world size, the group, and the device this rank drives.  A batch sharded
over the axis is each rank's own rows on its own device; a replicated
value is the same tensor on every rank.

A port of the JAX package's ``parallel/mesh.py``, its data-parallel part
(the ``"model"`` axis and ``use_mesh`` are not ported).  Without an
initialized group the default mesh is one rank of one process.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "axis_process_count",
    "default_mesh",
    "device_mesh",
    "fetch_replicated",
    "local_axis_multiple",
    "local_device_count",
    "mesh_process_count",
    "put_sharded",
    "replicate",
    "shard_batch",
]

DATA_AXIS = "data"


class Mesh:
    """One ``"data"`` axis over ``group`` (None: this process alone).
    ``shape`` maps the axis to its size (the group's world size), as a
    JAX mesh's ``shape`` does; ``device`` is the device this rank drives
    (None where none was named)."""

    def __init__(self, group, size: int, device: Optional[torch.device]):
        self.group = group
        self.shape = {DATA_AXIS: int(size)}
        self.axis_names = (DATA_AXIS,)
        self.device = device

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, group={'yes' if self.group else 'no'}, "
                f"device={self.device})")


def local_device_count() -> int:
    """Devices this process drives: one, since the port runs one rank a
    device (size a rank's batch with it, as the JAX package sizes a
    host's)."""
    return 1


def device_mesh(axis_sizes: Optional[Mapping[str, int]] = None,
                device=None) -> Mesh:
    """The mesh of the initialized process group (one data axis of the
    world size; ``-1`` stands for it), or of this process alone.
    ``device`` is the rank's device (default: the one
    :func:`~flink_ml_tpu_torch.parallel.distributed.initialize` was given).
    Any other axis raises: one rank drives one device, so the port's
    meshes are data-parallel only."""
    from . import distributed

    group = dist.group.WORLD if dist.is_initialized() else None
    size = dist.get_world_size() if group is not None else 1
    axis_sizes = dict(axis_sizes or {DATA_AXIS: size})
    if set(axis_sizes) != {DATA_AXIS}:
        raise ValueError(f"the port's meshes have one {DATA_AXIS!r} axis, "
                         f"got {sorted(axis_sizes)}")
    want = axis_sizes[DATA_AXIS]
    if want not in (-1, size):
        raise ValueError(f"Mesh {{'data': {want}}} needs {want} ranks, "
                         f"the process group has {size}")
    if device is None:
        device = distributed.rank_device()
    return Mesh(group, size, None if device is None
                else torch.device(device))


def default_mesh() -> Mesh:
    """The process group's mesh, or this process alone without one."""
    return device_mesh()


def mesh_process_count(mesh: Mesh) -> int:
    """Processes on the mesh: its ranks."""
    return mesh.size


def axis_process_count(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    """Processes along ``axis``: each of its devices is a rank of its
    own."""
    if axis not in mesh.shape:
        raise ValueError(f"Mesh has no axis {axis!r}; axes: "
                         f"{list(mesh.shape)}")
    return mesh.shape[axis]


def local_axis_multiple(mesh: Mesh, axis: str = DATA_AXIS,
                        row_multiple: int = 1) -> int:
    """A rank's row-padding multiple for arrays sharded over ``axis``:
    its devices on the axis (one) times ``row_multiple``."""
    n_axis = int(mesh.shape[axis])
    return (n_axis // axis_process_count(mesh, axis)) * row_multiple


def _device(mesh: Optional[Mesh], device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    mesh = mesh or default_mesh()
    if mesh.device is not None:
        return mesh.device
    return resolve_device("cuda")


def put_sharded(arr, mesh: Optional[Mesh] = None, *,
                device=None) -> torch.Tensor:
    """This rank's rows of a batch sharded over the data axis, as a
    tensor on its device (``device``, else the mesh's (default: the
    default mesh's), else the card)."""
    return torch.as_tensor(np.ascontiguousarray(arr)).to(
        _device(mesh, device))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def shard_batch(tree: Any, mesh: Optional[Mesh] = None, *,
                axis: str = DATA_AXIS, pad: bool = True,
                device=None) -> Any:
    """Place a tree of host arrays, this rank's rows, on its device.  With
    ``pad`` rows are padded (repeating row 0) to the rank's multiple of
    :func:`local_axis_multiple` (one: nothing to pad).  On an axis of
    several ranks the padded row counts must be equal on every rank: one
    :func:`~.distributed.process_allgather` checks them, and every rank
    raises alike."""
    from ..utils.padding import pad_rows_with_mask
    from .distributed import process_allgather

    mesh = mesh or default_mesh()
    multiple = local_axis_multiple(mesh, axis)

    def put(x):
        arr = np.asarray(x)
        if pad and arr.shape and arr.shape[0] % multiple:
            arr = pad_rows_with_mask(arr, multiple)[0]
        return put_sharded(arr, mesh, device=device)

    if mesh.group is not None and axis_process_count(mesh, axis) > 1:
        first = next(iter(_leaves(tree)), None)
        if first is not None:
            rows = np.asarray(first).shape[0]
            rows += (-rows) % multiple if pad else 0
            gathered = process_allgather(np.asarray([rows], np.int64),
                                         mesh=mesh).reshape(-1)
            if not np.all(gathered == gathered[0]):
                raise ValueError(
                    "shard_batch on a process-spanning axis requires equal "
                    f"padded row counts per process; got {gathered.tolist()}")
    return _tree_map(put, tree)


def fetch_replicated(tree: Any) -> Any:
    """A tree of replicated tensors as numpy arrays: each rank's copy is
    the global value."""
    return _tree_map(lambda x: x.detach().cpu().numpy()
                     if isinstance(x, torch.Tensor) else np.asarray(x), tree)


def replicate(tree: Any, mesh: Optional[Mesh] = None, *,
              device=None) -> Any:
    """A tree of host arrays as tensors on the rank's device; every rank
    must pass the same values (a replicated value)."""
    return _tree_map(lambda x: put_sharded(x, mesh, device=device), tree)
