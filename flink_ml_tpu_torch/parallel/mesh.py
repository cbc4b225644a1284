"""The axes of a process group: the port's mesh.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` and lets
XLA insert the collectives.  The port runs one process (a rank of a
``torch.distributed`` process group) for each device, so its mesh is a
small description of the group: named axes whose sizes multiply to the
world size, a process group for each axis and each tuple of axes, and the
device this rank drives.  Rank ``r`` sits where ``np.arange(world)
.reshape(sizes)`` puts ``r``: on ``{"dcn": a, "data": b}`` at ``(r // b,
r % b)``, so a ``"data"`` group is a row of ``b`` ranks and a ``"dcn"``
group a column of ``a``.  A batch sharded over the axes is each rank's
own rows on its own device; a replicated value is the same tensor on
every rank.

A port of the JAX package's ``parallel/mesh.py`` (``use_mesh`` is not
ported; a ``"model"`` axis of tensor parallelism is an axis like any
other, its collectives ``parallel/collectives.py``'s differentiable
ones).  Without an initialized group the default mesh is one rank of one
process.
"""

from __future__ import annotations

import itertools
import math

from typing import Any, Dict, Mapping, Optional, Tuple, Union

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
    "fleet_mesh",
    "local_axis_multiple",
    "local_device_count",
    "local_mesh",
    "mesh_process_count",
    "put_sharded",
    "replicate",
    "shard_batch",
]

DATA_AXIS = "data"

AxisSpec = Union[str, Tuple[str, ...]]


def _axis_tuple(axis: AxisSpec) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """Named axes over ``group`` (None: this process alone).  ``shape``
    maps each axis to its size, as a JAX mesh's ``shape`` does (an int is
    one ``"data"`` axis of that size); ``device`` is the device this rank
    drives (None where none was named).  ``subgroups`` holds, for each
    proper tuple of axes (in mesh order), the group of the ranks that
    share this rank's coordinates on the other axes; the tuple of every
    axis is ``group``."""

    def __init__(self, group, shape, device: Optional[torch.device], *,
                 subgroups: Optional[Dict[Tuple[str, ...], Any]] = None,
                 ranks: Optional[Tuple[int, ...]] = None, lane=None):
        if isinstance(shape, int):
            shape = {DATA_AXIS: shape}
        self.group = group
        self.shape = {str(a): int(n) for a, n in shape.items()}
        self.axis_names = tuple(self.shape)
        self.device = device
        self._subgroups = dict(subgroups or {})
        #: the process group's ranks in mesh order (a fleet of some of
        #: the world's ranks: :func:`fleet_mesh`), None for the whole world
        self.ranks = None if ranks is None else tuple(int(r) for r in ranks)
        self._lane = lane

    @property
    def size(self) -> int:
        """Ranks on the mesh: the product of its axis sizes."""
        return math.prod(self.shape.values())

    def _axes(self, axis: AxisSpec) -> Tuple[str, ...]:
        names = _axis_tuple(axis)
        missing = [a for a in names if a not in self.shape]
        if missing or not names:
            raise ValueError(f"Mesh has no axis {axis!r}; axes: "
                             f"{list(self.shape)}")
        return tuple(a for a in self.axis_names if a in names)

    def axis_group(self, axis: AxisSpec):
        """The process group of ``axis`` (a name or a tuple of names):
        the ranks that share this rank's coordinates on every other axis.
        A tuple of every axis is the mesh's whole group; None without a
        group."""
        axes = self._axes(axis)
        if self.group is None or len(axes) == len(self.axis_names):
            return self.group
        return self._subgroups[axes]

    def axis_size(self, axis: AxisSpec) -> int:
        return math.prod(self.shape[a] for a in self._axes(axis))

    def lane(self) -> "Mesh":
        """A second mesh of the same ranks and axes over groups of its
        own, made once (every rank must call it at the same point: group
        creation is collective).  Collectives on a lane never interleave
        with the mesh's own, so a thread may run them while the caller's
        thread runs collectives on the mesh (``grad_reduce``'s overlap)."""
        if self.group is None:
            return self
        if self._lane is not None:
            return self._lane
        key = tuple(self.shape.items())
        if key not in _LANES:
            _LANES[key] = _new_groups(self.shape)
        world, subgroups = _LANES[key]
        return Mesh(world, self.shape, self.device, subgroups=subgroups)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, group={'yes' if self.group else 'no'}, "
                f"device={self.device})")


def _new_groups(shape: Mapping[str, int], members=None):
    """A new group of the mesh's ranks (``members`` in mesh order, default
    the world's) and, for each proper tuple of axes, the group of this
    rank's coordinates on the others.  Every rank of the world creates
    every group, in the same order (``dist.new_group`` is collective),
    members or not."""
    names = tuple(shape)
    n = math.prod(shape.values())
    ranks = (np.arange(n) if members is None
             else np.asarray(members)).reshape(tuple(shape.values()))
    me = dist.get_rank()
    world = dist.new_group(sorted(int(r) for r in ranks.reshape(-1)))
    subgroups = {}
    for size in range(1, len(names)):
        for axes in itertools.combinations(range(len(names)), size):
            rest = [i for i in range(len(names)) if i not in axes]
            moved = np.moveaxis(ranks, rest, list(range(len(rest))))
            for at in np.ndindex(*[ranks.shape[i] for i in rest]):
                members = sorted(int(r) for r in moved[at].reshape(-1))
                group = dist.new_group(members)
                if me in members:
                    subgroups[tuple(names[i] for i in axes)] = group
    return world, subgroups


def local_device_count() -> int:
    """Devices this process drives: one, since the port runs one rank a
    device (size a rank's batch with it, as the JAX package sizes a
    host's)."""
    return 1


# The groups of meshes of several axes, and of lanes, by axis sizes: made
# once for the life of the process group (distributed.shutdown clears
# both).
_MESHES: Dict[Tuple[Tuple[str, int], ...], dict] = {}
_LANES: Dict[Tuple[Tuple[str, int], ...], tuple] = {}


_FLEETS: Dict[tuple, tuple] = {}


def _forget_groups() -> None:
    _MESHES.clear()
    _LANES.clear()
    _FLEETS.clear()


def fleet_mesh(ranks, shape: Mapping[str, int], device=None) -> Mesh:
    """The mesh of axes ``shape`` over some of the world's ranks
    (``ranks``, ascending, in mesh order): an elastic fleet's
    (:mod:`.elastic`).  Its groups and its lane's are made the first time
    a fleet of these ranks and this shape is asked for, by every rank of
    the world in the same order (group creation is collective over the
    world); a rank outside ``ranks`` gets the mesh without a group.
    Without an initialized process group the mesh only describes the
    fleet (no group: nothing may run collectives on it)."""
    from . import distributed

    ranks = tuple(int(r) for r in ranks)
    shape = {str(a): int(n) for a, n in shape.items()}
    if list(ranks) != sorted(ranks) or len(set(ranks)) != len(ranks):
        raise ValueError(f"a fleet's ranks must ascend, got {ranks}")
    if math.prod(shape.values()) != len(ranks):
        raise ValueError(f"mesh {shape} needs {math.prod(shape.values())} "
                         f"ranks, the fleet has {len(ranks)}")
    if not dist.is_initialized():
        return Mesh(None, shape, None, ranks=ranks)
    if device is None:
        device = distributed.rank_device()
    device = None if device is None else torch.device(device)
    key = (ranks, tuple(shape.items()))
    if key not in _FLEETS:
        _FLEETS[key] = (_new_groups(shape, ranks), _new_groups(shape, ranks))
    (group, sub), (lane_group, lane_sub) = _FLEETS[key]
    if dist.get_rank() not in ranks:
        return Mesh(None, shape, device, ranks=ranks)
    lane = Mesh(lane_group, shape, device, subgroups=lane_sub, ranks=ranks)
    return Mesh(group, shape, device, subgroups=sub, ranks=ranks, lane=lane)


def device_mesh(axis_sizes: Optional[Mapping[str, int]] = None,
                device=None) -> Mesh:
    """The mesh of the initialized process group over ``axis_sizes``
    (default one ``"data"`` axis of the world size; one ``-1`` stands
    for what the others leave), or of this process alone.  The sizes must
    multiply to the world size.  ``device`` is the rank's device (default:
    the one :func:`~flink_ml_tpu_torch.parallel.distributed.initialize`
    was given).  With more than one axis every rank must call it (the
    first call for a shape creates its groups, a collective)."""
    from . import distributed

    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    axis_sizes = dict(axis_sizes or {DATA_AXIS: world})
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("At most one mesh axis may be -1")
    if -1 in sizes:
        known = math.prod(n for n in sizes if n != -1)
        if world % known:
            raise ValueError(f"Cannot infer -1 axis: {world} ranks not "
                             f"divisible by {known}")
        axis_sizes[list(axis_sizes)[sizes.index(-1)]] = world // known
    if math.prod(axis_sizes.values()) != world:
        raise ValueError(f"Mesh {axis_sizes} needs "
                         f"{math.prod(axis_sizes.values())} ranks, the "
                         f"process group has {world}")
    if device is None:
        device = distributed.rank_device()
    device = None if device is None else torch.device(device)
    if group is None or len(axis_sizes) == 1:
        return Mesh(group, axis_sizes, device)
    key = tuple(axis_sizes.items())
    if key not in _MESHES:
        _MESHES[key] = _new_groups(axis_sizes)[1]
    return Mesh(group, axis_sizes, device, subgroups=_MESHES[key])


def local_mesh(axes=(DATA_AXIS,), device=None) -> Mesh:
    """A mesh of this rank alone with ``axes``, each of size one: what a
    fit that runs on one rank's rows reduces over (no collective runs)."""
    return Mesh(None, {a: 1 for a in _axis_tuple(axes)},
                None if device is None else torch.device(device))


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
