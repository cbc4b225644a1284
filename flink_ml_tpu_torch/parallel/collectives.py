"""Collectives over the data axis: the dense vocabulary of the JAX
package's ``parallel/collectives.py``, over ``torch.distributed``.

In the JAX package these run inside ``shard_map`` bodies over a mesh
axis; here each rank calls them on its own tensors, and the axis is the
mesh's process group (the default mesh's unless ``mesh=`` names one).  A
tree of tensors (dict, list, tuple) goes through leaf by leaf.  Results
are new tensors; the inputs are not written.  Without a group the axis
has one member and each is the identity over it.

The sums take one all-reduce of the group's backend (NCCL on the card,
gloo between CPU processes, or gloo over CUDA tensors for ranks that
share a card): its ring adds each element in one order for a given world
and tensor size and copies the result to every rank, so every rank gets
the same bits and a rerun repeats them.  ``reduce_scatter`` and
``ppermute_ring`` are built from an all-reduce and an all-gather, the
collectives every backend takes, rather than from point-to-point sends.

The sparse, fixed-point and quantized all-reduces of the JAX module serve
``grad_reduce.py`` and are not ported (ROADMAP A10).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, Mesh, _tree_map, default_mesh

__all__ = ["psum", "psum_packed", "pmean", "pmax", "all_gather",
           "reduce_scatter", "ppermute_ring", "axis_index", "axis_size"]


def _axis_group(axis: str, mesh: Optional[Mesh]):
    mesh = mesh or default_mesh()
    if axis not in mesh.shape:
        raise ValueError(f"Mesh has no axis {axis!r}; axes: "
                         f"{list(mesh.shape)}")
    return mesh.group


def _all_reduce(x: Any, axis: str, mesh, op) -> Any:
    group = _axis_group(axis, mesh)

    def one(t):
        out = t.detach().clone().contiguous()
        if group is not None:
            dist.all_reduce(out, op=op, group=group)
        return out

    return _tree_map(one, x)


def psum(x: Any, axis: str = DATA_AXIS, *, mesh: Optional[Mesh] = None
         ) -> Any:
    """All-reduce sum over the axis (the centroid and gradient sums that
    replace the reference's keyed reduce and network shuffle)."""
    return _all_reduce(x, axis, mesh, dist.ReduceOp.SUM)


def psum_packed(parts, axis: str = DATA_AXIS, *,
                mesh: Optional[Mesh] = None) -> tuple:
    """The tensors of ``parts`` summed over the axis with one all-reduce:
    packed into one f32 buffer, then split back into their shapes and
    types (a round's ``(sums, counts)`` in one collective, not two)."""
    flat = psum(torch.cat([p.reshape(-1).to(torch.float32) for p in parts]),
                axis, mesh=mesh)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape).to(p.dtype))
        at += p.numel()
    return tuple(out)


def pmean(x: Any, axis: str = DATA_AXIS, *, mesh: Optional[Mesh] = None
          ) -> Any:
    n = axis_size(axis, mesh=mesh)
    return _tree_map(lambda t: t / n, psum(x, axis, mesh=mesh))


def pmax(x: Any, axis: str = DATA_AXIS, *, mesh: Optional[Mesh] = None
         ) -> Any:
    return _all_reduce(x, axis, mesh, dist.ReduceOp.MAX)


def _gather(t: torch.Tensor, group) -> list:
    t = t.detach().contiguous()
    if group is None:
        return [t.clone()]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def all_gather(x: Any, axis: str = DATA_AXIS, *, tiled: bool = True,
               mesh: Optional[Mesh] = None) -> Any:
    """Every rank's shard in rank order: concatenated along the leading
    dim (``tiled``) or stacked on a new leading axis."""
    group = _axis_group(axis, mesh)
    join = torch.cat if tiled else torch.stack
    return _tree_map(lambda t: join(_gather(t, group)), x)


def reduce_scatter(x: Any, axis: str = DATA_AXIS, *,
                   scatter_dimension: int = 0,
                   mesh: Optional[Mesh] = None) -> Any:
    """The sum over the axis, of which this rank keeps its block along
    ``scatter_dimension`` (block ``rank`` of ``size`` equal blocks)."""
    n = axis_size(axis, mesh=mesh)
    i = axis_index(axis, mesh=mesh)

    def mine(t):
        if t.shape[scatter_dimension] % n:
            raise ValueError(
                f"reduce_scatter: dim {scatter_dimension} of size "
                f"{t.shape[scatter_dimension]} does not split over {n}")
        return t.chunk(n, dim=scatter_dimension)[i].contiguous()

    return _tree_map(mine, psum(x, axis, mesh=mesh))


def axis_index(axis: str = DATA_AXIS, *, mesh: Optional[Mesh] = None
               ) -> int:
    """This rank's position on the axis."""
    group = _axis_group(axis, mesh)
    return 0 if group is None else dist.get_rank(group)


def axis_size(axis: str = DATA_AXIS, *, mesh: Optional[Mesh] = None
              ) -> int:
    """The axis size: the group's world size."""
    group = _axis_group(axis, mesh)
    return 1 if group is None else dist.get_world_size(group)


def ppermute_ring(x: Any, axis: str = DATA_AXIS, *, shift: int = 1,
                  mesh: Optional[Mesh] = None) -> Any:
    """Rotate shards around the ring of the axis: rank ``i`` receives rank
    ``(i - shift) % size``'s shard (the KV rotation of ring attention)."""
    group = _axis_group(axis, mesh)
    n = axis_size(axis, mesh=mesh)
    src = (axis_index(axis, mesh=mesh) - shift) % n
    return _tree_map(lambda t: _gather(t, group)[src], x)
