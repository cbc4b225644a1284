"""Pipeline parallelism: GPipe-style microbatch scheduling over an axis of
ranks.

The port of the JAX package's ``parallel/pipeline_parallel.py``.  Layer
stages sit one a rank along a ``"pipe"`` axis and microbatches flow around
the ring (:func:`~.collectives.ppermute_ring`).  The JAX package's
``lax.scan`` of ``n_micro + P - 1`` steps is a Python loop of the same
steps here; each step injects the next microbatch at stage 0, writes the
last stage's output where the JAX body does (``torch.where`` on every
rank, never a branch on the rank: every rank takes every ring permute in
the same order, forward and backward) and permutes around the ring.

The backward pipeline is autograd through that loop: the ring permute's
backward rotates each cotangent back to the stage that produced it, and
the final select-and-sum (:func:`~.collectives.sum_over_axis`) passes its
cotangent through unchanged, so each rank's stage gradient is its own and
not P times too large.  Stages must be shape-homogeneous (each maps ``(mb,
d) -> (mb, d)``), the standard condition for ring pipelining.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .collectives import (axis_index, axis_size, copy_to_axis,
                          ppermute_ring, sum_over_axis)
from .mesh import Mesh, _leaves, _tree_map

__all__ = ["PIPE_AXIS", "pipeline_apply", "build_pipeline"]

PIPE_AXIS = "pipe"


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, xs: torch.Tensor, *,
                   axis: str = PIPE_AXIS,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Run a P-stage pipeline over microbatches, on this rank.

    ``stage_params`` is THIS rank's stage parameters, ``xs`` the full
    ``(n_micro, mb, ...)`` microbatch stack (stage 0 reads it; the other
    stages receive activations from their ring predecessor).  Returns the
    ``(n_micro, mb, ...)`` outputs of the LAST stage on every rank of the
    axis (the masked rank-order sum)."""
    n_stages = axis_size(axis, mesh=mesh)
    idx = torch.tensor(axis_index(axis, mesh=mesh), device=xs.device)
    first, last = idx == 0, idx == n_stages - 1
    n_micro = xs.shape[0]
    n_steps = n_micro + n_stages - 1

    act = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
    outs = [torch.zeros_like(xs[0]) for _ in range(n_micro)]
    for t in range(n_steps):
        # Stage 0 injects microbatch t (clamped in the drain phase where no
        # new work enters); later stages consume the ring-permuted
        # activation.
        mb_in = xs[min(max(t, 0), n_micro - 1)]
        inp = torch.where(first, mb_in, act)
        y = stage_fn(stage_params, inp)
        # The last stage finishes microbatch t-(P-1) at step t.
        o = min(max(t - (n_stages - 1), 0), n_micro - 1)
        write = last & (t >= n_stages - 1)
        outs[o] = torch.where(write, y, outs[o])
        act = ppermute_ring(y, axis, mesh=mesh)
    # Only the last stage holds real outputs (everyone else still has the
    # zeros init); the sum both selects them and replicates them across
    # the axis, and its backward hands each rank the cotangent unchanged.
    selected = torch.where(last, torch.stack(outs), 0.0)
    return sum_over_axis(selected, axis, mesh=mesh)


def build_pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   mesh: Mesh, *, n_micro: int, axis: str = PIPE_AXIS,
                   data_axis: Optional[str] = None) -> Callable:
    """Wrap :func:`pipeline_apply` into a batch-level function of this
    rank.

    ``fn(stacked_params, batch) -> out`` where ``stacked_params`` has a
    leading stage dimension of size ``mesh.shape[axis]`` on every leaf (the
    same tree on every rank; each rank runs its own stage's slice) and
    ``batch`` is ``(B, ...)`` with ``B`` divisible by ``n_micro``.  With
    ``data_axis`` the rows stay sharded over it (dp x pp): ``batch`` and
    ``out`` are this rank's rows (its contiguous share of the global batch,
    as from ``mesh.shard_batch``) and the microbatches are cut from them,
    which for a row-wise stage gives the JAX layout's output row for row;
    the stage parameters enter through :func:`~.collectives.copy_to_axis`
    over ``data_axis``, so a rank's gradient of its part of a loss summed
    over the data ranks is the whole gradient (the JAX package's
    parameters are replicated over the data axis)."""
    if axis not in mesh.shape:
        raise ValueError(f"Mesh has no axis {axis!r}; axes: {list(mesh.shape)}")
    n_stages = int(mesh.shape[axis])
    stage = axis_index(axis, mesh=mesh)

    def fn(stacked_params, batch: torch.Tensor) -> torch.Tensor:
        b = batch.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
        leaf = next(iter(_leaves(stacked_params)))
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"params leading dim {leaf.shape[0]} != pipe axis {n_stages}")
        local = _tree_map(lambda a: a[stage], stacked_params)
        if data_axis is not None:
            local = _tree_map(
                lambda a: copy_to_axis(a, data_axis, mesh=mesh), local)
        xs = batch.reshape(n_micro, b // n_micro, *batch.shape[1:])
        out = pipeline_apply(stage_fn, local, xs, axis=axis, mesh=mesh)
        return out.reshape(b, *batch.shape[1:])

    return fn
