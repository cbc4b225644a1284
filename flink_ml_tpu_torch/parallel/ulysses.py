"""Ulysses-style sequence parallelism: an all-to-all head/sequence
re-shard.

The port of the JAX package's ``parallel/ulysses.py``.  Complementary to
ring attention: instead of rotating K/V, one all-to-all
(:func:`~.collectives.all_to_all`, which autograd differentiates) turns
each rank's sequence block of every head into the full sequence of its
share of the heads, dense local attention (:func:`attention_reference`)
runs over the full sequence for those heads, and a second all-to-all
restores sequence sharding: two exchanges instead of ``size - 1`` ring
steps, when the heads divide over the axis."""

from __future__ import annotations

from typing import Optional

import torch

from .collectives import all_to_all, axis_size
from .mesh import Mesh
from .ring_attention import _equal_blocks, attention_reference

__all__ = ["ulysses_attention"]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh: Optional[Mesh] = None, axis: str = "seq",
                      causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis``, on this
    rank's blocks ``(b, s / size, h, d)``; returns this rank's block of the
    output.  The heads must divide over the axis, and so must the
    sequence (the ranks' blocks equal): each raises ``ValueError``, the
    second on every rank.  On a mesh of several axes the exchanges run
    over ``axis``'s group alone (the other axes' ranks hold other rows)."""
    if mesh is not None and axis not in mesh.shape:
        raise ValueError(f"Mesh has no axis {axis!r}; axes: "
                         f"{list(mesh.shape)}")
    n = axis_size(axis, mesh=mesh)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"heads {h} not divisible by axis size {n}")
    _equal_blocks(q, axis, mesh, "seq {total} not divisible by axis size {n}")

    # (b, s/n, h, d) -> (b, s, h/n, d): gather sequence, scatter heads
    def seq_to_heads(x):
        return all_to_all(x, axis, split_axis=2, concat_axis=1, mesh=mesh)

    def heads_to_seq(x):
        return all_to_all(x, axis, split_axis=1, concat_axis=2, mesh=mesh)

    out = attention_reference(seq_to_heads(q), seq_to_heads(k),
                              seq_to_heads(v), causal=causal, scale=scale)
    return heads_to_seq(out)
