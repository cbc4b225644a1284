"""Ring attention: sequence (context) parallelism over a ring of ranks.

The port of the JAX package's ``parallel/ring_attention.py``.  Each rank
holds one block of the sequence of Q, K and V (layout ``(batch, seq,
heads, head_dim)``, the sequence sharded over ``axis``); Q stays put while
the K/V blocks rotate ``size - 1`` times around the ring
(:func:`~.collectives.ppermute_ring`, which autograd differentiates), each
block merged into the running numerator, max and denominator by online
softmax, so a rank holds O(seq / size) of the sequence and the full score
matrix never exists.  :func:`ulysses_attention` (``ulysses.py``) is the
all-to-all alternative.

The scores are ``torch.einsum`` products and softmax sums, as the JAX
package computes them (outside any Pallas kernel); the expressions are the
JAX package's as written: a fully masked row's max is taken as 0, the
merge rescales through ``(b, h, s) -> (b, s, h)`` transposes, and the
final denominator is floored at 1e-20.  :func:`attention_reference` is the
dense oracle the parity tests read.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .collectives import all_gather, axis_index, axis_size, ppermute_ring
from .mesh import Mesh

__all__ = ["ring_attention", "attention_reference"]


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        scale: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Dense full attention, the correctness oracle of the parallel
    schemes.  Shapes ``(b, s, h, d)``.  ``q_offset`` (the port's
    addition; 0 is the JAX function) is the position of ``q``'s first row
    in the sequence ``k`` spans, so a long sequence's causal oracle can be
    taken one query block at a time: row ``i`` sees keys ``<= q_offset +
    i``."""
    b, s_q, h, d = q.shape
    scale = scale or (1.0 / np.sqrt(d))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = torch.tril(torch.ones((s_q, k.shape[1]), dtype=torch.bool,
                                     device=q.device), diagonal=q_offset)
        scores = torch.where(mask[None, None], scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _block_attend(q, k, v, q_offset, k_offset, scale, causal):
    """Scores of a local Q block against one K/V block with running-softmax
    stats.  Returns (numerator, running max, running denom)."""
    s_q, s_k = q.shape[1], k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale      # (b,h,sq,sk)
    if causal:
        q_idx = q_offset + torch.arange(s_q, device=q.device)[:, None]
        k_idx = k_offset + torch.arange(s_k, device=q.device)[None, :]
        scores = torch.where((k_idx <= q_idx)[None, None], scores,
                             -torch.inf)
    block_max = torch.amax(scores, dim=-1)                      # (b,h,sq)
    # guard fully-masked rows (all -inf) -> exp(0)=..0 contribution
    safe_max = torch.where(torch.isfinite(block_max), block_max, 0.0)
    probs = torch.exp(scores - safe_max[..., None])
    probs = torch.where(torch.isfinite(scores), probs, 0.0)
    numer = torch.einsum("bhqk,bkhd->bqhd", probs, v)           # (b,sq,h,d)
    denom = torch.sum(probs, dim=-1)                            # (b,h,sq)
    return numer, safe_max, denom


def _online_merge(acc, update):
    """Merge two (numer, max, denom) softmax partials."""
    n1, m1, d1 = acc
    n2, m2, d2 = update
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    numer = n1 * a1.permute(0, 2, 1)[..., None] \
        + n2 * a2.permute(0, 2, 1)[..., None]
    denom = d1 * a1 + d2 * a2
    return numer, m, denom


def _equal_blocks(x: torch.Tensor, axis: str, mesh: Optional[Mesh],
                  message: str) -> None:
    """Raise ``ValueError(message.format(total=, n=))`` on every rank where
    the ranks' sequence blocks (dim 1) differ in length: the global
    sequence did not divide over the axis (one all-gather of the block
    length)."""
    n = axis_size(axis, mesh=mesh)
    lens = all_gather(torch.tensor([x.shape[1]], device=x.device), axis,
                      mesh=mesh)
    if bool((lens != lens[0]).any()):
        raise ValueError(message.format(total=int(lens.sum()), n=n))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Optional[Mesh] = None, axis: str = "seq",
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis``, on this
    rank's blocks ``(b, s / size, h, d)`` of Q, K and V (rank ``i`` holds
    positions ``[i * block, (i + 1) * block)``); returns this rank's block
    of the output.

    The local block first, then K/V rotated ``size - 1`` times to the right
    neighbour while Q stays resident, each block merged by online softmax:
    the classic ring schedule (Liu et al., Ring Attention).  Every rank
    runs the same ring permutes in the same order, forward and backward.
    Raises ``ValueError`` on every rank where the sequence does not divide
    over the axis (the ranks' blocks differ in length)."""
    d = q.shape[-1]
    scale = scale or (1.0 / np.sqrt(d))
    if mesh is not None and axis not in mesh.shape:
        raise ValueError(f"Mesh has no axis {axis!r}; axes: "
                         f"{list(mesh.shape)}")
    n = axis_size(axis, mesh=mesh)
    _equal_blocks(q, axis, mesh,
                  "seq len {total} not divisible by ring size {n}")
    block = q.shape[1]
    idx = axis_index(axis, mesh=mesh)
    q_off = idx * block
    # Start with the local block, then rotate k/v (n-1) times.
    numer, m, denom = _block_attend(q, k, v, q_off, idx * block, scale,
                                    causal)
    k_cur, v_cur = k, v
    for i in range(n - 1):
        k_cur = ppermute_ring(k_cur, axis, mesh=mesh)
        v_cur = ppermute_ring(v_cur, axis, mesh=mesh)
        # after i+1 rotations this rank holds the block originally at ring
        # position (idx - i - 1) mod n
        src = (idx - i - 1) % n
        upd = _block_attend(q, k_cur, v_cur, q_off, src * block, scale,
                            causal)
        numer, m, denom = _online_merge((numer, m, denom), upd)
    denom = torch.clamp(denom, min=1e-20)
    return numer / denom.permute(0, 2, 1)[..., None]
