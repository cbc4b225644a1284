"""Collectives over the mesh's axes: the vocabulary of the JAX package's
``parallel/collectives.py``, over ``torch.distributed``.

In the JAX package these run inside ``shard_map`` bodies over named mesh
axes; here each rank calls them on its own tensors, and ``axis`` (a name
or a tuple of names) selects the process group of the mesh's axes (the
default mesh's unless ``mesh=`` names one).  A tree of tensors (dict,
list, tuple) goes through leaf by leaf.  Results are new tensors; the
inputs are not written.  Without a group the axis has one member and each
is the identity over it.

The sums take one all-reduce of the group's backend (NCCL on the card,
gloo between CPU processes, or gloo over CUDA tensors for ranks that
share a card): its ring adds each element in one order for a given world
and tensor size and copies the result to every rank, so every rank gets
the same bits and a rerun repeats them.  ``reduce_scatter`` and
``ppermute_ring`` are built from an all-reduce and an all-gather, the
collectives every backend takes.

The compressed all-reduces of ``grad_reduce``: :func:`sparse_all_reduce`
(the all-gather form), :func:`sparse_all_reduce_rd` (recursive
halving/doubling with measured fill-in), :func:`fixed_point_all_reduce`
(exact int32 recursive doubling) and :func:`quantized_all_reduce` (int8
dequantize-then-sum).  Their pairwise rounds run on :func:`ppermute`,
``dist.batch_isend_irecv`` over the axis's group.  gloo sends and
receives host memory only (PyTorch documents its ``send``/``recv`` for
CPU tensors), so for gloo ranks with CUDA tensors a pairwise round goes
through host staging: the message is copied to the host, exchanged, and
the received one copied back (counted in :data:`STAGED`).  NCCL ranks
exchange device memory directly.  A scatter-add that sums several values
into one slot adds them in one fixed order on the card too
(:func:`_add_at_`), so every rank and every rerun gets the same bits.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, AxisSpec, Mesh, _tree_map, default_mesh

__all__ = ["FILL_VEC_LEN", "STAGED", "psum", "psum_packed", "pmean", "pmax",
           "psum_ordered", "all_gather", "reduce_scatter", "ppermute",
           "ppermute_ring", "axis_index", "axis_size", "sparse_all_reduce",
           "sparse_all_reduce_rd", "fixed_point_all_reduce",
           "quantized_all_reduce", "rd_topology", "reset_staged"]

# Fixed layout of the per-call fill-in vector returned by
# :func:`sparse_all_reduce_rd` (the JAX package's): the slot count is
# independent of the participant count (rounds <= FILL_ROUND_SLOTS, hops
# up to 2**16 participants), so reducer state carrying these vectors keeps
# one shape at any fleet size.
FILL_ROUND_SLOTS = 16                           # halving slots [0, 16)
FILL_DOUBLING_BASE = FILL_ROUND_SLOTS           # doubling slots [16, 32)
FILL_UNION_SLOT = 2 * FILL_ROUND_SLOTS          # 32: union |support| count
FILL_SWITCH_SLOT = FILL_UNION_SLOT + 1          # 33: 1.0 if densified
FILL_PREFOLD_SLOT = FILL_SWITCH_SLOT + 1        # 34: entries sent pre-fold
FILL_POSTFOLD_SLOT = FILL_PREFOLD_SLOT + 1      # 35: elements sent post-fold
FILL_VEC_LEN = FILL_POSTFOLD_SLOT + 1           # 36

#: Pairwise rounds that went through host staging (gloo with CUDA
#: tensors): ``rounds`` exchanges, ``bytes`` sent through the host.
STAGED = {"rounds": 0, "bytes": 0}


def reset_staged() -> None:
    STAGED["rounds"] = 0
    STAGED["bytes"] = 0


def _axis_group(axis: AxisSpec, mesh: Optional[Mesh]):
    return (mesh or default_mesh()).axis_group(axis)


def _all_reduce(x: Any, axis: AxisSpec, mesh, op) -> Any:
    group = _axis_group(axis, mesh)

    def one(t):
        out = t.detach().clone().contiguous()
        if group is not None:
            dist.all_reduce(out, op=op, group=group)
        return out

    return _tree_map(one, x)


def psum(x: Any, axis: AxisSpec = DATA_AXIS, *, mesh: Optional[Mesh] = None
         ) -> Any:
    """All-reduce sum over the axis (the centroid and gradient sums that
    replace the reference's keyed reduce and network shuffle)."""
    return _all_reduce(x, axis, mesh, dist.ReduceOp.SUM)


def psum_ordered(x: Any, axis: AxisSpec = DATA_AXIS, *,
                 mesh: Optional[Mesh] = None) -> Any:
    """The sum over the axis as every rank's tensor gathered and added in
    rank order (one all-gather): each element sums in the same order
    whatever the tensor's size and its place in a larger one (a ring
    all-reduce's order depends on both), so a reduce cut into buckets
    gives the bits of the whole, on every rank.  One rank: its tensor's
    bits."""
    group = _axis_group(axis, mesh)

    def one(t):
        parts = _gather(t, group)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out

    return _tree_map(one, x)


def psum_packed(parts, axis: AxisSpec = DATA_AXIS, *,
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


def pmean(x: Any, axis: AxisSpec = DATA_AXIS, *,
          mesh: Optional[Mesh] = None) -> Any:
    n = axis_size(axis, mesh=mesh)
    return _tree_map(lambda t: t / n, psum(x, axis, mesh=mesh))


def pmax(x: Any, axis: AxisSpec = DATA_AXIS, *,
         mesh: Optional[Mesh] = None) -> Any:
    return _all_reduce(x, axis, mesh, dist.ReduceOp.MAX)


def _gather(t: torch.Tensor, group) -> list:
    t = t.detach().contiguous()
    if group is None:
        return [t.clone()]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def all_gather(x: Any, axis: AxisSpec = DATA_AXIS, *, tiled: bool = True,
               mesh: Optional[Mesh] = None) -> Any:
    """Every rank's shard in rank order: concatenated along the leading
    dim (``tiled``) or stacked on a new leading axis."""
    group = _axis_group(axis, mesh)
    join = torch.cat if tiled else torch.stack
    return _tree_map(lambda t: join(_gather(t, group)), x)


def reduce_scatter(x: Any, axis: AxisSpec = DATA_AXIS, *,
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


def axis_index(axis: AxisSpec = DATA_AXIS, *, mesh: Optional[Mesh] = None
               ) -> int:
    """This rank's position on the axis."""
    group = _axis_group(axis, mesh)
    return 0 if group is None else dist.get_rank(group)


def axis_size(axis: AxisSpec = DATA_AXIS, *, mesh: Optional[Mesh] = None
              ) -> int:
    """The axis size: the group's world size."""
    group = _axis_group(axis, mesh)
    return 1 if group is None else dist.get_world_size(group)


def ppermute_ring(x: Any, axis: AxisSpec = DATA_AXIS, *, shift: int = 1,
                  mesh: Optional[Mesh] = None) -> Any:
    """Rotate shards around the ring of the axis: rank ``i`` receives rank
    ``(i - shift) % size``'s shard (the KV rotation of ring attention)."""
    group = _axis_group(axis, mesh)
    n = axis_size(axis, mesh=mesh)
    src = (axis_index(axis, mesh=mesh) - shift) % n
    return _tree_map(lambda t: _gather(t, group)[src], x)


# ---------------------------------------------------------------------------
# pairwise exchanges and the compressed all-reduces of grad_reduce
# ---------------------------------------------------------------------------


def _global_rank(group, r: int) -> int:
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _staged(group, t: torch.Tensor) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def ppermute(x: Any, axis: AxisSpec, perm: Sequence[Tuple[int, int]], *,
             mesh: Optional[Mesh] = None) -> Any:
    """``lax.ppermute`` over the axis: for each ``(src, dst)`` of ``perm``
    (axis positions) rank ``dst`` receives rank ``src``'s tensor; a rank
    that receives nothing gets zeros.  One ``batch_isend_irecv`` a rank
    (its sends and its receive together); gloo ranks with CUDA tensors
    stage the messages through the host (:data:`STAGED`)."""
    group = _axis_group(axis, mesh)
    me = 0 if group is None else dist.get_rank(group)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]

    def one(t):
        t = t.detach().contiguous()
        if group is None:
            return t.clone() if (0, 0) in perm else torch.zeros_like(t)
        peers_out = [d for d in dsts if d != me]
        peers_in = [s for s in srcs if s != me]
        own = t.clone() if me in srcs else torch.zeros_like(t)
        if not (peers_out or peers_in):
            return own
        staged = _staged(group, t)
        send = t.cpu() if staged else t
        recv = torch.zeros_like(send)
        ops = [dist.P2POp(dist.isend, send, _global_rank(group, d), group)
               for d in peers_out]
        ops += [dist.P2POp(dist.irecv, recv, _global_rank(group, s), group)
                for s in peers_in]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            STAGED["rounds"] += 1
            STAGED["bytes"] += (send.numel() * send.element_size()
                                * len(peers_out))
        return recv.to(t.device) if peers_in else own

    return _tree_map(one, x)


def _add_at_(t: torch.Tensor, idx: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """``t[idx] += vals`` in place, repeated indices summed in the order
    they come: on the card the sort-based accumulation of
    ``index_put_(accumulate=True)`` (``index_add_`` adds with atomics in
    no fixed order there), on the CPU ``index_add_``'s serial loop.
    ``idx`` must lie in range."""
    if t.is_cuda:
        return torch.ops.aten._index_put_impl_(t, [idx.long()], vals,
                                               True, True)
    return t.index_add_(0, idx.long(), vals)


def _add_valid_at_(t: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """:func:`_add_at_` of the ``valid`` entries only, with no host read:
    each invalid entry goes to a slot of its own (its position modulo
    ``len(t)``) carrying ``-0.0``, which adds nothing to any value, so no
    long run of one repeated index is summed serially on the card."""
    spread = torch.arange(idx.numel(), device=idx.device) % t.numel()
    return _add_at_(t, torch.where(valid, idx.long(), spread),
                    torch.where(valid, vals, -0.0))


def _pack(idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(int32 indices, f32 values) as one int32 message."""
    return torch.cat([idx.to(torch.int32),
                      vals.to(torch.float32).view(torch.int32)])


def _unpack(msg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    k = msg.numel() // 2
    return msg[:k], msg[k:].view(torch.float32)


def sparse_all_reduce(idx: torch.Tensor, vals: torch.Tensor, n: int,
                      axes: AxisSpec, *, mesh: Optional[Mesh] = None
                      ) -> torch.Tensor:
    """All-gather form of a sparse all-reduce over one flat length-``n``
    segment: each rank contributes ``k`` (index, value) pairs, every rank
    gathers all of them (one all-gather of the packed pairs) and
    scatter-adds them locally, rank after rank in axis order (the JAX
    package's gather order).  Indices outside ``[0, n)`` are dropped."""
    group = _axis_group(axes, mesh)
    ok = (idx >= 0) & (idx < n)
    msg = _pack(torch.where(ok, idx, n), torch.where(ok, vals, 0.0))
    parts = _gather(msg, group)
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    for part in parts:
        i, v = _unpack(part)
        _add_valid_at_(out, i, v.to(vals.dtype), i < n)
    return out


def rd_topology(p: int) -> Tuple[int, int, int]:
    """``(core, rounds, extras)`` of the recursive-halving/doubling
    schedule over ``p`` participants: a ``core = 2**floor(log2 p)`` rank
    group runs the log2 rounds; the ``extras = p - core`` leftover ranks
    fold their contribution in before round one and receive the result
    after the last round."""
    if p < 1:
        raise ValueError(f"participant count must be >= 1, got {p}")
    core = 1 << (p.bit_length() - 1)
    rounds = core.bit_length() - 1
    if rounds > FILL_ROUND_SLOTS:
        raise ValueError(
            f"hop of {p} participants needs {rounds} rounds; the fill "
            f"accounting layout caps at {FILL_ROUND_SLOTS}")
    return core, rounds, p - core


def _merge_dedup(idx_a: torch.Tensor, val_a: torch.Tensor,
                 idx_b: torch.Tensor, val_b: torch.Tensor,
                 sentinel: int, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Union two (idx, val) sets, summing values at duplicate indices.
    Invalid entries carry ``idx == sentinel`` (> every real index) and
    ``val == 0``; the output is sorted by index (a stable sort, so
    duplicates add in input order), compacted to the front,
    sentinel-padded, and sliced to ``cap``."""
    idx = torch.cat([idx_a, idx_b])
    val = torch.cat([val_a, val_b])
    if idx.numel() == 0:
        return idx[:cap], val[:cap]
    idx, order = torch.sort(idx, stable=True)
    val = val[order]
    first = torch.ones_like(idx, dtype=torch.bool)
    first[1:] = idx[1:] != idx[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    m = idx.numel()
    # the sentinel entries (one segment, all 0) are spread, not summed
    out_val = _add_valid_at_(
        torch.zeros(m, dtype=val.dtype, device=val.device), seg, val,
        idx != sentinel)
    # every entry of a segment carries the segment's index: any write wins
    out_idx = torch.full((m,), sentinel, dtype=idx.dtype, device=idx.device)
    out_idx.scatter_(0, seg, idx)
    return out_idx[:cap], out_val[:cap]


def _exchange(idx, vals, axis, perm, mesh):
    """One pairwise round of (index, value) sets: one packed message."""
    return _unpack(ppermute(_pack(idx, vals), axis, perm, mesh=mesh))


def sparse_all_reduce_rd(idx: torch.Tensor, vals: torch.Tensor, n: int,
                         axis: str,
                         uniform_axes: Optional[Tuple[str, ...]] = None, *,
                         mesh: Optional[Mesh] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recursive-halving/doubling sparse all-reduce over ONE named axis
    (SparCML's split-allreduce, arXiv:1802.08021), the JAX package's
    protocol round for round: log2(P) halving rounds of pairwise exchanges
    route each (index, value) set toward the rank that owns its index
    range, merging partner sets with duplicate-index summation at every
    hop; then log2(P) doubling rounds gather the reduced pieces back.
    The sets keep the JAX package's fixed capacities (sentinel-padded), so
    the fill-in counts are the protocol's.  When the summed union count
    densifies past break-even (``2*|union| > n_pad``) the doubling phase
    exchanges dense blocks instead.  The switchover flag is read on the
    host (one scalar a call, after the union's all-reduce): every rank
    reads the same bits, so every rank runs the same exchanges.
    ``uniform_axes`` (every axis whose ranks run this reduce at once)
    takes the union's max over the other axes first, so sibling groups
    switch together, as in the JAX package.  Non-power-of-two P runs a
    ``2**floor(log2 P)`` core with pre/post folding (:func:`rd_topology`).

    The contract of :func:`sparse_all_reduce`: ``0 <= idx < n``
    (duplicates within a contribution sum; entries out of range are
    dropped); the f32 sum is in tree order, not gather order.  Returns
    ``(dense_result (n,), fill (FILL_VEC_LEN,) f32)``."""
    mesh = mesh or default_mesh()
    p = axis_size(axis, mesh=mesh)
    k = int(idx.shape[0])
    dev, dtype = vals.device, vals.dtype
    fill = torch.zeros(FILL_VEC_LEN, dtype=torch.float32, device=dev)
    if p == 1 or k == 0:
        dense = torch.zeros(n, dtype=dtype, device=dev)
        _add_valid_at_(dense, idx, vals, (idx >= 0) & (idx < n))
        return dense, fill
    core, rounds, extras = rd_topology(p)
    n_pad = -(-n // core) * core
    sentinel = n_pad
    rank = axis_index(axis, mesh=mesh)
    is_core = rank < core

    def pad_i(m):
        return torch.full((m,), sentinel, dtype=torch.int32, device=dev)

    def pad_v(m):
        return torch.zeros(m, dtype=dtype, device=dev)

    ok = (idx >= 0) & (idx < n)
    cur_i = torch.where(ok, idx.to(torch.int32), sentinel).to(torch.int32)
    cur_v = torch.where(ok, vals, 0.0).to(dtype)
    # dedup within this rank's own contribution (also compacts)
    cur_i, cur_v = _merge_dedup(cur_i, cur_v, pad_i(0), pad_v(0),
                                sentinel, k)
    cnt = (cur_i < sentinel).sum()
    cap = k

    # -- pre-fold: extras hand their set to rank (self - core) ------------
    if extras:
        perm = [(core + i, i) for i in range(extras)]
        msg = torch.cat([_pack(cur_i, cur_v),
                         cnt.to(torch.int32).reshape(1)])
        got = ppermute(msg, axis, perm, mesh=mesh)
        r_i, r_v = _unpack(got[:-1])
        valid = torch.arange(k, device=dev) < got[-1]   # non-receivers: 0
        r_i = torch.where(valid, r_i, sentinel).to(torch.int32)
        r_v = torch.where(valid, r_v, 0.0)
        if is_core:
            cur_i, cur_v = _merge_dedup(cur_i, cur_v, r_i, r_v, sentinel,
                                        2 * k)
        else:
            fill[FILL_PREFOLD_SLOT] = cnt.to(torch.float32)
            cur_i, cur_v = pad_i(2 * k), pad_v(2 * k)
        cap = 2 * k

    # -- recursive halving: route entries to their range owner ------------
    lo, width = 0, n_pad
    for r in range(rounds):
        step = core >> (r + 1)
        half = width // 2
        mid = lo + half
        cap_next = min(2 * cap, half)
        if is_core:
            bit = (rank >> (rounds - 1 - r)) & 1
            send_mask = cur_i >= mid if bit == 0 else cur_i < mid
            sent = (send_mask & (cur_i < sentinel)).sum()
            r_i, r_v = _exchange(torch.where(send_mask, cur_i, sentinel),
                                 torch.where(send_mask, cur_v, 0.0), axis,
                                 [(i, i ^ step) for i in range(core)],
                                 mesh)
            cur_i, cur_v = _merge_dedup(
                torch.where(send_mask, sentinel, cur_i).to(torch.int32),
                torch.where(send_mask, 0.0, cur_v), r_i, r_v, sentinel,
                cap_next)
            lo = lo if bit == 0 else mid
            fill[r] = sent.to(torch.float32)
        cap = cap_next
        width = half

    # -- measured fill-in decides the doubling wire format ----------------
    cnt = (cur_i < sentinel).sum() if is_core else \
        torch.zeros((), dtype=torch.int64, device=dev)
    union = psum(cnt.to(torch.int64), axis, mesh=mesh)
    stat = union
    siblings = tuple(a for a in (uniform_axes or ()) if a != axis)
    if siblings:
        stat = pmax(stat, siblings, mesh=mesh)
    switched = bool(2 * int(stat) > n_pad)   # the one host read
    w = n_pad // core
    d = torch.zeros(rounds, dtype=torch.float32, device=dev)
    if is_core and switched:
        dense = _add_valid_at_(pad_v(n_pad), cur_i, cur_v,
                               cur_i < sentinel)
        for j in range(rounds):
            step, size = 1 << j, w << j
            start = ((rank >> j) << j) * w
            recv = ppermute(dense[start:start + size], axis,
                            [(i, i ^ step) for i in range(core)], mesh=mesh)
            at = (((rank ^ step) >> j) << j) * w
            dense[at:at + size] = recv
            d[j] = float(size)
    elif is_core:
        ci, cv = cur_i, cur_v
        for j in range(rounds):
            d[j] = (ci < sentinel).sum().to(torch.float32)
            r_i, r_v = _exchange(ci, cv, axis,
                                 [(i, i ^ (1 << j)) for i in range(core)],
                                 mesh)
            # partner ranges are disjoint from mine: concat, no dedup
            ci, cv = torch.cat([ci, r_i]), torch.cat([cv, r_v])
        dense = _add_valid_at_(pad_v(n_pad), ci, cv, ci < sentinel)
    else:
        dense = pad_v(n_pad)
    if is_core:
        fill[FILL_DOUBLING_BASE:FILL_DOUBLING_BASE + rounds] = d
    fill[FILL_UNION_SLOT] = union.to(torch.float32)
    fill[FILL_SWITCH_SLOT] = float(switched)

    # -- post-fold: result back out to the extras -------------------------
    if extras:
        recv = ppermute(dense, axis, [(i, core + i) for i in range(extras)],
                        mesh=mesh)
        if not is_core:
            dense = recv
        if rank < extras:
            fill[FILL_POSTFOLD_SLOT] = float(n_pad)
    return dense[:n], fill


def fixed_point_all_reduce(q: torch.Tensor, axis: str, *,
                           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Exact int32 all-reduce by recursive doubling over ONE named axis:
    log2(P) pairwise exchanges, each hop adding integer payloads
    (SwitchML's in-fabric pool, arXiv:1903.06701), so the total is the
    same bits on every rank (integer addition is associative).
    Non-power-of-two P folds the extras in before round one and hands the
    total back after the last round."""
    mesh = mesh or default_mesh()
    p = axis_size(axis, mesh=mesh)
    if p == 1:
        return q
    core, rounds, extras = rd_topology(p)
    rank = axis_index(axis, mesh=mesh)
    if extras:
        q = q + ppermute(q, axis, [(core + i, i) for i in range(extras)],
                         mesh=mesh)
    if rank < core:
        for j in range(rounds):
            q = q + ppermute(q, axis,
                             [(i, i ^ (1 << j)) for i in range(core)],
                             mesh=mesh)
    if extras:
        recv = ppermute(q, axis, [(i, core + i) for i in range(extras)],
                        mesh=mesh)
        if rank >= core:
            q = recv
    return q


def quantized_all_reduce(q: torch.Tensor, scale: torch.Tensor,
                         axes: AxisSpec, *, mesh: Optional[Mesh] = None
                         ) -> torch.Tensor:
    """Dequantize-and-sum all-reduce of one block-quantized segment: the
    ``q`` (nb, block) int8 payloads and ``scale`` (nb, 1) f32 per-block
    scales are all-gathered, and each rank sums ``q * scale`` rank after
    rank (the JAX package's ``int8_accum="dequant"``: one stochastic
    rounding per participant meets the others in f32)."""
    group = _axis_group(axes, mesh)
    qs, ss = _gather(q, group), _gather(scale, group)
    total = qs[0].to(torch.float32) * ss[0]
    for qp, sp in zip(qs[1:], ss[1:]):
        total = total + qp.to(torch.float32) * sp
    return total
