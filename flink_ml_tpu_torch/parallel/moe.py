"""Expert parallelism: a routed mixture-of-experts FFN over an ``"expert"``
axis of ranks.

The port of the JAX package's ``parallel/moe.py`` (the GShard / Mesh-TF
recipe): routing is two einsums against a dense 0/1 dispatch tensor
``(groups, tokens, experts, capacity)``, every shape static, and tokens
past an expert's capacity drop (their combine weight is 0), so no shape
depends on the routing.  The router runs in f32 whatever ``x``'s dtype
(a bf16 cumsum is inexact past 256 and would collide queue positions), a
token's place in its expert's queue comes from a cumsum, ``argmax`` ties
go to the first expert (as ``jnp.argmax``'s do) and the FFN's GELU is the
tanh approximation (``jax.nn.gelu``'s default).

Over ranks (``mesh=``): in the JAX layout the tokens are sharded over
``data_axis`` and replicated over ``expert_axis``, the dispatched buffers
are sharded over ``expert_axis`` and the result over ``data_axis``; GSPMD
inserts the all-to-all between the first two.  The port states its
collectives: each rank routes its own tokens (every expert rank of a data
row holds the same tokens, so the dispatch needs no exchange), runs its
own slice of the experts (:func:`moe_sharding`) on its slice of the
dispatched buffers, and combines them into a partial output that one
rank-order sum over ``expert_axis`` completes
(:func:`~.collectives.sum_over_axis`).  An all-to-all of the dispatched
buffers would only move tokens the expert ranks already hold; the sum
moves one ``(tokens, d_model)`` partial a rank, and since each token
routes to one expert and one slot, every output element is one nonzero
term plus zeros: exact in any order, in bf16 too.  A routing group that
spans data ranks (``group_size`` larger than a rank's tokens, e.g. the
default of one group) is routed whole: the ranks of the data axis gather
its tokens (:func:`~.collectives.gather_axis`) and each keeps its own rows
of the output.
"""

from __future__ import annotations

import math

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .collectives import axis_index, axis_size, gather_axis, sum_over_axis
from .mesh import Mesh

__all__ = ["EXPERT_AXIS", "MoEParams", "init_moe", "moe_apply",
           "moe_sharding", "shard_moe"]

EXPERT_AXIS = "expert"


class MoEParams(NamedTuple):
    wg: torch.Tensor     # (d_model, n_experts) router
    w_in: torch.Tensor   # (n_experts, d_model, d_hidden)
    w_out: torch.Tensor  # (n_experts, d_hidden, d_model)


def init_moe(rng: np.random.Generator, d_model: int, d_hidden: int,
             n_experts: int, device="cpu") -> MoEParams:
    """The JAX package's draws, in its order, from the same generator, as
    f32 tensors on ``device``."""
    scale_in = 1.0 / math.sqrt(d_model)
    scale_out = 1.0 / math.sqrt(d_hidden)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return MoEParams(
        wg=put(rng.normal(size=(d_model, n_experts)) * scale_in),
        w_in=put(rng.normal(size=(n_experts, d_model, d_hidden))
                 * scale_in),
        w_out=put(rng.normal(size=(n_experts, d_hidden, d_model))
                  * scale_out),
    )


def moe_sharding(mesh: Mesh, *, expert_axis: str = EXPERT_AXIS
                 ) -> MoEParams:
    """Each leaf's placement over ``expert_axis``, the counterpart of the
    JAX package's ``NamedSharding``s, as the dimension it splits (None:
    replicated; ``widedeep.param_spec``'s convention): the router
    replicated, ``w_in`` and ``w_out`` split on dim 0, one expert group a
    rank along the axis (:func:`shard_moe` cuts a rank's)."""
    if expert_axis not in mesh.shape:
        raise ValueError(f"Mesh has no axis {expert_axis!r}; axes: "
                         f"{list(mesh.shape)}")
    return MoEParams(wg=None, w_in=0, w_out=0)


def _expert_slice(n_experts: int, size: int, at: int) -> slice:
    if n_experts % size:
        raise ValueError(f"{n_experts} experts do not split over an expert "
                         f"axis of size {size}")
    per = n_experts // size
    return slice(at * per, (at + 1) * per)


def shard_moe(params: MoEParams, mesh: Mesh, *,
              expert_axis: str = EXPERT_AXIS) -> MoEParams:
    """This rank's leaves of the full ``params`` under
    :func:`moe_sharding`: the router whole and its expert group of
    ``w_in`` / ``w_out`` (the experts must divide over the axis)."""
    moe_sharding(mesh, expert_axis=expert_axis)
    sl = _expert_slice(params.wg.shape[1], int(mesh.shape[expert_axis]),
                       axis_index(expert_axis, mesh=mesh))
    return MoEParams(wg=params.wg, w_in=params.w_in[sl],
                     w_out=params.w_out[sl])


def moe_apply(params: MoEParams, x: torch.Tensor, *,
              capacity_factor: float = 1.25,
              group_size: Optional[int] = None,
              mesh: Optional[Mesh] = None,
              expert_axis: str = EXPERT_AXIS,
              data_axis: Optional[str] = None) -> torch.Tensor:
    """Top-1 routed MoE FFN: ``(tokens, d_model) -> (tokens, d_model)``.

    ``mesh=None`` is the one-device path over all of ``x`` (the oracle).
    With ``mesh``, this rank's part: ``x`` is its rows (its share of the
    global tokens over ``data_axis``, or all of them where ``data_axis`` is
    None) and the result its rows of the output; ``params`` are the full
    parameters or this rank's shard (:func:`shard_moe`; the router is
    always whole, so its width is the expert count).

    ``group_size`` (of the global tokens) bounds the dispatch and combine
    tensors: routing happens independently within fixed-size token groups
    (the GShard group dim), so dispatch memory is O(T * group_size *
    capacity_factor) instead of O(capacity_factor * T^2)."""
    n_experts = params.wg.shape[1]
    if mesh is not None:
        if expert_axis not in mesh.shape:
            raise ValueError(f"Mesh has no axis {expert_axis!r}; axes: "
                             f"{list(mesh.shape)}")
        n_ep = axis_size(expert_axis, mesh=mesh)
        n_data = axis_size(data_axis, mesh=mesh) if data_axis else 1
        mine = _expert_slice(n_experts, n_ep,
                             axis_index(expert_axis, mesh=mesh))
    else:
        n_ep, n_data, mine = 1, 1, slice(0, n_experts)
    w_in, w_out = params.w_in, params.w_out
    if w_in.shape[0] == n_experts and n_ep > 1:
        w_in, w_out = w_in[mine], w_out[mine]

    n_local, d_model = x.shape
    n_tokens = n_local * n_data
    size = group_size or n_tokens
    if n_tokens % size:
        raise ValueError(
            f"tokens {n_tokens} not divisible by group_size={size}")
    whole = n_data > 1 and n_local % size != 0
    if whole:
        # a group spans data ranks: route the global tokens on every rank
        x = gather_axis(x, data_axis, dim=0, mesh=mesh)
    y = _routed_ffn(params.wg, w_in, w_out, x, size, capacity_factor,
                    n_experts, mine)
    if n_ep > 1:
        y = sum_over_axis(y, expert_axis, mesh=mesh)
    if whole:
        at = axis_index(data_axis, mesh=mesh)
        y = y[at * n_local:(at + 1) * n_local]
    return y


def _routed_ffn(wg, w_in, w_out, x, size, capacity_factor, n_experts,
                mine: slice) -> torch.Tensor:
    """The JAX body on ``x``'s groups, for the experts ``mine`` (whose
    parameters ``w_in`` / ``w_out`` are): the output's part those experts
    combine (all of it where ``mine`` is every expert)."""
    n_tokens, d_model = x.shape
    n_groups = n_tokens // size
    capacity = max(1, int(math.ceil(size / n_experts * capacity_factor)))

    xg = x.reshape(n_groups, size, d_model)                     # (G, S, d)
    # Routing bookkeeping runs in f32 regardless of x.dtype: a bf16 cumsum
    # is inexact past 256 and would collide queue positions (tokens
    # silently summed into one capacity slot).
    gates = torch.softmax(xg.to(torch.float32) @ wg.to(torch.float32),
                          dim=-1)
    top1 = torch.argmax(gates, dim=-1)                          # (G, S)
    gate_val = torch.take_along_dim(gates, top1[..., None], dim=-1)[..., 0]

    onehot = F.one_hot(top1, n_experts).to(torch.float32)       # (G, S, E)
    # Position of each token in its expert's queue; tokens past capacity
    # drop.
    pos = torch.cumsum(onehot, dim=1) * onehot - onehot
    within = (pos < capacity).to(torch.float32)
    # one_hot of a position past capacity is all zeros (jax.nn.one_hot)
    pos_i = pos.to(torch.int64)
    pos_oh = F.one_hot(torch.clamp(pos_i, max=capacity), capacity + 1)[
        ..., :capacity].to(torch.float32)                       # (G,S,E,C)
    dispatch = (onehot[..., None] * within[..., None] * pos_oh)[:, :, mine]
    dispatch_x = dispatch.to(x.dtype)   # exact: 0/1 values

    expert_in = torch.einsum("gsec,gsd->gecd", dispatch_x, xg)  # (G,E,C,d)
    # the expert products in the promoted dtype, as jnp.einsum promotes
    # (bf16 tokens against f32 experts run in f32)
    ct = torch.promote_types(x.dtype, w_in.dtype)
    hidden = F.gelu(torch.einsum("gecd,edh->gech", expert_in.to(ct),
                                 w_in.to(ct)), approximate="tanh")
    expert_out = torch.einsum("gech,ehd->gecd", hidden, w_out.to(ct))
    combine = (dispatch * gate_val[..., None, None]).to(expert_out.dtype)
    y = torch.einsum("gsec,gecd->gsd", combine, expert_out)
    return y.reshape(n_tokens, d_model).to(x.dtype)
