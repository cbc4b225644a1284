"""Mini-batch SGD trainer for the linear family on one device (PyTorch).

Inputs are host-shuffled once (seeded, the same permutation as the JAX
package), padded, and reshaped to ``(steps_per_epoch, batch, ...)``
tensors on the device.  The epoch loop is a Python loop over epochs and
steps with the JAX package's termination rule: stop after the first epoch
whose mean step loss moved by no more than ``tol`` (``tol <= 0``
disables it).

Three feature layouts train here:

- dense ``(n, d)`` features (:func:`sgd_fit`, :func:`sgd_fit_params`):
  autograd of ``loss + l2/2 ||w||^2`` over ``x @ w + b``, then the l1
  proximal step; ``w`` is a vector or a ``(d, classes)`` matrix;
- the generic sparse ``(indices, values)`` pairs (:func:`sgd_fit_sparse`)
  and the mixed dense + hashed-categorical layout, the Criteo shape
  (:func:`sgd_fit_mixed`).  Both train through the static ELL routing of
  :mod:`flink_ml_tpu_torch.ops.ell_scatter` where the weight tiles into
  128-lane rows and the layout fits its budget: its margin and scatter
  kernels replace the per-slot gather and scatter (the sparse layout
  drives their value variants).  ``dloss/dmargin`` comes from
  ``torch.autograd.grad`` over the margin alone, so any loss of
  :mod:`.losses` plugs in; the weight update itself is applied by hand
  (no dense gradient of ``w`` is ever built), with the l2 term as a decay
  before the step.

The out-of-core fit (:func:`sgd_fit_outofcore`) streams the same three
layouts from a reader of host batches: dense and sparse batches train
through the plain updates, mixed batches through the ELL kernels with
each batch's layout built in the prefetch decode workers and its sample
routing on the card.

Data parallel (the dense layout): inside an initialized process group
(``parallel/distributed.py``) :func:`sgd_fit` and :func:`sgd_fit_params`
run on the default mesh (or ``mesh=``, e.g. a ``hybrid_mesh``), each rank
on its own rows, with the JAX package's multi-process epoch layout
(local batch = global batch / ranks, one allgather checking that every
rank planned the same).  Each step's gradient of the global weighted-mean
loss is summed over the ranks: by ``SGDConfig.grad_reduce``
(:mod:`flink_ml_tpu_torch.parallel.grad_reduce`: top-k with error
feedback, int8, hierarchical, buckets, overlap, the adaptive ladder),
exactly where it is None or ``mode="exact"``; the reducer state rides
``params["_gr"]``.  The streamed dense fit takes ``grad_reduce`` on this
rank alone (one participant), its state riding the chunk carry and every
checkpoint cut.

A port of the JAX package's ``models/common/sgd.py``.  Its meshes for the
hashed layouts and the streamed fit, multi-rank streams and its elastic
membership are ROADMAP queue A10 and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import inspect
import itertools
import time

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...data.prefetch import (
    PrefetchStats,
    chunk_consumer_plan,
    masked_chunk_scan,
    prefetch_to_device,
)
from ...data.replay_cache import (
    DecodedReplayCache,
    batch_fingerprint,
    default_ram_budget,
)
from ...iteration.checkpoint import CheckpointConfig, CheckpointManager
from ...obs.trace import tracer
from ...ops import ell_scatter as E
from ...parallel.collectives import psum
from ...utils.device import resolve_device
from ...utils.padding import FixedRowBatcher

__all__ = ["SGDConfig", "LinearState", "sgd_fit", "sgd_fit_params",
           "sgd_fit_sparse", "sgd_fit_mixed", "plan_mixed_impl",
           "routing_chunk_steps", "plan_epoch_layout",
           "prepare_epoch_tensor", "resolve_global_batch_size",
           "sgd_fit_outofcore"]

LossFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass
class SGDConfig:
    learning_rate: float = 0.1
    reg: float = 0.0            # l2 strength (on coefficients, not intercept)
    elastic_net: float = 0.0    # l1 mixing (0 = pure l2)
    #: None/0 = auto: mixed hashed layouts grow the batch until the ELL
    #: routing layout fits its budget (:func:`resolve_global_batch_size`).
    global_batch_size: Optional[int] = None
    max_epochs: int = 20
    tol: float = 1e-6           # epoch-loss-change termination; <=0 disables
    seed: int = 0
    fit_intercept: bool = True
    #: Kept so configurations carry over from the JAX package, where it set
    #: the precision of the TPU kernels' one-hot matrix-unit gathers.  No
    #: effect here: the CUDA kernels gather in exact f32.
    ell_precision: str = "default"
    #: How the data-parallel gradient sum of the dense trainers runs
    #: (:class:`~flink_ml_tpu_torch.parallel.grad_reduce.GradReduceConfig`).
    #: None and ``mode="exact"`` give the plain sum, bit-identically;
    #: compressed modes route the gradients through ``reduce_gradients``.
    #: The hashed in-memory layouts ignore it, as in the JAX package; their
    #: streamed fits reject it.
    grad_reduce: Optional[object] = None


#: Classic minibatch default when nothing layout-aware applies.
DEFAULT_GLOBAL_BATCH = 32

#: Auto-sizing never grows the batch past the Criteo benchmark's scale.
_AUTO_BATCH_CAP = 1 << 15

# The ELL layout costs ~12 bytes per weight slot PER STEP (src + pos i32 +
# mask f32 over the (num_features/128, 128) grid), independent of batch
# size.  Beyond this budget a many-step fit takes the plain path.
_ELL_LAYOUT_BUDGET_BYTES = 2 << 30

# The margin's sample routing costs 4 bytes per categorical slot of the
# epoch (~109 MB for 2^20 rows of 26 slots), whatever the hash space.  It
# never changes the plan (the layout's budget alone does, as in the JAX
# package): past this budget it is built per chunk of steps that fits
# (:class:`_StepRouting`).
_ROUTE_BUDGET_BYTES = 1 << 30

_GATHER_LANES = 256


def resolve_global_batch_size(config: SGDConfig, n: int,
                              num_features: Optional[int] = None,
                              layout_bytes_per_slot: int = 12) -> int:
    """The batch size a fit actually runs.  Explicit user choices pass
    through untouched.  Auto (None/0) resolves to 32 for dense fits; for
    the hashed layouts it grows the batch (fewer steps) until the per-step
    ELL routing layout stack fits ``_ELL_LAYOUT_BUDGET_BYTES``.
    Deterministic in (n, num_features) only."""
    if config.global_batch_size:
        return config.global_batch_size
    if num_features is None:
        return DEFAULT_GLOBAL_BATCH
    max_steps = max(1, _ELL_LAYOUT_BUDGET_BYTES
                    // (num_features * layout_bytes_per_slot))
    min_batch = -(-n // max_steps)
    return min(max(DEFAULT_GLOBAL_BATCH, min_batch), _AUTO_BATCH_CAP)


@dataclass
class LinearState:
    coefficients: np.ndarray    # (d,)
    intercept: float
    #: which update implementation the fit planned ("ell" / "plain" for
    #: the hashed layouts, "dense"); not part of persisted model data
    planned_impl: Optional[str] = None


def plan_epoch_layout(n: int, global_batch_size: int, n_dev: int,
                      seed: int) -> Tuple[int, int, np.ndarray]:
    """Size the (steps, batch) epoch grid — batch divisible by ``n_dev`` —
    and the seeded row shuffle (the JAX package's permutation)."""
    batch = max(global_batch_size, n_dev)
    batch += (-batch) % n_dev
    steps = max(1, -(-n // batch))
    perm = np.random.default_rng(seed).permutation(n)
    return steps, batch, perm


def _plan_epoch_layout_for_mesh(n_local: int, global_batch_size: int,
                                mesh, seed: int
                                ) -> Tuple[int, int, np.ndarray]:
    """:func:`plan_epoch_layout` on a mesh of P ranks: each rank prepares
    its local ``(steps, batch/P, ...)`` slice from its own ``n_local``
    rows (the JAX package's multi-process layout); one rank (or none)
    plans the one-process layout exactly.  One allgather of ``(steps,
    local_batch)`` raises on every rank if the ranks planned apart."""
    from ...parallel.distributed import process_allgather

    procs = mesh.size if mesh.group is not None else 1
    steps, batch, perm = plan_epoch_layout(
        n_local, global_batch_size, mesh.size, seed)
    if procs == 1:
        return steps, batch, perm
    if batch % procs:
        raise ValueError(
            f"global batch {batch} is not divisible by the mesh's "
            f"{procs} processes (data axis {mesh.size}); size the batch and "
            "data axis as multiples of the process count")
    local_batch = batch // procs
    steps = max(1, -(-n_local // local_batch))
    layouts = process_allgather(np.asarray([steps, local_batch], np.int64),
                                mesh=mesh)
    if not np.all(layouts == layouts.reshape(-1, 2)[0]):
        raise ValueError(
            "multi-host fit requires every process to contribute the same "
            f"row count; got per-process (steps, local_batch) = "
            f"{layouts.reshape(-1, 2).tolist()}")
    return steps, local_batch, perm


def prepare_epoch_tensor(arr: np.ndarray, perm: np.ndarray, steps: int,
                         batch: int, pad_value: float = 0.0) -> np.ndarray:
    """Shuffle rows by ``perm``, pad to steps*batch, reshape to
    (steps, batch, ...)."""
    arr = arr[perm]
    total = steps * batch
    if arr.shape[0] < total:
        pad_shape = (total - arr.shape[0],) + arr.shape[1:]
        arr = np.concatenate([arr, np.full(pad_shape, pad_value, arr.dtype)])
    return arr.reshape((steps, batch) + arr.shape[1:])


def _run_minibatch_epochs(update, data: tuple, init_params: dict,
                          steps: int, config: SGDConfig
                          ) -> Tuple[dict, list]:
    """THE epoch loop: ``update`` over the per-step slices of the
    (steps, batch, ...) tensors in ``data``, epoch after epoch, with the
    JAX package's tol rule (compared in f32) and loss log, where an
    epoch's loss is the mean of its step losses."""
    params = init_params
    prev = np.float32(np.inf)
    tol = np.float32(config.tol)
    loss_log = []
    for _epoch in range(config.max_epochs):
        losses = []
        for i in range(steps):
            params, loss = update(params, *(a[i] for a in data))
            losses.append(loss)
        epoch_loss = np.float32(torch.stack(losses).mean().item())
        loss_log.append(float(epoch_loss))
        if config.tol > 0 and not abs(prev - epoch_loss) > tol:
            break
        prev = epoch_loss
    return params, loss_log


def _loss_and_r(loss_fn: LossFn, margin: torch.Tensor, yb: torch.Tensor,
                wb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, dloss/dmargin)`` by autograd over the margin alone."""
    with torch.enable_grad():
        m = margin.detach().requires_grad_(True)
        value = loss_fn(m, yb, wb)
        (r,) = torch.autograd.grad(value, m)
    return value.detach(), r


def _linear_update(loss_fn: LossFn, config: SGDConfig, mesh=None):
    """THE dense single-batch update: the autograd gradient of ``loss +
    l2/2 ||w||^2`` over ``xb @ w + b`` (vector or matrix ``w``), a plain
    step, then the l1 proximal soft-threshold.  The l2 term lives in the
    gradient here, not in :func:`_finish_sparse_step`'s decay before the
    step; the two are the same algebra in another f32 order.  With
    ``mesh`` (a group of one rank) the gradient is summed over it (one
    all-reduce, which keeps one rank's bits)."""
    lr = config.learning_rate
    reg, alpha = config.reg, config.elastic_net
    l2 = reg * (1.0 - alpha)
    l1 = reg * alpha

    def update(params, xb, yb, wb):
        with torch.enable_grad():
            w = params["w"].detach().requires_grad_(True)
            b = params["b"].detach().requires_grad_(True)
            value = loss_fn(xb @ w + b, yb, wb) + 0.5 * l2 * torch.sum(
                torch.square(w))
            gw, gb = torch.autograd.grad(value, (w, b))
        if mesh is not None:
            gw, gb = psum((gw, gb), mesh.axis_names, mesh=mesh)
        new_w = params["w"] - lr * gw
        if l1 > 0:
            new_w = torch.sign(new_w) * torch.clamp(
                torch.abs(new_w) - lr * l1, min=0.0)
        new_b = params["b"] - (lr * gb if config.fit_intercept else 0.0)
        return {"w": new_w, "b": new_b}, value.detach()

    return update


#: Reserved params key the data-parallel dense trainers carry the reducer
#: state under (EF residual, rounding stream, rungs, fill, pending): it
#: rides the epoch loop, the streamed fit's chunk carry and every
#: checkpoint cut beside the weights.
GR_STATE_KEY = "_gr"


def _exact_reduce(mesh):
    """The plain sum over every axis of ``mesh``: what ``grad_reduce``
    None and ``mode="exact"`` run."""
    from ...parallel.grad_reduce import GradReduceConfig

    return GradReduceConfig(mode="exact", axis=tuple(mesh.axis_names))


def _linear_update_reduced(loss_fn: LossFn, config: SGDConfig, mesh, gr,
                           executor=None):
    """The dense update of a rank of ``mesh`` (the JAX package's
    ``_linear_update_reduced``): the local weighted-mean loss is
    re-normalized to the global denominator (one all-reduce of the
    denominator and the loss), the gradient of this rank's rows is summed
    over the reduction axes by ``grad_reduce.reduce_gradients`` under
    ``gr``, the l2 term applies as decay after the reduce (it needs no
    communication), and l1 stays the proximal step.  The reducer state
    rides ``params[GR_STATE_KEY]``.  With ``gr.overlap`` the previous
    step's gradient is reduced while this step's is computed
    (``start_pipelined``, on ``executor``'s worker thread where one is
    given)."""
    from ...parallel import grad_reduce as GR

    lr = config.learning_rate
    reg, alpha = config.reg, config.elastic_net
    l2 = reg * (1.0 - alpha)
    l1 = reg * alpha
    overlap = GR.wants_overlap(gr)
    axes = GR.reduction_axes(gr)
    reader = GR.RungReader(gr) if gr.adaptive else None

    def update(params, xb, yb, wb):
        w, b = params["w"], params["b"]
        st = params.get(GR_STATE_KEY, {})
        rungs = reader.rungs(st) if reader is not None else None
        if overlap:
            pending = GR.start_pipelined(st, gr, mesh=mesh, rungs=rungs,
                                         executor=executor)
        value_local, r = _loss_and_r(loss_fn, xb @ w + b, yb, wb)
        denom_local = torch.clamp(torch.sum(wb), min=1e-12)
        tot = psum(torch.stack([denom_local, value_local * denom_local]),
                   axes, mesh=mesh)
        denom = tot[0]
        value = tot[1] / denom
        r = r * (denom_local / denom)
        grads = {"w": torch.tensordot(xb, r, dims=([0], [0])),
                 "b": torch.sum(r, dim=0)}
        if overlap:
            red, new_st = pending.finish(grads)
        else:
            red, new_st = GR.reduce_gradients(grads, st, gr, mesh=mesh,
                                              rungs=rungs)
        if l2 > 0:
            value = value + 0.5 * l2 * torch.sum(torch.square(w))
            w = w * (1.0 - lr * l2)
        new_w = w - lr * red["w"]
        if l1 > 0:
            new_w = torch.sign(new_w) * torch.clamp(
                torch.abs(new_w) - lr * l1, min=0.0)
        new_b = b - (lr * red["b"] if config.fit_intercept else 0.0)
        out = {"w": new_w, "b": new_b}
        if new_st:
            out[GR_STATE_KEY] = new_st
        return out, value

    return update


def _apply_drain(params: dict, gr_state: dict, config: SGDConfig, mesh
                 ) -> dict:
    """Fit-end drain of an overlapped run: one exact apply of the summed
    ``pending`` gradient plus the EF residual
    (``grad_reduce.drain_pending``), with the same decay / step / prox /
    bias tail as a step, so the run ends with no unsent mass.  It follows
    the last loss entry; checkpoint cuts never include it."""
    from ...parallel import grad_reduce as GR

    gr = config.grad_reduce
    drain = GR.drain_pending(gr_state, gr, mesh=mesh)
    lr = config.learning_rate
    reg, alpha = config.reg, config.elastic_net
    l2 = reg * (1.0 - alpha)
    l1 = reg * alpha
    w = params["w"]
    if l2 > 0:
        w = w * (1.0 - lr * l2)
    w = w - lr * drain["w"]
    if l1 > 0:
        w = torch.sign(w) * torch.clamp(torch.abs(w) - lr * l1, min=0.0)
    b = params["b"]
    if config.fit_intercept:
        b = b - lr * drain["b"]
    return {**params, "w": w, "b": b}


def _finish_sparse_step(config: SGDConfig):
    """Shared l2/apply/l1-prox/bias tail of the manual-gradient updates
    (l2 decay = ``w*(1-lr*l2)`` before the sparse gradient, exactly
    grad-of-``loss + l2/2 ||w||^2``; l1 via proximal soft-threshold
    after)."""
    lr = config.learning_rate
    reg, alpha = config.reg, config.elastic_net
    l2 = reg * (1.0 - alpha)
    l1 = reg * alpha

    def finish(w, b, value, r, apply_grad):
        """``apply_grad(w)`` must return ``w - lr * grad_loss`` as a new
        tensor; ``r`` is dloss/dmargin for the bias step."""
        if l2 > 0:
            value = value + 0.5 * l2 * torch.sum(torch.square(w))
            w = w * (1.0 - lr * l2)
        w = apply_grad(w)
        if l1 > 0:
            w = torch.sign(w) * torch.clamp(torch.abs(w) - lr * l1, min=0.0)
        b = b - (lr * torch.sum(r) if config.fit_intercept else 0.0)
        return {"w": w, "b": b}, value

    return finish


def _scatter_add_(t: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``t[idx] += vals`` in place, repeated indices summed in one fixed
    order on the card too, so a fit gives the same bits run after run
    (what the in-memory fits' repeatability and the streamed fit's W,
    replay and resume rest on).  On the card: the sort-based accumulation
    behind ``index_put_(accumulate=True)``, called through
    ``_index_put_impl_`` with ``unsafe=True`` (the public op checks the
    index range with two host reads a call; the layouts build every index
    in range); ``index_add_``, which adds with atomics in no fixed order
    there, is cheaper (``scripts/scatter_leg_times.py``) but no fit takes
    it.  On the CPU: ``index_add_``, a serial loop."""
    if t.is_cuda:
        return torch.ops.aten._index_put_impl_(t, [idx.long()], vals,
                                               True, True)
    return t.index_add_(0, idx, vals)


def _overflow_scatter_(t: torch.Tensor, idx: torch.Tensor,
                       vals: torch.Tensor, ovf_src: torch.Tensor,
                       batch: int) -> torch.Tensor:
    """An overflow leg's ``t[idx] += vals`` (:func:`_scatter_add_`).  The
    layouts pad the overflow lists after their live entries (``ovf_src <
    batch``), all with one target: in the card's fixed-order sum that
    padding would be one run of a repeated index, summed serially (tens of
    thousands long at the streamed fits' cap of ``max(1024, batch)``).  So
    each pad entry goes to a slot of its own (its position modulo
    ``len(t)``) carrying ``-0.0``, which adds nothing to any value: the
    live slots get the bits they would get without the spread."""
    live = ovf_src < batch
    spread = torch.arange(idx.numel(), device=idx.device) % t.numel()
    return _scatter_add_(t, torch.where(live, idx.long(), spread),
                         torch.where(live, vals, -0.0))


def _sparse_update(loss_fn: LossFn, config: SGDConfig):
    """Single-batch update for the generic ``(indices, values)`` layout
    without the ELL routing: the margin is ``sum(values * w[indices])``
    and the gradient a direct scatter-add of ``-lr * values * r`` into the
    weight (:func:`_scatter_add_`, in place of the JAX package's
    lane-blocked scatter, which is the same sum).  The path for widths the
    kernels reject or layouts over budget."""
    lr = config.learning_rate
    finish = _finish_sparse_step(config)

    def update(params, idx, vals, yb, wb):
        w, b = params["w"], params["b"]
        margin = torch.sum(vals * E.gather_weights(w, idx), dim=-1) + b
        value, r = _loss_and_r(loss_fn, margin, yb, wb)
        return finish(w, b, value, r, lambda w: _scatter_add_(
            w.clone(), idx.reshape(-1),
            (-lr * (vals * r[:, None])).reshape(-1)))

    return update


def _mixed_update(loss_fn: LossFn, config: SGDConfig):
    """Single-batch update for the mixed layout without the ELL routing:
    ``dense`` features occupy weight slots ``[0, dense.shape[-1])``, hashed
    ``cat`` indices (implicit value 1.0) gather and scatter directly.  The
    path for widths :func:`~flink_ml_tpu_torch.ops.ell_scatter.supported`
    rejects or layouts over budget."""
    lr = config.learning_rate
    finish = _finish_sparse_step(config)

    def update(params, dense, cat, yb, wb):
        w, b = params["w"], params["b"]
        n_dense, n_cat = dense.shape[-1], cat.shape[-1]
        margin = (dense @ w[:n_dense]
                  + torch.sum(E.gather_weights(w, cat), dim=-1) + b)
        value, r = _loss_and_r(loss_fn, margin, yb, wb)

        def apply_grad(w):
            w = _scatter_add_(w.clone(), cat.reshape(-1),
                              torch.repeat_interleave(-lr * r, n_cat))
            w[:n_dense] += -lr * (r @ dense)
            return w

        return finish(w, b, value, r, apply_grad)

    return update


def _ext_len(batch: int) -> int:
    """Length of the extended per-sample tables (:func:`_extended_r` and
    the ELL margin table): batch plus a nonempty zero pad rounding up to
    whole 256-lane rows (pad slots carry ``src == batch``)."""
    return batch + (_GATHER_LANES - (batch % _GATHER_LANES)
                    or _GATHER_LANES)


def _extended_r(r: torch.Tensor) -> torch.Tensor:
    """r with a zero pad: padding slots carry ``src == batch``."""
    batch = r.shape[0]
    return torch.cat([r, torch.zeros(_ext_len(batch) - batch,
                                     dtype=r.dtype, device=r.device)])


def _ell_margin(w, batch, route_w, ovf_idx, ovf_src, heavy_idx, heavy_cnt,
                route_val=None, ovf_val=None, plain=False):
    """Per-sample categorical margin ``sum_j v_j * w[idx_j]`` over the ELL
    routing: the in-grid slots through the margin kernel over the sample
    routing (:func:`~flink_ml_tpu_torch.ops.ell_scatter.sample_routing`),
    the overflow through a short gather + scatter-add into the extended
    table (pads carry ``ovf_src == batch`` and land in the discarded pad),
    heavy hitters through one ``(H,) @ (H, batch)`` matvec.  ``plain`` runs
    the kernel's plain version whatever the device."""
    margin_fn = E.ell_margin_plain if plain else E.ell_margin
    mext = margin_fn(w, route_w, m_len=_ext_len(batch), route_val=route_val)
    o = w[ovf_idx] if ovf_val is None else ovf_val * w[ovf_idx]
    mext = _overflow_scatter_(mext, ovf_src, o, ovf_src, batch)
    return mext[:batch] + w[heavy_idx] @ heavy_cnt.to(torch.float32)


def _apply_ell_categorical(lr, w, r, r_ext, src, pos, mask, ovf_idx,
                           ovf_src, heavy_idx, heavy_cnt, val_ell=None,
                           ovf_val=None, plain=False):
    """THE ELL gradient application: in-grid scatter kernel -> overflow
    scatter-add -> heavy-hitter matvec (padding entries carry zero counts
    and add 0 at w[0]).  The fused kernel runs on grids whose row count
    divides into 8-row blocks, the gather + pair kernel otherwise (the JAX
    package's plan).  Returns a new tensor; the overflow and heavy legs
    update it in place (:func:`_overflow_scatter_`)."""
    if src.shape[0] % E.FUSED_BLOCK_ROWS == 0:
        fused = E.ell_scatter_apply_fused_plain if plain \
            else E.ell_scatter_apply_fused
        w = fused(w, r_ext, src, pos, mask, lr=lr, val=val_ell)
    else:
        g = E.gather_weights(r_ext, src)
        upd = (-lr) * (g if val_ell is None else val_ell * g)
        pair = E.ell_scatter_apply_plain if plain else E.ell_scatter_apply
        w = pair(w, upd, pos, mask)
    o = r_ext[ovf_src] if ovf_val is None else ovf_val * r_ext[ovf_src]
    _overflow_scatter_(w, ovf_idx, (-lr) * o, ovf_src, r.shape[0])
    # the heavy indices are distinct and their pads add zeros, so the
    # atomics' order cannot change a bit here
    return w.index_add_(0, heavy_idx,
                        (-lr) * (heavy_cnt.to(torch.float32) @ r))


def _mixed_update_ell(loss_fn: LossFn, config: SGDConfig,
                      plain: bool = False):
    """ELL twin of :func:`_mixed_update`: same loss/regularization algebra,
    but the forward margin and the backward scatter of the categorical
    slots ride the static ELL routing's kernels.  The batch arguments
    (src, pos, mask, ovf_idx, ovf_src, heavy_idx, heavy_cnt) are the
    per-step layout stacks of :func:`ell_layout`, and ``route_w`` the
    per-step sample routing the margin reads (:func:`sample_routing`);
    the raw index tensor is not an input.  Results differ from
    :func:`_mixed_update` only in f32 summation order.  ``plain`` runs the
    kernels' plain versions (the oracle on the card)."""
    lr = config.learning_rate
    finish = _finish_sparse_step(config)

    def update(params, dense, route_w, src, pos, mask, ovf_idx, ovf_src,
               heavy_idx, heavy_cnt, yb, wb):
        w, b = params["w"], params["b"]
        n_dense = dense.shape[-1]
        margin = (dense @ w[:n_dense]
                  + _ell_margin(w, dense.shape[0], route_w, ovf_idx,
                                ovf_src, heavy_idx, heavy_cnt, plain=plain)
                  + b)
        value, r = _loss_and_r(loss_fn, margin, yb, wb)
        r_ext = _extended_r(r)

        def apply_grad(w):
            w = _apply_ell_categorical(
                lr, w, r, r_ext, src, pos, mask, ovf_idx, ovf_src,
                heavy_idx, heavy_cnt, plain=plain)
            w[:n_dense] += -lr * (r @ dense)
            return w

        return finish(w, b, value, r, apply_grad)

    return update


def _sparse_update_ell(loss_fn: LossFn, config: SGDConfig,
                       plain: bool = False):
    """ELL twin of :func:`_sparse_update` for the generic ``(indices,
    values)`` layout: per-slot updates are ``-lr * value * r``, carried by
    the layout's value arrays (``val``, ``ovf_val`` and value-sum
    ``heavy_cnt``); ``route`` is the step's ``(route_w, route_val)`` pair
    of the sample routing.  The value variants of the ELL kernels carry
    the in-grid slots.  Same algebra as :func:`_sparse_update` up to f32
    summation order.  ``plain`` runs the kernels' plain versions."""
    lr = config.learning_rate
    finish = _finish_sparse_step(config)

    def update(params, route, src, pos, mask, val_ell, ovf_idx, ovf_src,
               ovf_val, heavy_idx, heavy_cnt, yb, wb):
        w, b = params["w"], params["b"]
        route_w, route_val = route
        margin = _ell_margin(w, yb.shape[0], route_w, ovf_idx, ovf_src,
                             heavy_idx, heavy_cnt, route_val=route_val,
                             ovf_val=ovf_val, plain=plain) + b
        value, r = _loss_and_r(loss_fn, margin, yb, wb)
        r_ext = _extended_r(r)
        return finish(w, b, value, r, lambda w: _apply_ell_categorical(
            lr, w, r, r_ext, src, pos, mask, ovf_idx, ovf_src, heavy_idx,
            heavy_cnt, val_ell=val_ell, ovf_val=ovf_val, plain=plain))

    return update


def plan_mixed_impl(num_features: int, steps: int,
                    layout_bytes_per_slot: int = 12) -> str:
    """Which categorical implementation :func:`sgd_fit_mixed` runs:
    ``"ell"`` (the static-routing kernels) when the weight size tiles into
    128-lane rows and the ``steps``-deep layout stack fits its budget, else
    ``"plain"`` (direct gather/scatter): the JAX package's rule on its
    accelerator.  The margin's sample routing does not enter it (it is
    built per chunk of steps where it outgrows its own budget).  Planned
    by shape and budget only, so the CPU and the card run the same code;
    only the kernel wrappers branch on the device."""
    if (E.supported(num_features)
            and steps * num_features * layout_bytes_per_slot
            <= _ELL_LAYOUT_BUDGET_BYTES):
        return "ell"
    return "plain"


def routing_chunk_steps(steps: int, route_slots: int,
                        entry_bytes: int = 4) -> int:
    """Steps of the sample routing built at once: all ``steps`` where the
    whole routing (``route_slots`` entries per step, ``entry_bytes`` each:
    4 for the weight index, 8 with the slot's value) fits
    ``_ROUTE_BUDGET_BYTES``, else as many as fit, at least one."""
    per_step = max(1, route_slots * entry_bytes)
    return max(1, min(steps, _ROUTE_BUDGET_BYTES // per_step))


class _StepRouting:
    """The margin's sample routing of a layout stack, indexed by step like
    the epoch tensors: ``routing[i]`` is step ``i``'s ``(nnz, batch)``
    ``route_w``, or the pair ``(route_w, route_val)`` where the layout
    carries values (``lay.val``).  Built on the layout's device one chunk
    of ``chunk`` steps at a time, when a step of the chunk is first asked
    for, and kept until a step of another chunk is: with one chunk it is
    built once per fit, with more it is built anew in every epoch.  A
    step's routing depends only on that step's layout, and columns past a
    sample's last slot add 0, so the chunking does not change the margin.
    ``builds`` counts the chunks built."""

    def __init__(self, lay: "E.EllLayout", batch: int, chunk: int):
        self.lay, self.batch, self.chunk = lay, batch, chunk
        self.builds = 0
        self._lo, self._hi = 0, 0
        self._route = self._val = None

    def __getitem__(self, i: int):
        if not self._lo <= i < self._hi:
            lo = i - i % self.chunk
            hi = min(lo + self.chunk, self.lay.src.shape[0])
            self._route = self._val = None      # free the old chunk first
            lay = self.lay
            self._route, self._val = E.sample_routing(
                lay.src[lo:hi], lay.pos[lo:hi], lay.mask[lo:hi], self.batch,
                val=None if lay.val is None else lay.val[lo:hi])
            self._lo, self._hi = lo, hi
            self.builds += 1
        if self._val is None:
            return self._route[i - self._lo]
        return self._route[i - self._lo], self._val[i - self._lo]


def _epoch_targets(labels: np.ndarray, weights: Optional[np.ndarray],
                   perm: np.ndarray, steps: int, batch: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The f32 label and sample-weight epoch tensors; padding rows carry
    weight 0."""
    y = prepare_epoch_tensor(labels.astype(np.float32), perm, steps, batch)
    sw_host = (weights.astype(np.float32) if weights is not None
               else np.ones((labels.shape[0],), np.float32))
    return y, prepare_epoch_tensor(sw_host, perm, steps, batch,
                                   pad_value=0.0)


def _zero_params(num_features: int, dev: torch.device) -> dict:
    return {"w": torch.zeros(num_features, dtype=torch.float32, device=dev),
            "b": torch.zeros((), dtype=torch.float32, device=dev)}


def _linear_state(params: dict, impl: str) -> LinearState:
    return LinearState(params["w"].cpu().numpy().astype(np.float64),
                       float(params["b"]), planned_impl=impl)


def _rank_device(device):
    """``device``, else this rank's device in a group, else the card."""
    if device is None:
        from ...parallel.distributed import rank_device

        device = rank_device()
    return resolve_device(device)


def sgd_fit(loss_fn: LossFn, features: np.ndarray, labels: np.ndarray,
            weights: Optional[np.ndarray], config: SGDConfig,
            device=None, *, mesh=None) -> Tuple[LinearState, list]:
    """Train ``(w, b)`` on dense ``(n, d)`` features, minimizing
    ``loss_fn(margin, labels, weights) + reg * ((1-alpha)/2 ||w||^2 +
    alpha ||w||_1)`` (the l1 part by proximal soft-threshold after each
    step).  Returns the fitted state (planned "dense") and the per-epoch
    loss log.  Runs on ``device`` (default this rank's device in a
    process group, else the card; raises without one); in a group each
    rank passes its own rows (:func:`sgd_fit_params`)."""
    d = features.shape[1]
    params, loss_log = sgd_fit_params(
        loss_fn, features, labels, weights, config, device, mesh=mesh,
        init_params={"w": np.zeros((d,), np.float32),
                     "b": np.zeros((), np.float32)})
    return LinearState(np.asarray(params["w"], np.float64),
                       float(params["b"]), planned_impl="dense"), loss_log


def sgd_fit_params(loss_fn: LossFn, features: np.ndarray, labels: np.ndarray,
                   weights: Optional[np.ndarray], config: SGDConfig,
                   device=None, *, init_params: dict, mesh=None
                   ) -> Tuple[Dict[str, np.ndarray], list]:
    """The core behind :func:`sgd_fit`: trains any ``{"w", "b"}`` whose
    score is ``x @ w + b`` (vector ``w`` for the binary and regression
    models, a ``(d, classes)`` matrix for softmax), from ``init_params``
    (numpy or tensors).  ``loss_fn(scores, labels, weights)`` defines the
    objective; labels ride the epoch tensor as f32 (exact for class ids
    below 2^24: cast back inside the loss).  Returns the fitted parameters
    as f32 numpy and the per-epoch loss log.

    Inside a process group the fit runs on ``mesh`` (default the default
    mesh): each rank passes its own rows, every rank gets the same
    parameters, and each step's gradient is summed over the ranks under
    ``config.grad_reduce`` (module docstring).  A group of one rank runs
    the one-process fit, its gradient summed over the one rank."""
    from ...parallel import grad_reduce as GR
    from ...parallel.mesh import default_mesh

    dev = _rank_device(device)
    mesh = mesh or default_mesh()
    gr = _active_grad_reduce(config)
    if gr is not None:
        GR.mesh_layout(gr, mesh)
    ranks = mesh.size if mesh.group is not None else 1
    n = features.shape[0]
    steps, batch, perm = _plan_epoch_layout_for_mesh(
        n, resolve_global_batch_size(config, n), mesh, config.seed)
    X = prepare_epoch_tensor(features.astype(np.float32), perm, steps, batch)
    y, sw = _epoch_targets(labels, weights, perm, steps, batch)
    init = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in init_params.items()}
    data = tuple(torch.from_numpy(a).to(dev) for a in (X, y, sw))
    if gr is None and ranks == 1:
        params, loss_log = _run_minibatch_epochs(
            _linear_update(loss_fn, config,
                           mesh if mesh.group is not None else None),
            data, init, steps, config)
        return {k: v.cpu().numpy() for k, v in params.items()}, loss_log
    reduce = gr or _exact_reduce(mesh)
    if GR.needs_state(reduce):
        init[GR_STATE_KEY] = GR.init_state(
            reduce, {k: init[k] for k in ("w", "b")}, mesh)
    overlap = GR.wants_overlap(reduce) and mesh.group is not None
    executor = ThreadPoolExecutor(max_workers=1) if overlap else None
    try:
        params, loss_log = _run_minibatch_epochs(
            _linear_update_reduced(loss_fn, config, mesh, reduce, executor),
            data, init, steps, config)
    finally:
        if executor is not None:
            executor.shutdown()
    gr_state = params.pop(GR_STATE_KEY, None)
    if gr_state is not None and GR.wants_overlap(reduce):
        params = _apply_drain(params, gr_state, config, mesh)
    return {k: v.cpu().numpy() for k, v in params.items()}, loss_log


def sgd_fit_sparse(loss_fn: LossFn, indices: np.ndarray, values: np.ndarray,
                   labels: np.ndarray, weights: Optional[np.ndarray],
                   num_features: int, config: SGDConfig, device="cuda",
                   plain: bool = False) -> Tuple[LinearState, list]:
    """Train ``(w, b)`` on the generic sparse layout: rows are ``(indices
    (n, nnz) int, values (n, nnz) float)`` pairs (what
    :func:`~flink_ml_tpu_torch.linalg.stack_sparse_vectors` and a hashing
    featurizer's pair columns give) scored against a dense
    ``(num_features,)`` weight.  The ELL plan builds the values-aware host
    layout (``ell_layout(idx, d, values=vals)``: a fourth f32 grid, so 16
    bytes a slot a step in the batch and plan budgets) and the sample
    routing with the slots' values; the margin and scatter kernels run
    their value variants.  Returns the fitted state and the per-epoch loss
    log.  Runs on ``device`` (default the card; raises without one).
    ``plain`` runs the ELL kernels' plain versions (the oracle on the
    card).  Every scatter-add sums in a fixed order
    (:func:`_scatter_add_`), so two fits on the card give the same bits."""
    from .linear import check_sparse_indices

    dev = resolve_device(device)
    check_sparse_indices(indices, num_features)
    n, nnz = indices.shape
    steps, batch, perm = plan_epoch_layout(
        n, resolve_global_batch_size(config, n, num_features,
                                     layout_bytes_per_slot=16), 1,
        config.seed)
    idx = prepare_epoch_tensor(indices.astype(np.int32), perm, steps, batch)
    vals = prepare_epoch_tensor(values.astype(np.float32), perm, steps,
                                batch)
    y, sw = _epoch_targets(labels, weights, perm, steps, batch)

    def put(a):
        return torch.from_numpy(a).to(dev)

    impl = plan_mixed_impl(num_features, steps, layout_bytes_per_slot=16)
    if impl == "ell":
        # the raw (steps, batch, nnz) idx/vals stay on the host: margins
        # and scatters both ride the layout
        lay = E.ell_layout(idx, num_features, values=vals).to(dev)
        route = _StepRouting(lay, batch, routing_chunk_steps(
            steps, batch * nnz, entry_bytes=8))
        epoch_args = (route, lay.src, lay.pos, lay.mask, lay.val,
                      lay.ovf_idx, lay.ovf_src, lay.ovf_val, lay.heavy_idx,
                      lay.heavy_cnt, put(y), put(sw))
        update = _sparse_update_ell(loss_fn, config, plain=plain)
    else:
        epoch_args = (put(idx).long(), put(vals), put(y), put(sw))
        update = _sparse_update(loss_fn, config)
    params, loss_log = _run_minibatch_epochs(
        update, epoch_args, _zero_params(num_features, dev), steps, config)
    return _linear_state(params, impl), loss_log


def sgd_fit_mixed(loss_fn: LossFn, dense_features: np.ndarray,
                  cat_indices: np.ndarray, labels: np.ndarray,
                  weights: Optional[np.ndarray], num_features: int,
                  config: SGDConfig, device="cuda", plain: bool = False
                  ) -> Tuple[LinearState, list]:
    """Train (w, b) on the Criteo-native mixed layout: ``dense_features``
    (n, n_dense) occupy weight slots ``[0, n_dense)`` and ``cat_indices``
    (n, n_cat) are hashed slots with implicit value 1.0.  Returns the
    fitted state and the per-epoch loss log.  Runs on ``device`` (default
    the card; raises without one).  ``plain`` runs the ELL kernels' plain
    PyTorch versions instead of the kernels (the oracle on the card).
    Every scatter-add sums in a fixed order (:func:`_scatter_add_`), so
    two fits on the card give the same bits."""
    from .linear import check_sparse_indices

    dev = resolve_device(device)
    check_sparse_indices(cat_indices, num_features)
    n_dense = dense_features.shape[1]
    if n_dense > num_features:
        raise ValueError(f"n_dense={n_dense} exceeds "
                         f"num_features={num_features}")
    n = dense_features.shape[0]
    n_cat = cat_indices.shape[1]
    steps, batch, perm = plan_epoch_layout(
        n, resolve_global_batch_size(config, n, num_features), 1,
        config.seed)

    dense = prepare_epoch_tensor(dense_features.astype(np.float32), perm,
                                 steps, batch)
    cat = prepare_epoch_tensor(cat_indices.astype(np.int32), perm, steps,
                               batch)
    y, sw = _epoch_targets(labels, weights, perm, steps, batch)

    def put(a):
        return torch.from_numpy(a).to(dev)

    impl = plan_mixed_impl(num_features, steps)
    if impl == "ell":
        # one-time static routing of every step's categorical slots (and
        # its sample-major inverse for the margin, built on the device
        # per chunk of steps that fits its budget), replayed every epoch;
        # the raw index tensor stays on the host
        lay = E.ell_layout(cat, num_features).to(dev)
        route_w = _StepRouting(lay, batch,
                               routing_chunk_steps(steps, batch * n_cat))
        epoch_args = (put(dense), route_w, lay.src, lay.pos, lay.mask,
                      lay.ovf_idx, lay.ovf_src, lay.heavy_idx,
                      lay.heavy_cnt, put(y), put(sw))
        update = _mixed_update_ell(loss_fn, config, plain=plain)
    else:
        epoch_args = (put(dense), put(cat).long(), put(y), put(sw))
        update = _mixed_update(loss_fn, config)

    params, loss_log = _run_minibatch_epochs(
        update, epoch_args, _zero_params(num_features, dev), steps, config)
    return _linear_state(params, impl), loss_log


# ---------------------------------------------------------------------------
# the out-of-core (streamed) fit
# ---------------------------------------------------------------------------

def _params_to_device(tree, dev: torch.device):
    """Restored host parameters (and reducer state) as tensors on
    ``dev``: the weights as f32, every other leaf in its own dtype."""
    def put(k, v):
        if isinstance(v, dict):
            return {kk: put(kk, vv) for kk, vv in v.items()}
        arr = np.asarray(v, np.float32 if k in ("w", "b") else None)
        return torch.from_numpy(np.require(arr, requirements="C")).to(dev)

    return {k: put(k, v) for k, v in tree.items()}


def _active_grad_reduce(config: SGDConfig):
    """The grad-reduce config IF it changes anything (None and
    ``mode="exact"`` keep the plain sum)."""
    gr = getattr(config, "grad_reduce", None)
    if gr is None or getattr(gr, "mode", None) == "exact":
        return None
    return gr


def _reader_for_epoch(make_reader: Callable, epoch: int,
                      retry_policy=None):
    """Call the per-epoch reader factory, passing ``epoch=`` when the
    factory accepts it (per-epoch shuffled readers such as
    ``data.datacache.ShuffledCacheReader`` need the ACTUAL epoch number: a
    call-counting closure would desynchronize on checkpoint resume).
    Zero-arg factories keep working unchanged.

    ``retry_policy`` wraps the returned reader so transient pull failures
    retry with backoff.  The wrap happens HERE, at the raw reader, below
    the fit's generator adapters: a generator that propagates an
    exception is dead forever (``robustness.retry.RetryingIterator``)."""

    def build():
        try:
            sig = inspect.signature(make_reader)
        except (TypeError, ValueError):
            return make_reader()
        for p in sig.parameters.values():
            # only an explicitly named, keyword-passable `epoch` opts in
            if p.name == "epoch" and p.kind in (
                    inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    inspect.Parameter.KEYWORD_ONLY):
                return make_reader(epoch=epoch)
        return make_reader()

    reader = build()
    if retry_policy is None:
        return reader
    from ...robustness.retry import RetryingIterator

    return RetryingIterator(reader, retry_policy)


def _has_cursor(reader) -> bool:
    """The DataCacheReader cursor protocol: seekable, fixed batch size,
    known length — what checkpoint fast-forward and decoded-replay
    eligibility rely on."""
    return (hasattr(reader, "seek") and hasattr(reader, "batch_rows")
            and hasattr(reader, "total_rows"))


def _seek_or_skip(reader, k: int):
    """Position a fresh reader ``k`` batches in: seek when it speaks the
    cursor protocol, else discard batches.  Returns an iterator."""
    if hasattr(reader, "seek") and hasattr(reader, "batch_rows"):
        rows = k * reader.batch_rows
        total = getattr(reader, "total_rows", None)
        reader.seek(rows if total is None else min(rows, total))
        return iter(reader)
    it = iter(reader)
    for _ in range(k):
        try:
            next(it)
        except StopIteration:
            break
    return it


def _streamed_ell_update(loss_fn: LossFn, config: SGDConfig, plain: bool):
    """The mixed ELL update over one streamed batch: the margin's sample
    routing is built on the card from the step's layout
    (:func:`~flink_ml_tpu_torch.ops.ell_scatter.sample_routing`) before
    the kernels run."""
    update = _mixed_update_ell(loss_fn, config, plain=plain)

    def device_routed(params, dense, src, pos, mask, *rest):
        route_w, _ = E.sample_routing(src, pos, mask, dense.shape[0])
        return update(params, dense, route_w, src, pos, mask, *rest)

    return device_routed


def sgd_fit_outofcore(loss_fn: LossFn, make_reader: Callable, *,
                      num_features: int, config: SGDConfig, mesh=None,
                      features_key: str = "features",
                      label_key: str = "label",
                      weight_key: Optional[str] = None,
                      indices_key: Optional[str] = None,
                      values_key: Optional[str] = None,
                      dense_key: Optional[str] = None,
                      prefetch_depth: int = 2,
                      prefetch_workers: int = 1,
                      prefetch_put_workers: int = 1,
                      prefetch_stats: Optional[PrefetchStats] = None,
                      steps_per_dispatch: int = 8,
                      cache_decoded="auto",
                      decoded_ram_budget: Optional[int] = None,
                      stream_info: Optional[dict] = None,
                      ell_ovf_cap: Optional[int] = None,
                      ell_heavy_cap: int = 16,
                      checkpoint=None,
                      checkpoint_every_steps: int = 0,
                      resume: bool = False,
                      retry_policy=None,
                      publish_cb: Optional[Callable] = None,
                      step_probe: bool = False,
                      membership=None,
                      device="cuda",
                      plain: bool = False
                      ) -> Tuple[LinearState, list]:
    """Out-of-core variant of :func:`sgd_fit`: the dataset never has to fit
    in host RAM or device memory (the Criteo-1TB shape).

    ``make_reader()`` is called once per epoch and must return a fresh
    iterator of host batch dicts with a fixed row count per batch (e.g.
    ``DataCacheReader(..., batch_rows=B)``).  Batches are padded to the
    first batch's row count (padding rows carry weight 0), decoded on
    ``prefetch_workers`` threads and moved to ``device`` by
    :func:`~flink_ml_tpu_torch.data.prefetch.prefetch_to_device`, so the
    host read, decode and transfer of the next chunk overlap the steps on
    this one.  The reader owns the data layout: ``global_batch_size`` and
    ``seed`` are inert here.

    Layouts: dense ``features_key`` batches (the autograd update of
    :func:`sgd_fit`); ``indices_key`` + ``values_key`` **sparse** batches
    (plain gather and ``index_add``: the JAX package plans this stream
    ``"xla-stream"`` and so does the port); ``dense_key`` + ``indices_key``
    **mixed** batches (implicit categorical value 1.0).  The mixed stream
    plans ``"ell-stream"`` by :func:`plan_mixed_impl` (the JAX package's
    rule): each batch's ELL layout is built in the decode workers with
    fixed capacities (``ell_ovf_cap``, default ``max(1024, batch)``;
    ``ell_heavy_cap``, default 16 — an over-cap batch raises with sizing
    guidance), and the margin and fused scatter kernels (B1, B2; the pair
    scatter B3 where the grid does not divide into 8-row blocks) carry
    every step.  The margin's sample routing is built per batch, on the
    card at each step from the step's layout.
    ``plain=True`` runs the kernels' plain versions (the comparison on
    the card); nothing on the main path sets it.

    **Chunked dispatch** (``steps_per_dispatch=W``, default 8): W
    consecutive batches are stacked into one staged chunk and moved in
    one transfer; the consumer runs their W steps and skips the padded
    steps of the final short chunk, so any two W agree bit for bit.  The
    pipeline runs ``ceil(prefetch_depth / W)`` chunks deep (at least
    one).

    **Decoded replay cache** (``cache_decoded="auto"``, the default): the
    first full epoch tees each decoded batch into host RAM up to
    ``decoded_ram_budget`` bytes (default 25% of available RAM, capped at
    32 GiB) and later epochs replay the cached prefix straight into the
    transfer, re-decoding only the tail that did not fit.  "auto" engages
    only for readers with the cursor protocol (``seek``/``batch_rows``/
    ``total_rows``); every replay epoch re-reads the first raw batch (and
    one power-of-two batch mid-stream) and compares digests with the
    recorded epoch's, so a reader that varies its stream per epoch drops
    the cache instead of training on frozen epoch-0 data.  Readers that
    declare ``epoch_varying`` and are block-addressable (``block_order``,
    the :class:`~flink_ml_tpu_torch.data.datacache.ShuffledCacheReader`
    protocol) cache by block id: every epoch serves cached blocks in its
    own permutation.  ``True`` caches any reader with no probe, ``False``
    disables.

    **Mid-epoch checkpoints** (``checkpoint`` + ``checkpoint_every_steps``):
    at the chunk boundaries that cross a multiple of
    ``checkpoint_every_steps`` batches, the (params, loss accumulator,
    reader cursor) triple is cut, and at every epoch end; ``resume=True``
    restarts exactly at the newest valid cut (the reader re-seeked, or
    batches skipped) and continues bit for bit as if never interrupted.
    ``robustness.resilient_fit`` wraps this fit to make crash -> restore
    -> replay automatic.  ``publish_cb(global_step, params_fn)`` is called
    at every cut point, right AFTER the checkpoint save; ``params_fn`` is
    a zero-arg thunk returning the cut's host ``{"w", "b"}``.

    ``retry_policy`` wraps each epoch's reader in a ``RetryingIterator``
    (transient pull failures cost a backoff sleep on the prefetch reader
    thread).  ``step_probe=True`` records every step's loss in a
    :class:`~flink_ml_tpu_torch.obs.StepProbe`, fetched once per chunk,
    into ``stream_info["step_trace"]``.  ``stream_info`` (a dict, filled
    in place) reports the plan, the decoded cache and the per-epoch wall
    seconds.

    ``config.grad_reduce`` (dense layout; planned
    ``"dense-stream-reduced"``) runs on this rank alone, one participant
    over the config's axes: its reducer state rides the chunk carry and
    every checkpoint cut, and an overlapped run drains at its return.  The
    mixed and sparse layouts reject ``grad_reduce`` as the JAX package
    does.  Not ported (ROADMAP queue A10): ``mesh=`` (multi-device and
    multi-host streams) and ``membership=`` (elastic fleets)."""
    if mesh is not None:
        raise NotImplementedError(
            "sgd_fit_outofcore(mesh=...) (multi-device and multi-host "
            "streams) is not ported to flink_ml_tpu_torch yet (ROADMAP "
            "queue A10)")
    if membership is not None:
        raise NotImplementedError(
            "sgd_fit_outofcore(membership=...) (elastic fleets) is not "
            "ported to flink_ml_tpu_torch yet (ROADMAP queue A10)")
    dev = resolve_device(device)
    mixed = dense_key is not None and indices_key is not None
    sparse = indices_key is not None and not mixed
    if sparse and values_key is None:
        raise ValueError("indices_key requires values_key (or dense_key "
                         "for the mixed layout)")
    if dense_key is not None and indices_key is None:
        raise ValueError("dense_key requires indices_key")
    gr = _active_grad_reduce(config)
    if gr is not None and (mixed or sparse):
        raise ValueError(
            "grad_reduce compression applies to the dense streaming "
            "layout; the sparse/mixed paths' gradients are already "
            "sparse by construction — drop grad_reduce or use the "
            "dense features layout")
    stream_ell = mixed and plan_mixed_impl(num_features, 1) == "ell"
    stream_impl = ("ell-stream" if stream_ell
                   else ("xla-stream" if (mixed or sparse)
                         else "dense-stream"))
    gr_mesh = None
    if gr is not None:
        from ...parallel import grad_reduce as GR
        from ...parallel.mesh import local_mesh

        # this rank alone: one participant over the config's axes
        gr_mesh = local_mesh(GR.reduction_axes(gr), device=dev)
        stream_impl = "dense-stream-reduced"
        update = _linear_update_reduced(loss_fn, config, gr_mesh, gr)
    elif stream_ell:
        update = _streamed_ell_update(loss_fn, config, plain)
    elif mixed:
        mixed_update = _mixed_update(loss_fn, config)

        def update(params, dense, cat, yb, wb):
            return mixed_update(params, dense, cat.long(), yb, wb)
    elif sparse:
        sparse_update = _sparse_update(loss_fn, config)

        def update(params, idx, vals, yb, wb):
            return sparse_update(params, idx.long(), vals, yb, wb)
    else:
        update = _linear_update(loss_fn, config)

    manager: Optional[CheckpointManager] = None
    if isinstance(checkpoint, CheckpointManager):
        manager = checkpoint
    elif isinstance(checkpoint, CheckpointConfig):
        manager = CheckpointManager(checkpoint)

    W = max(1, int(steps_per_dispatch))
    _, chunk_depth = chunk_consumer_plan(None, None, W, prefetch_depth)
    batcher = FixedRowBatcher(1)   # the shared fixed-row protocol

    def to_host_batch(batch):
        if sparse or mixed:
            from .linear import check_sparse_indices

            idx = np.asarray(batch[indices_key], np.int32)
            check_sparse_indices(idx, num_features)
            if mixed:
                feats = (np.asarray(batch[dense_key], np.float32), idx)
            else:
                feats = (idx, np.asarray(batch[values_key], np.float32))
        else:
            feats = (np.asarray(batch[features_key], np.float32),)
        y = np.asarray(batch[label_key], np.float32)
        w = (np.asarray(batch[weight_key], np.float32) if weight_key
             else np.ones((y.shape[0],), np.float32))
        # final partial batch: pad, weight 0 (the batcher pins thread-safely)
        padded = batcher.pad(feats + (y, w), have=y.shape[0])
        if not stream_ell:
            return padded
        dense_p, cat_p = padded[0], padded[1]
        n_valid = y.shape[0]
        if n_valid < batcher.rows:
            # padding rows' indices become sentinels the layout drops
            # (zero pads would fabricate a heavy index 0); their margins
            # are dense-part-only and carry weight 0
            cat_p = cat_p.copy()
            cat_p[n_valid:] = num_features
        cap = (ell_ovf_cap if ell_ovf_cap is not None
               else max(1024, batcher.rows))
        lay = E.ell_layout(cat_p[None], num_features, pad_ovf_cap=cap,
                           pad_heavy_cap=ell_heavy_cap)
        return ((dense_p, lay.src[0], lay.pos[0], lay.mask[0])
                + (lay.ovf_idx[0], lay.ovf_src[0], lay.heavy_idx[0],
                   lay.heavy_cnt[0]) + padded[2:])

    if cache_decoded not in (True, False, "auto"):
        raise ValueError('cache_decoded must be True, False, or "auto", '
                         f"got {cache_decoded!r}")
    replay_cache: Optional[DecodedReplayCache] = None
    guard_tripped = False       # replay guard found an epoch-varying reader
    recorded_epochs = 0
    _rec_cache: list = [None]   # this epoch's recording target
    # block-keyed mode (epoch-varying + block-addressable readers):
    # decided once, at the fit's first reader
    block_mode: Optional[bool] = None
    block_cache: Optional[DecodedReplayCache] = None

    def route(item):
        """Prefetch transform over tagged source items: ``("dec", t)`` is
        an already-decoded replay batch, ``("blk", id, b)`` a block of a
        block-addressable reader, ``("rec", i, b)`` decodes + tees into
        the recording cache, ``("raw", b)`` just decodes."""
        tag = item[0]
        if tag == "dec":
            return item[1]
        if tag == "blk":
            bid, raw = item[1], item[2]
            cached = block_cache.get(bid)
            if cached is not None:
                if bid == block_cache.anchor_key:
                    # per-block-determinism contract check, one block an
                    # epoch
                    if batch_fingerprint(raw) != block_cache.fingerprint:
                        raise ValueError(
                            f"block-addressable reader violated the "
                            f"block_order contract: block {bid}'s "
                            f"content changed between epochs; pass "
                            f"cache_decoded=False for such readers")
                return cached
            host = to_host_batch(raw)
            if block_cache.anchor_key is None:
                block_cache.set_anchor(bid, batch_fingerprint(raw))
            block_cache.offer(bid, host)
            return host
        if tag == "rec":
            if item[1] == 0:
                # digest the raw batch: the replay guard re-reads batch 0
                _rec_cache[0].fingerprint = batch_fingerprint(item[2])
            elif item[1] & (item[1] - 1) == 0:
                # power-of-two indices: mid-stream anchors for the
                # seekable replay guard's second probe
                _rec_cache[0].probe_fingerprints[item[1]] = \
                    batch_fingerprint(item[2])
            host = to_host_batch(item[2])
            _rec_cache[0].offer(item[1], host)
            return host
        return to_host_batch(item[1])

    params = _zero_params(num_features, dev)
    if gr is not None and GR.needs_state(gr):
        params[GR_STATE_KEY] = GR.init_state(gr, dict(params), gr_mesh)
    loss_log: list = []
    prev_loss = float("inf")
    start_epoch = 0
    skip_steps = 0          # batches already consumed in start_epoch
    resume_loss_sum = None  # their accumulated loss
    resume_n_batches = 0
    global_step = 0         # checkpoint tick: total batches over all epochs

    if manager is not None and resume:
        restored = manager.restore_latest()
        if restored is not None:
            # restored[0] is the save-slot key, the global step; the
            # epoch rides under "train_epoch"
            global_step, saved, meta = restored
            params = _params_to_device(saved["params"], dev)
            start_epoch = int(meta["train_epoch"])
            skip_steps = int(meta["step_in_epoch"])
            resume_n_batches = int(meta["n_batches"])
            if resume_n_batches:
                resume_loss_sum = torch.as_tensor(
                    np.asarray(saved["loss_sum"], np.float32)).to(dev)
            prev_loss = float(meta["prev_loss"])
            loss_log = list(meta["loss_log"])
            if meta.get("converged"):
                # the checkpointed run had already hit the tol stop; it
                # drained at its return, so a converged resume does too
                gr_state = params.pop(GR_STATE_KEY, None)
                if gr_state is not None and GR.wants_overlap(gr):
                    params = _apply_drain(params, gr_state, config,
                                          gr_mesh)
                return _linear_state(params, stream_impl), loss_log

    def _publish_params(params):
        # reducer state is the trainer's own, never published
        return {k: params[k].cpu().numpy() for k in ("w", "b")}

    def _save(epoch, step_in_epoch, loss_sum, n_batches, converged=False):
        manager.save(global_step, {
            "params": params,
            "loss_sum": (loss_sum if loss_sum is not None
                         else torch.zeros((), dtype=torch.float32)),
        }, {
            "train_epoch": epoch, "step_in_epoch": step_in_epoch,
            "n_batches": n_batches, "prev_loss": prev_loss,
            "loss_log": loss_log, "converged": converged,
        })

    epoch_secs: list = []
    dispatch_log: list = []   # chunks per epoch
    probe = None
    step_trace: Dict[str, list] = {}
    if step_probe:
        from ...obs.probe import StepProbe

        probe = StepProbe.create(("loss",), W, device=dev)
    for epoch in range(start_epoch, config.max_epochs):
        t_epoch = time.perf_counter()
        rec_cache = None
        reader = None
        if block_mode is None and cache_decoded in (True, "auto") \
                and config.max_epochs > 1:
            reader = _reader_for_epoch(make_reader, epoch, retry_policy)
            block_mode = (getattr(reader, "epoch_varying", False)
                          and hasattr(reader, "block_order")
                          and hasattr(reader, "batch_rows"))
        if block_mode and cache_decoded in (True, "auto"):
            if reader is None:
                reader = _reader_for_epoch(make_reader, epoch, retry_policy)
            if block_cache is None:
                block_cache = DecodedReplayCache(
                    decoded_ram_budget if decoded_ram_budget is not None
                    else default_ram_budget())
            order = list(reader.block_order)
            skip = skip_steps if epoch == start_epoch else 0
            # resume mid-epoch: the factory rebuilds the reader's (seed,
            # epoch) permutation; trim the visit order to the position
            trimmed = order[skip:] if skip else order
            if batcher.rows is None:
                batcher.pin(int(reader.batch_rows))
            if hasattr(reader, "seek") and hasattr(reader, "read_batch"):
                # seekable: cache hits read no disk — only misses and the
                # once-per-epoch anchor check read raw
                def block_source(reader=reader, trimmed=trimmed,
                                 skip=skip):
                    anchor_checked = False
                    for i, bid in enumerate(trimmed):
                        cached = block_cache.get(bid)
                        if cached is not None:
                            if (bid == block_cache.anchor_key
                                    and not anchor_checked):
                                anchor_checked = True
                            else:
                                yield ("dec", cached)
                                continue
                        reader.seek((skip + i) * reader.batch_rows)
                        yield ("blk", bid, reader.read_batch())

                source = block_source()
            else:
                # seekless block reader: read + discard for hits; a short
                # epoch fails loudly instead of training on fewer blocks
                def counted_blocks(reader=reader, trimmed=trimmed,
                                   skip=skip):
                    n = 0
                    for bid, b in zip(trimmed, _seek_or_skip(reader, skip)):
                        n += 1
                        yield ("blk", bid, b)
                    if n < len(trimmed):
                        raise ValueError(
                            f"block-addressable reader yielded {n} "
                            f"batches but block_order promises "
                            f"{len(trimmed)}; the epoch would silently "
                            "train on fewer blocks")

                source = counted_blocks()
        else:
            replay_ok = replay_cache is not None and replay_cache.ready
            if replay_ok and cache_decoded == "auto":
                # replay guard: the cursor protocol does not promise
                # epoch-determinism, so re-read the first raw batch (and a
                # mid-stream one) and compare digests with the recording
                reader = _reader_for_epoch(make_reader, epoch, retry_policy)
                probe_it = iter(reader)
                probe_first = next(probe_it, None)
                probe_mismatch = False
                if hasattr(reader, "seek") and hasattr(reader, "batch_rows"):
                    mid_candidates = [
                        i for i in replay_cache.probe_fingerprints
                        if replay_cache.n_batches is None
                        or i < replay_cache.n_batches]
                    if mid_candidates:
                        mid = max(mid_candidates)
                        reader.seek(mid * int(reader.batch_rows))
                        probe_mid = next(iter(reader), None)
                        probe_mismatch = (
                            probe_mid is None
                            or batch_fingerprint(probe_mid)
                            != replay_cache.probe_fingerprints[mid])
                    reader.seek(0)
                else:
                    # generator-shaped reader: re-chain the consumed batch
                    reader = itertools.chain(
                        [] if probe_first is None else [probe_first],
                        probe_it)
                if (probe_mismatch or probe_first is None
                        or replay_cache.fingerprint is None
                        or batch_fingerprint(probe_first)
                        != replay_cache.fingerprint):
                    # one-way latch: a varying reader would be dropped
                    # again every epoch
                    replay_cache = None
                    replay_ok = False
                    guard_tripped = True
            if replay_ok and \
                    replay_cache.prefix_batches == replay_cache.n_batches:
                # the whole epoch is cached: the reader's disk is not read
                source = (("dec", t) for t in replay_cache.replay())
            else:
                if reader is None:
                    reader = _reader_for_epoch(make_reader, epoch,
                                               retry_policy)
                if epoch == start_epoch and skip_steps:
                    reader = _seek_or_skip(reader, skip_steps)
                if batcher.rows is None and hasattr(reader, "batch_rows"):
                    batcher.pin(int(reader.batch_rows))
                if replay_ok:
                    # partial prefix: replay what fit, re-decode the tail
                    tail = _seek_or_skip(reader, replay_cache.prefix_batches)
                    source = itertools.chain(
                        (("dec", t) for t in replay_cache.replay()),
                        (("raw", b) for b in tail))
                else:
                    # readers that DECLARE per-epoch variance are never
                    # recorded under "auto"
                    record = (config.max_epochs - epoch > 1
                              and not guard_tripped
                              and not (epoch == start_epoch and skip_steps)
                              and (cache_decoded is True
                                   or (cache_decoded == "auto"
                                       and _has_cursor(reader)
                                       and not getattr(
                                           reader, "epoch_varying",
                                           False))))
                    if record:
                        rec_cache = DecodedReplayCache(
                            decoded_ram_budget
                            if decoded_ram_budget is not None
                            else default_ram_budget())
                        _rec_cache[0] = rec_cache
                        source = (("rec", i, b)
                                  for i, b in enumerate(reader))
                    else:
                        source = (("raw", b) for b in reader)

        # a running on-device sum: memory stays flat over the epoch
        loss_sum = resume_loss_sum
        n_batches = resume_n_batches
        step_in_epoch = skip_steps
        n_dispatches = 0
        resume_loss_sum, resume_n_batches, skip_steps = None, 0, 0
        # the pipeline is closed explicitly on every exit: its teardown
        # joins the reader threads, so a supervised restart never races
        # a live reader for the shared source
        pipeline = prefetch_to_device(
            source, depth=chunk_depth, device=dev, transform=route,
            workers=prefetch_workers, put_workers=prefetch_put_workers,
            stats=prefetch_stats, chunks=W)
        try:
            for chunk, mask, n_valid in pipeline:
                if loss_sum is None:
                    loss_sum = torch.zeros((), dtype=torch.float32,
                                           device=dev)
                with tracer.span("train_chunk", cat="train",
                                 step=global_step + n_valid, epoch=epoch):
                    # span = host dispatch wall; completion is fenced by
                    # the probe fetch / the epoch-end loss read
                    if probe is not None:
                        params, loss_sum, probe = masked_chunk_scan(
                            update, params, loss_sum, chunk, mask,
                            probe=probe, n_valid=n_valid)
                    else:
                        params, loss_sum = masked_chunk_scan(
                            update, params, loss_sum, chunk, mask,
                            n_valid=n_valid)
                if probe is not None:
                    # ONE transfer at the chunk boundary
                    for k, v in probe.fetch().items():
                        step_trace.setdefault(k, []).append(v)
                    probe = probe.reset()
                n_batches += n_valid
                step_in_epoch += n_valid
                global_step += n_valid
                n_dispatches += 1
                # mid-epoch cuts land at chunk boundaries that crossed a
                # checkpoint_every_steps multiple (publish AFTER the save)
                if (checkpoint_every_steps > 0
                        and (manager is not None or publish_cb is not None)
                        and step_in_epoch // checkpoint_every_steps
                        > (step_in_epoch - n_valid)
                        // checkpoint_every_steps):
                    if manager is not None:
                        _save(epoch, step_in_epoch, loss_sum, n_batches)
                    if publish_cb is not None:
                        publish_cb(global_step,
                                   lambda p=params: _publish_params(p))
        finally:
            pipeline.close()
        if loss_sum is None:
            raise ValueError("make_reader() returned an empty epoch")
        dispatch_log.append(n_dispatches)
        if rec_cache is not None:
            rec_cache.finish(step_in_epoch)
            replay_cache = rec_cache
            recorded_epochs += 1
            _rec_cache[0] = None
        epoch_loss = float(loss_sum.item()) / n_batches
        t_now = time.perf_counter()
        epoch_secs.append(t_now - t_epoch)
        if tracer.enabled:
            tracer.add("train_epoch", t_epoch, t_now, cat="train",
                       epoch=epoch, step=global_step)
        loss_log.append(epoch_loss)
        stop = config.tol > 0 and abs(prev_loss - epoch_loss) <= config.tol
        if not stop:
            prev_loss = epoch_loss
        if manager is not None:
            _save(epoch + 1, 0, None, 0, converged=stop)  # epoch-boundary cut
        if publish_cb is not None:
            publish_cb(global_step, lambda p=params: _publish_params(p))
        if stop:
            break
    if stream_info is not None:
        stream_info["impl"] = stream_impl
        stream_info["steps_per_dispatch"] = W
        stream_info["dispatches_per_epoch"] = dispatch_log
        if step_probe:
            stream_info["step_trace"] = {
                k: (np.concatenate(v) if v else np.zeros((0,), np.float32))
                for k, v in step_trace.items()}
        if block_cache is not None:
            stream_info["decoded_cache_mode"] = "block"
            stream_info["decoded_cache_batches"] = len(block_cache)
            stream_info["decoded_cache_bytes"] = block_cache.cached_bytes
        else:
            cached = (replay_cache.prefix_batches
                      if replay_cache is not None and replay_cache.ready
                      else 0)
            stream_info["decoded_cache_batches"] = cached
            stream_info["decoded_cache_recorded_epochs"] = recorded_epochs
            if guard_tripped:
                stream_info["decoded_cache_guard_tripped"] = True
            if cached:
                stream_info["decoded_cache_bytes"] = \
                    replay_cache.cached_bytes
                stream_info["decoded_cache_total_batches"] = \
                    replay_cache.n_batches
        stream_info["epoch_seconds"] = [round(s, 4) for s in epoch_secs]
    gr_state = params.pop(GR_STATE_KEY, None)
    if gr_state is not None and GR.wants_overlap(gr):
        params = _apply_drain(params, gr_state, config, gr_mesh)
    return _linear_state(params, stream_impl), loss_log
