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

A port of the single-device subset of the JAX package's
``models/common/sgd.py``.  Its meshes, its compressed gradient reduction
(``SGDConfig.grad_reduce``, which this ``SGDConfig`` does not have) and
its out-of-core fit (ROADMAP queue A3) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ...ops import ell_scatter as E
from ...utils.device import resolve_device

__all__ = ["SGDConfig", "LinearState", "sgd_fit", "sgd_fit_params",
           "sgd_fit_sparse", "sgd_fit_mixed", "plan_mixed_impl",
           "routing_chunk_steps", "plan_epoch_layout",
           "prepare_epoch_tensor", "resolve_global_batch_size"]

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


def _linear_update(loss_fn: LossFn, config: SGDConfig):
    """THE dense single-batch update: the autograd gradient of ``loss +
    l2/2 ||w||^2`` over ``xb @ w + b`` (vector or matrix ``w``), a plain
    step, then the l1 proximal soft-threshold.  The l2 term lives in the
    gradient here, not in :func:`_finish_sparse_step`'s decay before the
    step; the two are the same algebra in another f32 order."""
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
        new_w = params["w"] - lr * gw
        if l1 > 0:
            new_w = torch.sign(new_w) * torch.clamp(
                torch.abs(new_w) - lr * l1, min=0.0)
        new_b = params["b"] - (lr * gb if config.fit_intercept else 0.0)
        return {"w": new_w, "b": new_b}, value.detach()

    return update


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


def _sparse_update(loss_fn: LossFn, config: SGDConfig):
    """Single-batch update for the generic ``(indices, values)`` layout
    without the ELL routing: the margin is ``sum(values * w[indices])``
    and the gradient a direct scatter-add of ``-lr * values * r`` into the
    weight (``index_add``, in place of the JAX package's lane-blocked
    scatter, which is the same sum).  The path for widths the kernels
    reject or layouts over budget."""
    lr = config.learning_rate
    finish = _finish_sparse_step(config)

    def update(params, idx, vals, yb, wb):
        w, b = params["w"], params["b"]
        margin = torch.sum(vals * E.gather_weights(w, idx), dim=-1) + b
        value, r = _loss_and_r(loss_fn, margin, yb, wb)
        return finish(w, b, value, r, lambda w: w.index_add(
            0, idx.reshape(-1), (-lr * (vals * r[:, None])).reshape(-1)))

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
            w = w.index_add(0, cat.reshape(-1),
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
    mext = mext.index_add_(0, ovf_src, o)
    return mext[:batch] + w[heavy_idx] @ heavy_cnt.to(torch.float32)


def _apply_ell_categorical(lr, w, r, r_ext, src, pos, mask, ovf_idx,
                           ovf_src, heavy_idx, heavy_cnt, val_ell=None,
                           ovf_val=None, plain=False):
    """THE ELL gradient application: in-grid scatter kernel -> overflow
    scatter-add -> heavy-hitter matvec (padding entries carry zero counts
    and add 0 at w[0]).  The fused kernel runs on grids whose row count
    divides into 8-row blocks, the gather + pair kernel otherwise (the JAX
    package's plan).  Returns a new tensor; the overflow and heavy legs
    update it in place."""
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
    w.index_add_(0, ovf_idx, (-lr) * o)
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


def sgd_fit(loss_fn: LossFn, features: np.ndarray, labels: np.ndarray,
            weights: Optional[np.ndarray], config: SGDConfig,
            device="cuda") -> Tuple[LinearState, list]:
    """Train ``(w, b)`` on dense ``(n, d)`` features, minimizing
    ``loss_fn(margin, labels, weights) + reg * ((1-alpha)/2 ||w||^2 +
    alpha ||w||_1)`` (the l1 part by proximal soft-threshold after each
    step).  Returns the fitted state (planned "dense") and the per-epoch
    loss log.  Runs on ``device`` (default the card; raises without
    one)."""
    d = features.shape[1]
    params, loss_log = sgd_fit_params(
        loss_fn, features, labels, weights, config, device,
        init_params={"w": np.zeros((d,), np.float32),
                     "b": np.zeros((), np.float32)})
    return LinearState(np.asarray(params["w"], np.float64),
                       float(params["b"]), planned_impl="dense"), loss_log


def sgd_fit_params(loss_fn: LossFn, features: np.ndarray, labels: np.ndarray,
                   weights: Optional[np.ndarray], config: SGDConfig,
                   device="cuda", *, init_params: dict
                   ) -> Tuple[Dict[str, np.ndarray], list]:
    """The core behind :func:`sgd_fit`: trains any ``{"w", "b"}`` whose
    score is ``x @ w + b`` (vector ``w`` for the binary and regression
    models, a ``(d, classes)`` matrix for softmax), from ``init_params``
    (numpy or tensors).  ``loss_fn(scores, labels, weights)`` defines the
    objective; labels ride the epoch tensor as f32 (exact for class ids
    below 2^24: cast back inside the loss).  Returns the fitted parameters
    as f32 numpy and the per-epoch loss log."""
    dev = resolve_device(device)
    n = features.shape[0]
    steps, batch, perm = plan_epoch_layout(
        n, resolve_global_batch_size(config, n), 1, config.seed)
    X = prepare_epoch_tensor(features.astype(np.float32), perm, steps, batch)
    y, sw = _epoch_targets(labels, weights, perm, steps, batch)
    init = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in init_params.items()}
    params, loss_log = _run_minibatch_epochs(
        _linear_update(loss_fn, config),
        tuple(torch.from_numpy(a).to(dev) for a in (X, y, sw)), init, steps,
        config)
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
    card)."""
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
    PyTorch versions instead of the kernels (the oracle on the card)."""
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
