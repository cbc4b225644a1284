"""ALS — alternating least squares matrix factorization.

Supports explicit feedback (ALS-WR: per-row regularization scaled by the
row's rating count) and implicit feedback (Hu/Koren confidence weighting,
``c = 1 + alpha * |r|``).

One half-epoch (solve all users against fixed item factors):

- gather   — ``y = V[item_idx]`` for every rating, in fixed-size chunks so
             the (chunk, rank, rank) outer products stay bounded in device
             memory whatever nnz is
- reduce   — normal equations ``A`` (n_users, rank, rank), ``b`` and the
             observed counts, in one of two forms: ``'sorted'`` (ratings
             sorted by group once a fit on the host, so each chunk's
             groups form a narrow contiguous band and the reduce is one
             one-hot product and three slice adds a chunk) or
             ``'scatter'`` (a scatter-add a chunk)
- solve    — one batched Cholesky factorization and solve over all users

Both half-epochs make one epoch, driven by ``iterate`` in fused mode: the
factors stay on the device between epochs and the BSP loop never waits
for it.

Ratings with weight 0 contribute nothing (every normal-equation term is
scaled by the weight).  Users/items with no observed ratings, or whose
system fails to factor (``regParam`` 0 with fewer ratings than rank),
keep their previous factors.

A port of the JAX package's ``models/recommendation/als.py``, single
device.  Differences in mechanism, not in result:

- the sorted form walks its chunks in a Python loop with each band's
  start ``g_lo`` a host int (no device read a chunk);
- the scatter form sums through ``sgd._scatter_add_``: on the card the
  sort-based accumulation, in one fixed order (``index_add_`` adds with
  atomics there, in no fixed order), so a fit gives the same bits run
  after run; its last chunk is shorter where the JAX package pads it with
  zero weights (which add nothing);
- the solve factors with ``torch.linalg.cholesky_ex``, which reports a
  failed factorization in ``info`` where ``cho_factor`` leaves NaN, and
  masks on ``info`` and finiteness without a host read.

Matrix products run in full f32, as the JAX package pins with
``default_matmul_precision("highest")``: the port never turns on
``torch.backends.cuda.matmul.allow_tf32`` (off by default).  Every entry
point runs on ``device`` (default ``"cuda"``; raises without a card
unless ``"cpu"`` is asked for).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.stage import Estimator, Model
from ...data.table import Table
from ...iteration import (
    IterationBodyResult,
    IterationConfig,
    Workset,
    iterate,
)
from ...params.param import (
    BoolParam,
    FloatParam,
    IntParam,
    ParamValidators,
    StringParam,
)
from ...params.shared import HasMaxIter, HasPredictionCol, HasSeed
from ...utils import persist
from ...utils.device import resolve_device
from ..common.sgd import _scatter_add_

__all__ = ["ALS", "ALSModel", "ALSParams", "ALSModelParams"]

_CHUNK = 65536  # ratings per scatter step: (chunk, rank^2) is the high-water

#: sorted-path chunk: (chunk, rank^2) outer-product transient a step (134
#: MB at rank 64) — smaller than _CHUNK because the sorted path
#: materializes the outers for its one-hot product
_SORTED_CHUNK = 8192

#: 'auto' picks the sorted path only while every chunk's group band
#: stays this narrow: per-chunk product work scales with span, so
#: long-tail data (most groups with 1-2 ratings — the common
#: recommendation shape) can drive span toward the chunk size and make
#: the one-hot product orders of magnitude more work than the scatter it
#: replaces.  Span is known at host plan-build time, so the fallback is
#: free to decide.
_NEQ_AUTO_SPAN_CAP = 256


def _neq_plan_span(group_idx: np.ndarray, chunk: int = _SORTED_CHUNK) -> int:
    """The chunk-band span :class:`NeqPlan` would compute for
    ``group_idx``, WITHOUT the plan's O(nnz log nnz) argsort or its
    O(nnz) local-rank arrays: within a sorted chunk the band maximum
    sits at the chunk's last slot, so span needs only the sorted group
    value at each chunk boundary — and the sorted sequence is fully
    determined by ``np.bincount`` (each group id repeated by its
    count).  O(nnz + n_groups) time, O(n_groups) memory.  'auto' mode
    consults this BEFORE building a plan, so long-tail datasets — the
    common recommendation shape, which falls back to scatter — skip
    both argsorts entirely."""
    group_idx = np.asarray(group_idx)
    nnz = group_idx.shape[0]
    if nnz == 0:
        return 1
    chunk = int(min(chunk, nnz))
    cum = np.cumsum(np.bincount(group_idx))
    n_chunks = -(-nnz // chunk)
    starts = np.arange(n_chunks) * chunk
    # the plan pads the tail chunk by repeating the last sorted group,
    # so its band ends at sorted position nnz - 1
    ends = np.minimum(starts + chunk - 1, nnz - 1)
    lo = np.searchsorted(cum, starts, side="right")
    hi = np.searchsorted(cum, ends, side="right")
    return int((hi - lo).max()) + 1


class NeqPlan:
    """Static routing for :func:`_normal_equations_sorted` — one host
    sort per fit side (the ratings are fixed for the whole fit).

    Sorting by group makes each chunk's groups a NARROW CONTIGUOUS band
    ``[g_lo, g_lo + span)`` (``span`` = the largest band over chunks), so
    the normal-equation accumulation becomes one small product + one
    slice add per chunk instead of per-rating scatter-adds.  A group
    whose run crosses a chunk boundary simply keeps accumulating into the
    same rows from the next chunk — heavy groups need no special path.
    ``g_lo`` stays a host array: the chunk loop slices with its ints.
    """

    def __init__(self, group_idx: np.ndarray, chunk: int = _SORTED_CHUNK):
        group_idx = np.asarray(group_idx)
        nnz = group_idx.shape[0]
        self.chunk = int(min(chunk, max(nnz, 1)))
        self.order = np.argsort(group_idx, kind="stable").astype(np.int64)
        sg = group_idx[self.order].astype(np.int32)
        pad = (-nnz) % self.chunk
        if pad:
            sg = np.concatenate([sg, np.full(pad, sg[-1] if nnz else 0,
                                             np.int32)])
        self.nnz, self.pad = nnz, pad
        n_chunks = sg.shape[0] // self.chunk
        self.g_lo = sg[np.arange(n_chunks) * self.chunk].astype(np.int32)
        local = sg - np.repeat(self.g_lo, self.chunk)
        self.span = int(local.max(initial=0)) + 1
        self.local_rank = local.astype(np.int32)

    def sort_pad(self, a: np.ndarray, fill=0) -> np.ndarray:
        """``a`` reordered by the plan's sort, padded to the chunk
        multiple with ``fill`` (pad weights MUST be 0 — every
        accumulator term is weight-scaled, which is what makes the pad
        slots inert)."""
        out = np.asarray(a)[self.order]
        if self.pad:
            out = np.concatenate(
                [out, np.full((self.pad,) + out.shape[1:], fill,
                              out.dtype)])
        return out

    def side_data(self, other_idx: np.ndarray, ratings: np.ndarray,
                  weights: np.ndarray, device) -> tuple:
        """This side's sorted, padded ``(other_idx, ratings, weights,
        local_rank)`` on ``device``: what :func:`_solve_side_sorted`
        takes."""
        return (torch.from_numpy(self.sort_pad(other_idx.astype(np.int64)))
                .to(device),
                torch.from_numpy(self.sort_pad(ratings.astype(np.float32)))
                .to(device),
                torch.from_numpy(self.sort_pad(weights.astype(np.float32)))
                .to(device),
                torch.from_numpy(self.local_rank).to(device))


def _weights(r, w, implicit: bool, alpha: float):
    """The A-term and b-term weights of each rating: ``(w, w r)``, or
    Hu/Koren's ``(c - 1, c)`` weighted — ``conf_m1 = alpha |r| w`` and
    ``w + conf_m1`` (NOT ``(1 + conf_m1) w``, which would square
    fractional weights relative to the A term)."""
    if implicit:
        conf_m1 = alpha * torch.abs(r) * w
        return conf_m1, w + conf_m1
    return w, w * r


def _normal_equations_sorted(factors, other_idx, ratings, weights,
                             local_rank, g_lo, n_groups: int, span: int,
                             chunk: int, implicit: bool, alpha: float):
    """Sorted-path normal equations: inputs are PRE-SORTED by group and
    padded (see :class:`NeqPlan`); ``g_lo`` is the plan's host array.
    Equals :func:`_normal_equations` up to f32 summation order, with zero
    scatters."""
    rank = factors.shape[1]
    dev, dt = factors.device, factors.dtype
    span_iota = torch.arange(span, dtype=torch.int32, device=dev)
    # `span` rows of slack so the last band's slice stays in bounds
    A = torch.zeros((n_groups + span, rank * rank), dtype=dt, device=dev)
    b = torch.zeros((n_groups + span, rank), dtype=dt, device=dev)
    cnt = torch.zeros((n_groups + span,), dtype=dt, device=dev)
    for c, glo in enumerate(np.asarray(g_lo).tolist()):
        s = slice(c * chunk, (c + 1) * chunk)
        w = weights[s]
        y = factors[other_idx[s]]                        # (chunk, rank)
        oh = local_rank[s][:, None] == span_iota[None, :]  # (chunk, span)
        aw, bw = _weights(ratings[s], w, implicit, alpha)
        outer = (y[:, :, None] * y[:, None, :]).reshape(-1, rank * rank)
        A[glo:glo + span] += torch.where(oh, aw[:, None], 0.0).T @ outer
        b[glo:glo + span] += torch.where(oh, bw[:, None], 0.0).T @ y
        cnt[glo:glo + span] += torch.sum(torch.where(oh, w[:, None], 0.0),
                                         dim=0)
    return (A[:n_groups].reshape(n_groups, rank, rank), b[:n_groups],
            cnt[:n_groups])


class ALSModelParams(HasPredictionCol):
    USER_COL = StringParam("userCol", "User id column.", default="user")
    ITEM_COL = StringParam("itemCol", "Item id column.", default="item")

    def get_user_col(self) -> str:
        return self.get(ALSModelParams.USER_COL)

    def set_user_col(self, value: str):
        return self.set(ALSModelParams.USER_COL, value)

    def get_item_col(self) -> str:
        return self.get(ALSModelParams.ITEM_COL)

    def set_item_col(self, value: str):
        return self.set(ALSModelParams.ITEM_COL, value)


class ALSParams(ALSModelParams, HasMaxIter, HasSeed):
    RATING_COL = StringParam("ratingCol", "Rating column.", default="rating")
    RANK = IntParam("rank", "Factor dimension.", default=10,
                    validator=ParamValidators.gt_eq(1))
    REG_PARAM = FloatParam("regParam", "L2 regularization.", default=0.1,
                           validator=ParamValidators.gt_eq(0))
    IMPLICIT_PREFS = BoolParam(
        "implicitPrefs", "Implicit-feedback (confidence-weighted) mode.",
        default=False)
    ALPHA = FloatParam("alpha", "Implicit-feedback confidence scale.",
                       default=1.0, validator=ParamValidators.gt_eq(0))
    NEQ_IMPL = StringParam(
        "normalEquationsImpl",
        "Normal-equation accumulation: 'sorted' (default via 'auto') — "
        "one static host sort per fit turns the per-rating scatter-adds "
        "into chunked one-hot products over narrow contiguous group "
        "bands; 'scatter' keeps the scatter-add form.  Both are exact up "
        "to f32 summation order.",
        default="auto",
        validator=ParamValidators.in_array(("auto", "sorted", "scatter")))

    def get_rating_col(self) -> str:
        return self.get(ALSParams.RATING_COL)

    def set_rating_col(self, value: str):
        return self.set(ALSParams.RATING_COL, value)

    def get_rank(self) -> int:
        return self.get(ALSParams.RANK)

    def set_rank(self, value: int):
        return self.set(ALSParams.RANK, value)

    def get_reg_param(self) -> float:
        return self.get(ALSParams.REG_PARAM)

    def set_reg_param(self, value: float):
        return self.set(ALSParams.REG_PARAM, value)

    def get_implicit_prefs(self) -> bool:
        return self.get(ALSParams.IMPLICIT_PREFS)

    def set_implicit_prefs(self, value: bool):
        return self.set(ALSParams.IMPLICIT_PREFS, value)

    def get_alpha(self) -> float:
        return self.get(ALSParams.ALPHA)

    def set_alpha(self, value: float):
        return self.set(ALSParams.ALPHA, value)

    WORKSET_TOL = FloatParam(
        "worksetTol",
        "Delta/workset iteration threshold (0 disables): a user/item "
        "whose neighborhood factors all moved less than this (L2 row "
        "movement) last round keeps its previous factors — its solve "
        "result is masked out (the dense normal equations are still "
        "evaluated; the wall-clock win is that the loop exits as soon "
        "as every movement settles below the threshold, instead of "
        "always running maxIter epochs).  Approximate by construction "
        "(masked updates would have moved < tol); the fit records a "
        "per-round report in estimator.last_workset_report.",
        default=0.0, validator=ParamValidators.gt_eq(0))

    def get_workset_tol(self) -> float:
        return self.get(ALSParams.WORKSET_TOL)

    def set_workset_tol(self, value: float):
        return self.set(ALSParams.WORKSET_TOL, value)


def _normal_equations(factors, group_idx, other_idx, ratings, weights,
                      n_groups: int, implicit: bool, alpha: float):
    """Accumulate per-group A (n_groups, r, r), b (n_groups, r) and observed
    counts, through fixed-order scatter-adds over chunks of the ratings."""
    rank = factors.shape[1]
    dev, dt = factors.device, factors.dtype
    A = torch.zeros((n_groups, rank * rank), dtype=dt, device=dev)
    b = torch.zeros((n_groups, rank), dtype=dt, device=dev)
    cnt = torch.zeros((n_groups,), dtype=dt, device=dev)
    for start in range(0, group_idx.shape[0], _CHUNK):
        s = slice(start, start + _CHUNK)
        g, w = group_idx[s], weights[s]
        y = factors[other_idx[s]]                         # (chunk, rank)
        aw, bw = _weights(ratings[s], w, implicit, alpha)
        _scatter_add_(A, g, (aw[:, None, None] * y[:, :, None]
                             * y[:, None, :]).reshape(-1, rank * rank))
        _scatter_add_(b, g, bw[:, None] * y)
        _scatter_add_(cnt, g, w)
    return A.reshape(n_groups, rank, rank), b, cnt


def _solve_from_neq(prev, factors, A, b, cnt, reg: float, implicit: bool):
    """The solve tail shared by both normal-equation forms: regularize,
    batched Cholesky, keep previous factors for unobserved groups and for
    systems that fail to factor (``info != 0``: a failed factor may hold
    finite garbage) or solve to non-finite values."""
    rank = factors.shape[1]
    eye = torch.eye(rank, dtype=factors.dtype, device=factors.device)
    if implicit:
        gram = factors.T @ factors                         # shared Y^T Y
        A = A + gram[None, :, :] + reg * eye[None, :, :]
    else:
        # ALS-WR: per-row lambda scaled by the row's rating count.
        A = A + (reg * torch.clamp(cnt, min=1.0))[:, None, None] \
            * eye[None, :, :]
    chol, info = torch.linalg.cholesky_ex(A)
    solved = torch.cholesky_solve(b[..., None], chol)[..., 0]
    ok = (cnt > 0) & (info == 0) & torch.all(torch.isfinite(solved), dim=1)
    return torch.where(ok[:, None], solved, prev)


def _solve_side(prev, factors, group_idx, other_idx, ratings, weights,
                n_groups: int, reg: float, implicit: bool, alpha: float):
    """One half-epoch: re-solve ``prev``-side factors against fixed
    ``factors``.  Groups with zero observed weight keep their previous
    factors."""
    A, b, cnt = _normal_equations(factors, group_idx, other_idx, ratings,
                                  weights, n_groups, implicit, alpha)
    return _solve_from_neq(prev, factors, A, b, cnt, reg, implicit)


def _solve_side_sorted(prev, factors, plan: NeqPlan, other_idx, ratings,
                       weights, local_rank, n_groups: int, reg: float,
                       implicit: bool, alpha: float):
    """Sorted-path half-epoch (arrays pre-sorted by this side's group,
    :meth:`NeqPlan.side_data`)."""
    A, b, cnt = _normal_equations_sorted(
        factors, other_idx, ratings, weights, local_rank, plan.g_lo,
        n_groups, plan.span, plan.chunk, implicit, alpha)
    return _solve_from_neq(prev, factors, A, b, cnt, reg, implicit)


def als_epoch_step(n_users: int, n_items: int, reg: float, implicit: bool,
                   alpha: float, plans=None):
    """One ALS epoch (users then items) as an ``iterate`` body.

    ``plans=(plan_u, plan_v)`` (:class:`NeqPlan`) switches to the sorted
    normal equations — the data tuple is then the two sides'
    :meth:`NeqPlan.side_data` (8 tensors) instead of the raw ``(u_idx,
    i_idx, r, w)``."""

    def body(state, epoch, data):
        U, V = state
        if plans is None:
            u_idx, i_idx, r, w = data
            U = _solve_side(U, V, u_idx, i_idx, r, w, n_users, reg,
                            implicit, alpha)
            V = _solve_side(V, U, i_idx, u_idx, r, w, n_items, reg,
                            implicit, alpha)
        else:
            plan_u, plan_v = plans
            ou, ru, wu, lru, ov, rv, wv, lrv = data
            U = _solve_side_sorted(U, V, plan_u, ou, ru, wu, lru, n_users,
                                   reg, implicit, alpha)
            V = _solve_side_sorted(V, U, plan_v, ov, rv, wv, lrv, n_items,
                                   reg, implicit, alpha)
        return IterationBodyResult(feedback=(U, V))

    return body


def als_workset_epoch_step(n_users: int, n_items: int, reg: float,
                           implicit: bool, alpha: float, tol: float):
    """One workset ALS epoch: the delta-iteration form of
    :func:`als_epoch_step`.

    The workset masks the two factor sides independently
    (``mask={"users": (n_users,), "items": (n_items,)}``): a group stays
    active only while something in its NEIGHBORHOOD still moves — user
    ``u`` re-solves while any item it rated moved ≥ ``tol`` (L2 row
    movement) last round, and symmetrically for items.  A masked group
    keeps its previous factors; since its normal equations are built from
    neighbor rows that all moved < ``tol``, the discarded update would
    have been sub-threshold too — that is the approximation accepted in
    exchange for settling.  The dense solve is still evaluated each
    round; the saving is the exit: when every movement settles below
    ``tol`` both masks drain and the loop ends strictly before
    ``maxIter``.

    Uses the raw-index (scatter) data tuple — the movement aggregation
    needs the per-rating (user, item) ids that the sorted layout
    discards.  The neighbourhood maximum is a ``scatter_reduce_("amax")``:
    a max does not depend on the order it is taken in."""

    def body(state, ws, epoch, data):
        U, V = state
        u_idx, i_idx, r, w = data
        m_u, m_i = ws.mask["users"], ws.mask["items"]
        U_solved = _solve_side(U, V, u_idx, i_idx, r, w, n_users, reg,
                               implicit, alpha)
        U_new = torch.where(m_u[:, None] > 0, U_solved, U)
        V_solved = _solve_side(V, U_new, i_idx, u_idx, r, w, n_items, reg,
                               implicit, alpha)
        V_new = torch.where(m_i[:, None] > 0, V_solved, V)
        du = torch.sqrt(torch.sum(torch.square(U_new - U), dim=1))
        dv = torch.sqrt(torch.sum(torch.square(V_new - V), dim=1))
        # neighborhood max-movement via scatter-max over the ratings
        moved_u = torch.zeros_like(du).scatter_reduce_(
            0, u_idx, dv[i_idx], "amax", include_self=True)
        moved_i = torch.zeros_like(dv).scatter_reduce_(
            0, i_idx, du[u_idx], "amax", include_self=True)
        new_ws = Workset({"users": (moved_u >= tol).to(torch.float32),
                          "items": (moved_i >= tol).to(torch.float32)})
        return IterationBodyResult(feedback=((U_new, V_new), new_ws))

    return body


def init_factors(n_users: int, n_items: int, rank: int, seed: int):
    """The fit's start state ``(U0, V0)``: seeded normal draws scaled by
    ``1 / sqrt(rank)``, users first (the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(rank)
    U0 = (rng.normal(size=(n_users, rank)) * scale).astype(np.float32)
    V0 = (rng.normal(size=(n_items, rank)) * scale).astype(np.float32)
    return U0, V0


class ALSModel(ALSModelParams, Model):
    """Prediction: ``U[u] . V[i]`` per (user, item) row; ids unseen at fit
    time predict NaN (the "cold start = nan" convention)."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self._user_ids: Optional[np.ndarray] = None
        self._item_ids: Optional[np.ndarray] = None
        self._user_factors: Optional[np.ndarray] = None
        self._item_factors: Optional[np.ndarray] = None

    def set_model_data(self, *inputs) -> "ALSModel":
        (t,) = inputs
        self._user_ids = np.asarray(t["userIds"][0])
        self._item_ids = np.asarray(t["itemIds"][0])
        self._user_factors = np.asarray(t["userFactors"][0], np.float32)
        self._item_factors = np.asarray(t["itemFactors"][0], np.float32)
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"userIds": self._user_ids[None],
                       "itemIds": self._item_ids[None],
                       "userFactors": self._user_factors[None],
                       "itemFactors": self._item_factors[None]})]

    def _require_model(self) -> None:
        if self._user_factors is None:
            raise RuntimeError("ALSModel has no model data; call "
                               "set_model_data() or fit an ALS first")

    def _lookup(self, values, ids):
        """Map raw ids to dense indices; (indices, known_mask)."""
        idx = np.searchsorted(ids, values)
        idx = np.clip(idx, 0, len(ids) - 1)
        known = ids[idx] == values
        return idx.astype(np.int64), known

    def _factors(self, dev):
        return (torch.tensor(self._user_factors, device=dev),
                torch.tensor(self._item_factors, device=dev))

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        dev = resolve_device(self.device)
        users = np.asarray(table[self.get_user_col()])
        items = np.asarray(table[self.get_item_col()])
        u_idx, u_known = self._lookup(users, self._user_ids)
        i_idx, i_known = self._lookup(items, self._item_ids)
        U, V = self._factors(dev)
        preds = torch.sum(U[torch.from_numpy(u_idx).to(dev)]
                          * V[torch.from_numpy(i_idx).to(dev)], dim=1)
        preds = torch.where(torch.from_numpy(u_known & i_known).to(dev),
                            preds, float("nan")).cpu().numpy()
        return [table.with_column(self.get_prediction_col(),
                                  preds.astype(np.float64))]

    def recommend_for_users(self, users, k: int,
                            exclude: Optional[Table] = None) -> Table:
        """Top-k items per user: ONE ``U_sel @ V.T`` product on the device
        scores everything, then a host ``argpartition`` (O(items), not a
        full sort) ranks the k winners — the producer shape
        ``RankingEvaluator`` consumes (each output cell is that user's
        ranked item-id list).

        ``exclude`` optionally REMOVES already-seen (user, item) pairs
        (the usual train-interaction filter) given as a Table carrying
        this model's user/item columns; a user with fewer than k
        non-excluded items gets a shorter list.  Unknown user ids
        raise."""
        self._require_model()
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        k = min(k, len(self._item_ids))
        users = np.asarray(users)
        u_idx, known = self._lookup(users, self._user_ids)
        if not known.all():
            raise ValueError(
                f"unknown user id {users[~known][0]!r}; recommendations "
                "need users seen at fit time")

        dev = resolve_device(self.device)
        U, V = self._factors(dev)
        # a fresh host array: the exclude mask writes -inf in place
        scores = (U[torch.from_numpy(u_idx).to(dev)] @ V.T).cpu().numpy()
        if exclude is not None:
            eu_idx, eu_known = self._lookup(
                np.asarray(exclude[self.get_user_col()]), self._user_ids)
            ei_idx, ei_known = self._lookup(
                np.asarray(exclude[self.get_item_col()]), self._item_ids)
            valid = eu_known & ei_known
            eu, ei = eu_idx[valid], ei_idx[valid]
            # vectorized (pair -> request rows) expansion: request rows
            # sorted by user, each exclude pair covers its searchsorted
            # range (the ragged-range trick — no per-pair Python loop)
            order = np.argsort(u_idx, kind="stable")
            su = u_idx[order]
            left = np.searchsorted(su, eu, side="left")
            right = np.searchsorted(su, eu, side="right")
            counts = right - left
            total = int(counts.sum())
            if total:
                starts = np.repeat(left, counts)
                offsets = np.arange(total) - np.repeat(
                    np.cumsum(counts) - counts, counts)
                rows = order[starts + offsets]
                scores[rows, np.repeat(ei, counts)] = -np.inf

        part = np.argpartition(-scores, kth=k - 1, axis=1)[:, :k]
        part_scores = np.take_along_axis(scores, part, axis=1)
        rank = np.argsort(-part_scores, axis=1, kind="stable")
        top = np.take_along_axis(part, rank, axis=1)
        top_scores = np.take_along_axis(part_scores, rank, axis=1)

        recs = np.empty(len(users), object)
        rec_scores = np.empty(len(users), object)
        for r in range(len(users)):
            keep = ~np.isneginf(top_scores[r])   # drop excluded items
            recs[r] = list(self._item_ids[top[r][keep]])
            rec_scores[r] = [float(s) for s in top_scores[r][keep]]
        return Table({self.get_user_col(): users,
                      "recommendations": recs, "scores": rec_scores})

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {
            "userIds": self._user_ids, "itemIds": self._item_ids,
            "userFactors": self._user_factors,
            "itemFactors": self._item_factors})

    @classmethod
    def load(cls, path: str, device="cuda") -> "ALSModel":
        model = persist.load_stage_param(path)
        model.device = device
        data = persist.load_model_arrays(path, "model")
        model._user_ids = data["userIds"]
        model._item_ids = data["itemIds"]
        model._user_factors = data["userFactors"].astype(np.float32)
        model._item_factors = data["itemFactors"].astype(np.float32)
        return model


class ALS(ALSParams, Estimator[ALSModel]):
    """After a fit, ``planned_impl`` says which form carried it
    (``"sorted"``, ``"scatter"`` or ``"workset"``) and ``plan_spans``
    the sorted plan's ``(user, item)`` spans, or None."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self.last_workset_report: Optional[dict] = None
        self.planned_impl: Optional[str] = None
        self.plan_spans: Optional[tuple] = None

    def fit(self, *inputs) -> ALSModel:
        (table,) = inputs
        # the report describes THIS fit only
        self.last_workset_report = None
        self.plan_spans = None
        dev = resolve_device(self.device)
        users = np.asarray(table[self.get_user_col()])
        items = np.asarray(table[self.get_item_col()])
        ratings = np.asarray(table[self.get_rating_col()], np.float32)
        if len(ratings) == 0:
            raise ValueError("ALS.fit requires at least one rating")
        if self.get_implicit_prefs() and np.any(ratings < 0):
            raise ValueError("implicitPrefs expects non-negative ratings "
                             "(interaction strengths)")

        user_ids, u_idx = np.unique(users, return_inverse=True)
        item_ids, i_idx = np.unique(items, return_inverse=True)
        U0, V0 = init_factors(len(user_ids), len(item_ids), self.get_rank(),
                              self.get_seed())
        state = (torch.from_numpy(U0).to(dev), torch.from_numpy(V0).to(dev))
        weights = np.ones(len(ratings), np.float32)

        def raw():
            return tuple(torch.from_numpy(a).to(dev) for a in (
                u_idx.astype(np.int64), i_idx.astype(np.int64), ratings,
                weights))

        n_users, n_items = len(user_ids), len(item_ids)
        reg, implicit = self.get_reg_param(), self.get_implicit_prefs()
        alpha = self.get_alpha()

        ws_tol = self.get_workset_tol()
        if ws_tol > 0:
            self.planned_impl = "workset"
            ws0 = Workset({
                "users": torch.ones((n_users,), dtype=torch.float32,
                                    device=dev),
                "items": torch.ones((n_items,), dtype=torch.float32,
                                    device=dev)})
            result = iterate(
                als_workset_epoch_step(n_users, n_items, reg, implicit,
                                       alpha, ws_tol),
                state, raw(), max_epochs=self.get_max_iter(), workset=ws0,
                config=IterationConfig(mode="fused"))
            trace = result.side.get("epoch_trace", {})
            self.last_workset_report = {
                "rounds": result.num_epochs,
                "max_epochs": self.get_max_iter(),
                "active_fraction": np.asarray(
                    trace.get("active_fraction", ()), np.float64),
                "n_groups": n_users + n_items,
            }
            return self._model(user_ids, item_ids, result.state)

        neq_mode = self.get(ALSParams.NEQ_IMPL)
        plans = None
        # 'auto' bounds the span from a cheap bincount FIRST: the
        # long-tail common case falls back to scatter without ever
        # paying the plan's two O(nnz log nnz) argsorts
        if neq_mode == "sorted" or (
                neq_mode == "auto"
                and max(_neq_plan_span(u_idx), _neq_plan_span(i_idx))
                <= _NEQ_AUTO_SPAN_CAP):
            # one static host sort per side (the ratings are fixed for
            # the whole fit); the data ships pre-sorted
            plans = (NeqPlan(u_idx), NeqPlan(i_idx))
            self.plan_spans = (plans[0].span, plans[1].span)
            data = (plans[0].side_data(i_idx, ratings, weights, dev)
                    + plans[1].side_data(u_idx, ratings, weights, dev))
        else:
            data = raw()
        self.planned_impl = "sorted" if plans is not None else "scatter"
        result = iterate(
            als_epoch_step(n_users, n_items, reg, implicit, alpha,
                           plans=plans),
            state, data, max_epochs=self.get_max_iter(),
            config=IterationConfig(mode="fused"))
        return self._model(user_ids, item_ids, result.state)

    def _model(self, user_ids, item_ids, state) -> ALSModel:
        U, V = (x.cpu().numpy() for x in state)
        model = ALSModel(device=self.device)
        model.copy_params_from(self)
        model.set_model_data(Table({
            "userIds": user_ids[None], "itemIds": item_ids[None],
            "userFactors": U[None], "itemFactors": V[None]}))
        return model

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "ALS":
        stage = persist.load_stage_param(path)
        stage.device = device
        return stage
