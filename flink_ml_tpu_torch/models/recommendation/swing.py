"""Swing — item-item similarity from user-item-user graph structure.

AlgoOperator: transform(user-item interaction table) -> one row per item
with its top-k similar items and scores:

    sim(i, j) = sum over unordered user pairs {u, v} in U_i ∩ U_j of
                w_u * w_v / (alpha2 + |I_u ∩ I_v|),
    w_u = (|I_u| + alpha1) ** -beta

After host-side id indexing and behavior filtering, the whole score
tensor is device matrix-product work over the binary user-item matrix B.
The user-pair kernel ``K[u,v] = w_u w_v / (alpha2 + |I_u ∩ I_v|)`` is
accumulated in USER CHUNKS — each chunk builds only a (chunk, n_users)
co-count slice, so memory stays O(chunk * n_users) instead of the full
O(n_users^2) kernel — and each item's similarity row is one product
over the chunk, rather than per-pair hash-set intersections.

A port of the JAX package's ``models/recommendation/swing.py``: the host
part (indexing, the dense B, the behavior filter, the seeded per-item
subsample) is the same numpy, so B is identical; the scores are f32
products in full f32 (the port never turns on
``torch.backends.cuda.matmul.allow_tf32``) on ``device`` (default
``"cuda"``; raises without a card unless ``"cpu"`` is asked for).  The
user weights use ``torch.pow``, which may differ from XLA's ``pow`` in
the last place.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ...api.stage import AlgoOperator
from ...data.table import Table
from ...params.param import FloatParam, IntParam, ParamValidators
from ...params.shared import HasSeed
from ...utils.device import resolve_device
from .als import ALSModelParams

__all__ = ["Swing", "SwingParams"]


class SwingParams(AlgoOperator, HasSeed):
    USER_COL = ALSModelParams.USER_COL
    ITEM_COL = ALSModelParams.ITEM_COL
    K = IntParam("k", "Max similar items per item.", default=100,
                 validator=ParamValidators.gt(0))
    MIN_USER_BEHAVIOR = IntParam(
        "minUserBehavior", "Drop users with fewer interactions.", default=10,
        validator=ParamValidators.gt(0))
    MAX_USER_BEHAVIOR = IntParam(
        "maxUserBehavior", "Drop users with more interactions.",
        default=1000, validator=ParamValidators.gt(0))
    MAX_USER_NUM_PER_ITEM = IntParam(
        "maxUserNumPerItem",
        "Random user subsample per item above this size.", default=1000,
        validator=ParamValidators.gt(0))
    ALPHA1 = IntParam("alpha1", "User-weight smoothing.", default=15,
                      validator=ParamValidators.gt_eq(0))
    ALPHA2 = IntParam("alpha2", "Pair-kernel smoothing.", default=0,
                      validator=ParamValidators.gt_eq(0))
    BETA = FloatParam("beta", "User-weight decay exponent.", default=0.3,
                      validator=ParamValidators.gt_eq(0.0))

    def get_user_col(self) -> str:
        return self.get(SwingParams.USER_COL)

    def set_user_col(self, value: str):
        return self.set(SwingParams.USER_COL, value)

    def get_item_col(self) -> str:
        return self.get(SwingParams.ITEM_COL)

    def set_item_col(self, value: str):
        return self.set(SwingParams.ITEM_COL, value)

    def get_k(self) -> int:
        return self.get(SwingParams.K)

    def set_k(self, value: int):
        return self.set(SwingParams.K, value)

    def get_min_user_behavior(self) -> int:
        return self.get(SwingParams.MIN_USER_BEHAVIOR)

    def set_min_user_behavior(self, value: int):
        return self.set(SwingParams.MIN_USER_BEHAVIOR, value)

    def get_max_user_behavior(self) -> int:
        return self.get(SwingParams.MAX_USER_BEHAVIOR)

    def set_max_user_behavior(self, value: int):
        return self.set(SwingParams.MAX_USER_BEHAVIOR, value)

    def get_max_user_num_per_item(self) -> int:
        return self.get(SwingParams.MAX_USER_NUM_PER_ITEM)

    def set_max_user_num_per_item(self, value: int):
        return self.set(SwingParams.MAX_USER_NUM_PER_ITEM, value)

    def get_alpha1(self) -> int:
        return self.get(SwingParams.ALPHA1)

    def set_alpha1(self, value: int):
        return self.set(SwingParams.ALPHA1, value)

    def get_alpha2(self) -> int:
        return self.get(SwingParams.ALPHA2)

    def set_alpha2(self, value: int):
        return self.set(SwingParams.ALPHA2, value)

    def get_beta(self) -> float:
        return self.get(SwingParams.BETA)

    def set_beta(self, value: float):
        return self.set(SwingParams.BETA, value)


# user-chunk size for the pair kernel: memory is O(chunk * n_users)
# instead of the full O(n_users^2) K matrix
_USER_CHUNK = 2048


def _swing_scores(B: torch.Tensor, alpha1: float, alpha2: float,
                  beta: float, user_chunk: int = _USER_CHUNK) -> torch.Tensor:
    """(n_users, n_items) binary f32 matrix -> (n_items, n_items) Swing
    similarity on ``B``'s device.  Unordered user pairs: ordered-sum / 2
    with a zeroed kernel diagonal.

    The user-pair kernel ``K[u, v] = w_u w_v / (alpha2 + |I_u ∩ I_v|)``
    is never materialised whole: ``S = Σ_chunks Mᶜᵀ (Kᶜ M)`` accumulates
    over user chunks in chunk order, where ``M[u, i] = B[u, i]`` masked
    per item — each chunk needs only a (chunk, n_users) slice of
    co-counts.  The per-item ``K @ Mv`` makes the total work
    ``O(n_users^2 * n_items^2)``: the chunking bounds memory, not
    compute (``maxUserNumPerItem`` thins B for large user counts)."""
    n_users, n_items = B.shape
    user_chunk = min(user_chunk, n_users)
    dev = B.device
    counts = torch.sum(B, dim=1)                          # |I_u|
    # zero-count users (filtered out) must carry zero weight — with
    # alpha1=0 their (0)**-beta would be inf and poison K via 0*inf=NaN
    w = torch.where(counts > 0, torch.pow(counts + alpha1, -beta), 0.0)
    BT = B.T.contiguous()                                 # (items, users)
    S = torch.zeros((n_items, n_items), dtype=B.dtype, device=dev)
    cols = torch.arange(n_users, device=dev)[None, :]
    for off in range(0, n_users, user_chunk):
        Bi = B[off:off + user_chunk]                      # (c, items)
        c = Bi.shape[0]
        uu = Bi @ BT                                      # (c, users)
        # a user pair in U_i ∩ U_j always shares >= 2 items, so uu == 0
        # pairs contribute nothing; zeroing also guards alpha2=0 division
        K = torch.where(uu > 0, (w[off:off + c, None] * w[None, :])
                        / (alpha2 + uu), 0.0)
        # exclude u == v (the diagonal lives where global index matches)
        rows = off + torch.arange(c, device=dev)[:, None]
        K = torch.where(rows == cols, 0.0, K)
        for i in range(n_items):
            b_i = BT[i]                                   # (users,)
            KM = K @ (B * b_i[:, None])                   # (c, items)
            S[i] += torch.sum(b_i[off:off + c, None] * Bi * KM, dim=0)
    return S / 2.0


class Swing(SwingParams):
    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device

    def interaction_matrix(self, table: Table):
        """``(item_vals, B)``: the item ids and the (n_users, n_items)
        binary f32 matrix the scores are computed over, after the
        behavior filter and the seeded per-item subsample."""
        users_raw = np.asarray(table[self.get_user_col()])
        items_raw = np.asarray(table[self.get_item_col()])
        user_vals, u_idx = np.unique(users_raw, return_inverse=True)
        item_vals, i_idx = np.unique(items_raw, return_inverse=True)
        n_users, n_items = len(user_vals), len(item_vals)

        B = np.zeros((n_users, n_items), np.float32)
        B[u_idx, i_idx] = 1.0

        # behavior filtering: users outside [min, max] interactions drop out
        per_user = B.sum(axis=1)
        keep = ((per_user >= self.get_min_user_behavior())
                & (per_user <= self.get_max_user_behavior()))
        B[~keep] = 0.0

        # per-item user-count cap: deterministic seeded subsample
        cap = self.get_max_user_num_per_item()
        rng = np.random.default_rng(self.get_seed())
        for j in range(n_items):
            users_j = np.flatnonzero(B[:, j])
            if len(users_j) > cap:
                drop = rng.choice(users_j, len(users_j) - cap, replace=False)
                B[drop, j] = 0.0
        return item_vals, B

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        dev = resolve_device(self.device)
        item_vals, B = self.interaction_matrix(table)
        n_items = len(item_vals)
        S = _swing_scores(torch.from_numpy(B).to(dev),
                          float(self.get_alpha1()), float(self.get_alpha2()),
                          float(self.get_beta())).cpu().numpy().astype(
                              np.float64)
        np.fill_diagonal(S, 0.0)

        k = self.get_k()
        sim_items = np.empty((n_items,), object)
        sim_scores = np.empty((n_items,), object)
        for j in range(n_items):
            order = np.argsort(-S[j], kind="stable")
            order = order[S[j][order] > 0][:k]
            sim_items[j] = list(item_vals[order])
            sim_scores[j] = [float(s) for s in S[j][order]]

        return [Table({
            self.get_item_col(): item_vals,
            "similar_items": sim_items,
            "scores": sim_scores,
        })]
