"""Histogram-based gradient-boosted trees — the shared trainer.

Member of the later Flink ML 2.x library line (GBTClassifier/GBTRegressor).
The histogram method with everything vectorized over rows:

- **Binning** (host, once): per-feature quantile bins -> int32 bin ids.
- **Histograms** (device): per level, the (grad, hess) sums of every
  ``(node, feature, bin)`` key for ALL nodes and features at once.
- **Split finding** (device): cumulative sums over bins give every candidate
  split's left/right (G, H); the XGBoost gain
  ``G_L^2/(H_L+l) + G_R^2/(H_R+l) - G^2/(H+l)`` is argmaxed per node.
- **Routing** (device): rows step to ``2*node+1 (+1)`` by comparing their
  bin to the split threshold — no gather-scatter trees, just arrays.

Trees are complete binary arrays (node i's children are 2i+1/2i+2); the
boosting loop runs hosted (each tree depends on the previous residuals).

A port of the JAX package's ``models/common/gbt.py``.  The two histogram
forms are ``"segsum"`` (a scatter-add over the flattened key through
``sgd._scatter_add_``, in row chunks on the card) and
``"mxu"`` (per feature, the product of ``(n, n_nodes)`` one-hots scaled
by the values with the ``(n, bins)`` bin one-hot, in f32: the port never
turns on ``torch.backends.cuda.matmul.allow_tf32``).  Neither, nor the
leaf sums, adds with atomics on the card (``index_add_`` does, in no
fixed order), so a fit gives the same bits run after run and the
streamed fit the same forest for any ``steps_per_dispatch``.
The two forms register as op ``gbt_level_histograms`` of the kernel
registry (backends ``"segsum"`` and ``"mxu"``), and ``HIST_IMPL = "auto"``
resolves through ``registry.lookup``.  Its static priority picks
``"segsum"``: the JAX package's pick on the CPU, and on an H100 the
faster form at every level of the bench shape (``chip_smoke.py`` phase
37 times both), where the JAX package gives ``"mxu"`` priority on the
TPU.  With a cache root configured (``FLINK_ML_TPU_AOT_CACHE_PATH``),
:func:`train_forest`'s first tree times both forms once on a slice of the
real binned rows and persists the winner (``_maybe_autotune_hist``,
``kernels/autotune.py``), which ``"auto"`` then resolves to in this and
every later process.  Every entry point runs on ``device`` (default
``"cuda"``; raises without a card unless ``"cpu"`` is asked for).
"""

from __future__ import annotations

import os

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ...utils.device import resolve_device
from .sgd import _scatter_add_

__all__ = ["GBTConfig", "bin_features", "train_forest", "predict_forest",
           "Forest", "SoftmaxForest", "train_forest_softmax",
           "predict_forest_softmax"]


@dataclass
class GBTConfig:
    num_trees: int = 20
    max_depth: int = 4            # levels of internal nodes
    learning_rate: float = 0.1
    max_bins: int = 64
    reg_lambda: float = 1.0
    min_child_weight: float = 1e-3
    #: out-of-core chunked dispatch: stack this many streamed batches
    #: into one device chunk (one host-to-device copy a chunk a pass).
    #: Short final chunks pad with zero-gradient batches, which are inert
    #: in every additive pass.  In-core training ignores it.  Each copy
    #: stages a ``(W, batch_device_rows, d)`` chunk — W times the
    #: per-batch staging.
    steps_per_dispatch: int = 8


@dataclass
class Forest:
    """(trees, nodes) arrays; node i's children are 2i+1 / 2i+2."""

    feature: np.ndarray       # (T, n_nodes) int32, -1 for leaf
    threshold: np.ndarray     # (T, n_nodes) int32 bin id: go left if <= thr
    value: np.ndarray         # (T, n_nodes) f32 leaf value
    bin_edges: np.ndarray     # (d, max_bins - 1) f64 quantile edges
    base_score: float
    learning_rate: float


def quantile_edges(X: np.ndarray, max_bins: int) -> np.ndarray:
    """Per-feature quantile edges (d, bins-1) — the sketch half of
    :func:`bin_features` (the out-of-core trainer needs only this from
    its bounded leading sample)."""
    d = X.shape[1]
    edges = np.empty((d, max_bins - 1))
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    for j in range(d):
        # duplicates collapse constant regions
        edges[j] = np.quantile(X[:, j], qs)
    return edges


def bin_features(X: np.ndarray, max_bins: int) -> Tuple[np.ndarray, np.ndarray]:
    """Quantile binning on host: (binned int32 (n, d), edges (d, bins-1))."""
    edges = quantile_edges(X, max_bins)
    return apply_bins(X, edges), edges


def apply_bins(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    binned = np.empty(X.shape, np.int32)
    for j in range(X.shape[1]):
        binned[:, j] = np.searchsorted(edges[j], X[:, j], side="left")
    return binned


def apply_bins_device(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Vectorized tensor twin of :func:`apply_bins`:
    ``bin = #edges strictly below x`` (== searchsorted side='left' for
    quantile edges), with NaN routed to the LAST bin exactly as
    np.searchsorted sorts it.  One (n, d, bins-1) compare+sum instead of a
    per-feature loop.

    Precision caveat: runs at the tensors' dtype (f32 in the tests), so
    rows within f32 rounding of an edge can bin differently from the f64
    host path; the out-of-core trainer host-bins to stay bit-identical
    with in-core training AND with predict-time binning."""
    count = torch.sum(X[:, :, None] > edges[None, :, :], dim=-1,
                      dtype=torch.int32)
    return torch.where(torch.isnan(X), edges.shape[1], count)


#: histogram implementation: "auto" (= "segsum"), "segsum" (force the
#: fixed-order scatter-add) or "mxu" (force the double one-hot product).
#: Module-level so a measurement can force either; both are exact up to
#: f32 summation order.
HIST_IMPL = "auto"

#: rows a chunk of the card's key sums, and the most (chunk, key) slots
#: they may take: the sort-based scatter-add sums each key's run of rows
#: serially (on an H100, unchunked, the leaf sums of one tree over 2^19
#: rows took ~0.3 s), so rows split into chunks whose runs sum side by
#: side, and the chunk sums then add in chunk order
_CARD_CHUNK_ROWS = 256
_CARD_CHUNK_SLOTS = 1 << 24


def _key_sums(keys, grad, hess, segments: int):
    """Per-key sums of (grad, hess) over rows, in a fixed order: ``keys``
    is ``(n,)`` or ``(n, k)`` (a row's values add once per key of the
    row).  On the CPU one ``index_add_`` of each value (a serial loop in
    row order, what ``jax.ops.segment_sum`` computes there); on the card
    one sort-based scatter-add of the pairs
    (:func:`~.sgd._scatter_add_`) over keys made distinct per chunk of
    rows, then the chunk sums in chunk order."""
    per = keys.numel() // max(keys.shape[0], 1)

    def spread(v):
        return v if per == 1 else v[:, None].expand(-1, per).reshape(-1)

    if not grad.is_cuda:
        flat = keys.reshape(-1)
        return tuple(_scatter_add_(
            torch.zeros((segments,), dtype=v.dtype), flat, spread(v))
            for v in (grad, hess))
    n = keys.shape[0]
    chunks = max(1, min(-(-n // _CARD_CHUNK_ROWS),
                        _CARD_CHUNK_SLOTS // segments))
    rows = -(-n // chunks)
    chunk = torch.div(torch.arange(n, device=keys.device), rows,
                      rounding_mode="floor")
    ckeys = (chunk.view(-1, *([1] * (keys.dim() - 1))) * segments
             + keys).reshape(-1)
    vals = torch.stack([spread(grad), spread(hess)], dim=1)
    out = torch.zeros((chunks * segments, 2), dtype=grad.dtype,
                      device=grad.device)
    _scatter_add_(out, ckeys, vals)
    out = out.view(chunks, segments, 2).sum(dim=0)
    return out[:, 0], out[:, 1]


def _level_histograms_segsum(binned, node_ids, grad, hess, n_nodes: int,
                             d: int, bins: int):
    """segment_sum form: (grad, hess) summed per (node, feature, bin) key
    of each (row, feature), in a fixed order (:func:`_key_sums`)."""
    live = node_ids >= 0
    safe_node = torch.where(live, node_ids, 0)
    # (node, feature, bin) -> flat key; dead rows land in a scratch key 0
    # with zero weights
    keys = (safe_node[:, None] * (d * bins)
            + torch.arange(d, dtype=torch.int32,
                           device=binned.device)[None, :] * bins
            + binned)                                           # (n, d)
    w = live.to(grad.dtype)
    g_hist, h_hist = _key_sums(keys, grad * w, hess * w, n_nodes * d * bins)
    return (g_hist.reshape(n_nodes, d, bins),
            h_hist.reshape(n_nodes, d, bins))


def _level_histograms_mxu(binned, node_ids, grad, hess, n_nodes: int,
                          d: int, bins: int):
    """One-hot product form: hist[node, f, bin] = (onehot_node *
    value)^T @ onehot_bin_f — histogramming as (2 n_nodes) x n x bins
    products in f32 (no scatter anywhere), one a feature so the transient
    one-hots stay at (n, 2 n_nodes) + (n, bins)."""
    live = node_ids >= 0
    safe_node = torch.where(live, node_ids, 0)
    w = live.to(grad.dtype)
    dev = binned.device
    # (n, n_nodes) one-hots pre-scaled by the two accumulated values —
    # rows of dead nodes carry zeros, so scratch-node pollution is moot
    node_oh = (safe_node[:, None]
               == torch.arange(n_nodes, dtype=torch.int32,
                               device=dev)[None, :])
    zero = torch.zeros((), dtype=grad.dtype, device=dev)
    vals_t = torch.cat([torch.where(node_oh, (grad * w)[:, None], zero),
                        torch.where(node_oh, (hess * w)[:, None], zero)],
                       dim=1).t()                               # (2N, n)
    eye = torch.eye(bins, dtype=grad.dtype, device=dev)
    out = torch.stack([vals_t @ eye[binned[:, f]] for f in range(d)],
                      dim=1)                                    # (2N, d, b)
    return out[:n_nodes], out[n_nodes:]


#: the dispatch table — unknown HIST_IMPL values raise KeyError instead
#: of silently running the wrong implementation
_HIST_IMPLS = {"segsum": _level_histograms_segsum,
               "mxu": _level_histograms_mxu}


def resolve_hist_impl(name: str = None) -> str:
    """Resolve a histogram impl name ("auto" -> the kernel registry's pick;
    "segsum"/"mxu" force) to a concrete ``_HIST_IMPLS`` key.  With no
    recorded decision "auto" is "segsum" on both devices (its priority):
    on an H100 at the bench shape a level took 4.8-5.5 ms "segsum"
    against 14.8-15.1 ms "mxu" (``chip_smoke.py`` phase 37, PERF.md §6).
    Unknown names raise KeyError — never a silent fallback."""
    name = HIST_IMPL if name is None else name
    if name == "auto":
        from ...kernels.registry import lookup

        return lookup("gbt_level_histograms").backend
    if name not in _HIST_IMPLS:
        raise KeyError(name)
    return name


def _level_histograms(binned, node_ids, grad, hess, n_nodes: int,
                      d: int, bins: int):
    """Per-(node, feature, bin) grad/hess sums for one level — the
    ADDITIVE piece of split finding: the out-of-core trainer accumulates
    these over streamed batches and decides splits from the totals.
    Dispatches on :data:`HIST_IMPL` through :func:`resolve_hist_impl`."""
    return _HIST_IMPLS[resolve_hist_impl()](
        binned, node_ids, grad, hess, n_nodes, d, bins)


def _level_splits(g_hist, h_hist, reg_lambda: float,
                  min_child_weight: float):
    """Best (feature, bin, gain) per node from the level histograms
    (``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does)."""
    n_nodes, d, bins = g_hist.shape
    g_tot = torch.sum(g_hist, dim=(1, 2)) / d                   # per node
    h_tot = torch.sum(h_hist, dim=(1, 2)) / d

    # candidate split at bin b: left = bins <= b (cumsum), right = rest
    g_left = torch.cumsum(g_hist, dim=2)
    h_left = torch.cumsum(h_hist, dim=2)
    g_right = g_tot[:, None, None] - g_left
    h_right = h_tot[:, None, None] - h_left

    def score(g, h):
        return g * g / (h + reg_lambda)

    gain = (score(g_left, h_left) + score(g_right, h_right)
            - score(g_tot, h_tot)[:, None, None])               # (nodes,d,bins)
    viable = ((h_left >= min_child_weight)
              & (h_right >= min_child_weight))
    gain = torch.where(viable, gain, -torch.inf)
    # never split on the last bin (empty right side by construction)
    gain[:, :, -1] = -torch.inf

    flat_gain = gain.reshape(n_nodes, d * bins)
    best = torch.argmax(flat_gain, dim=1)
    best_gain = torch.gather(flat_gain, 1, best[:, None])[:, 0]
    best_feature = torch.div(best, bins, rounding_mode="floor").to(
        torch.int32)
    best_bin = (best % bins).to(torch.int32)
    return best_feature, best_bin, best_gain


def _row_bins(binned, feature):
    """``binned[i, feature[i]]`` for every row i."""
    return torch.gather(binned, 1, feature.long()[:, None])[:, 0]


def _apply_split(binned, node_ids, best_feature, best_bin, best_gain):
    """Route live rows through the level's chosen splits: 2*node (+1 for
    right) in the next level's local numbering, -1 where the node did not
    split."""
    live = node_ids >= 0
    safe_node = torch.where(live, node_ids, 0)
    row_bin = _row_bins(binned, best_feature[safe_node])
    goes_right = row_bin > best_bin[safe_node]
    node_split = best_gain[safe_node] > 0
    return torch.where(live & node_split,
                       2 * safe_node + goes_right.to(torch.int32), -1)


def _build_level(binned, node_ids, grad, hess, n_nodes: int,
                 d: int, bins: int, reg_lambda: float,
                 min_child_weight: float, hist_impl: str = "segsum"):
    """One tree level for all ``n_nodes`` nodes at once
    (histograms -> splits -> routing; the three pieces are separate
    functions so the out-of-core trainer can accumulate histograms over
    batches and reuse the identical split/routing math).

    Returns (feature (n_nodes,), threshold (n_nodes,), gain (n_nodes,),
    new_node_ids (n,)).  ``node_ids`` are level-local in [0, n_nodes) with
    -1 marking rows already settled in a leaf.
    """
    g_hist, h_hist = _HIST_IMPLS[resolve_hist_impl(hist_impl)](
        binned, node_ids, grad, hess, n_nodes, d, bins)
    best_feature, best_bin, best_gain = _level_splits(
        g_hist, h_hist, reg_lambda, min_child_weight)
    new_ids = _apply_split(binned, node_ids, best_feature, best_bin,
                           best_gain)
    return best_feature, best_bin, best_gain, new_ids


def _leaf_sums(node_ids, grad, hess, n_nodes: int):
    """Per-node (G, H) sums in a fixed order (:func:`_key_sums`) — the
    additive form of :func:`_leaf_values` for streamed batches."""
    live = node_ids >= 0
    safe = torch.where(live, node_ids, 0)
    w = live.to(grad.dtype)
    return _key_sums(safe, grad * w, hess * w, n_nodes)


def _leaf_values(node_ids, grad, hess, n_nodes: int, reg_lambda: float):
    """Newton leaf weights -G/(H+lambda) for every level-local node."""
    g, h = _leaf_sums(node_ids, grad, hess, n_nodes)
    return -g / (h + reg_lambda)


def _tree_rows(level_splits, level_values, depth: int):
    """The complete tree's ``(feature, threshold, value)`` rows on the
    device from the per-level ``(feature, bin, gain)`` splits and the
    per-level leaf values: internal nodes that split get (feature,
    threshold); every other node becomes a leaf holding the Newton value
    of the rows that stopped there."""
    dev = level_values[0].device
    feature, threshold, value = [], [], []
    for (f, b, gain), vals in zip(level_splits, level_values):
        split = gain > 0
        feature.append(torch.where(split, f, -1))
        threshold.append(b)
        value.append(torch.where(split, 0.0, vals))
    # deepest level: always leaves
    n_leaves = 2 ** depth
    feature.append(torch.full((n_leaves,), -1, dtype=torch.int32,
                              device=dev))
    threshold.append(torch.zeros((n_leaves,), dtype=torch.int32,
                                 device=dev))
    value.append(level_values[depth])
    return torch.cat(feature), torch.cat(threshold), torch.cat(value)


def _rows_to_host(feature, threshold, value):
    """The three tree rows in one device-to-host copy."""
    packed = torch.stack([feature, threshold,
                          value.view(torch.int32)]).cpu().numpy()
    return (packed[0].copy(), packed[1].copy(),
            packed[2].view(np.float32).copy())


def _train_one_tree(binned, g, h, d: int, config: GBTConfig):
    """Grow one tree against device gradients/hessians; returns the host
    (feature, threshold, value) node rows plus the tree's DEVICE in-sample
    prediction (margin scale, before learning-rate shrinkage).  The levels
    chain on the device; the tree reaches the host in one copy."""
    n = binned.shape[0]
    bins = config.max_bins
    depth = config.max_depth
    impl = resolve_hist_impl()

    node_ids = torch.zeros((n,), dtype=torch.int32, device=binned.device)
    level_splits = []
    level_ids = [node_ids]
    for level in range(depth):
        f, b, gain, node_ids = _build_level(
            binned, node_ids, g, h, 2 ** level, d, bins,
            config.reg_lambda, config.min_child_weight, hist_impl=impl)
        level_splits.append((f, b, gain))
        level_ids.append(node_ids)
    # leaf value for rows that STOP at each level (their node did not
    # split): computed from the ids entering the level
    level_values = [_leaf_values(level_ids[level], g, h, 2 ** level,
                                 config.reg_lambda)
                    for level in range(depth + 1)]
    rows = _tree_rows(level_splits, level_values, depth)
    # in-sample update reuses the DEVICE binned copy
    pred = _predict_tree_device(binned, *rows, depth)
    return (*_rows_to_host(*rows), pred)


def _maybe_autotune_hist(binned, g, h, d: int, bins: int) -> None:
    """First-encounter autotune of the histogram form: with a cache root
    configured and several registry backends available, time each on a
    slice of at most 8192 rows of the real binned data (4 nodes) and
    persist the winner; ``resolve_hist_impl("auto")`` then resolves to it
    through ``registry.lookup`` in this and every later process.  A
    recorded decision short-circuits (no search)."""
    from ...kernels import autotune
    from ...kernels.registry import backends, lookup

    if HIST_IMPL != "auto" or not autotune.enabled():
        return
    avail = [b for b in backends("gbt_level_histograms")
             if lookup("gbt_level_histograms", backend=b).is_available()]
    if len(avail) < 2:
        return
    rows = min(int(binned.shape[0]), 8192)
    bp, gp, hp = binned[:rows], g[:rows], h[:rows]
    ids = torch.zeros((rows,), dtype=torch.int32, device=binned.device)

    def runner(backend):
        impl = lookup("gbt_level_histograms", backend=backend).fn
        return lambda: impl(bp, ids, gp, hp, 4, d, bins)

    autotune.choose("gbt_level_histograms", (),
                    {b: runner(b) for b in avail},
                    probe=f"real-data slice rows={rows} d={d} bins={bins} "
                          "n_nodes=4")


def train_forest(X: np.ndarray, y: np.ndarray,
                 grad_hess: Callable[[np.ndarray, np.ndarray],
                                     Tuple[np.ndarray, np.ndarray]],
                 base_score: float, config: GBTConfig,
                 device="cuda") -> Forest:
    """Boost ``num_trees`` trees against ``grad_hess(y, pred)`` (host
    numpy, f64) on ``device``."""
    dev = resolve_device(device)
    n, d = X.shape
    binned_host, edges = bin_features(X, config.max_bins)
    binned = torch.from_numpy(binned_host).to(dev)
    n_nodes_total = 2 ** (config.max_depth + 1) - 1

    features = np.full((config.num_trees, n_nodes_total), -1, np.int32)
    thresholds = np.zeros((config.num_trees, n_nodes_total), np.int32)
    values = np.zeros((config.num_trees, n_nodes_total), np.float32)

    pred = np.full((n,), base_score, np.float64)
    for t in range(config.num_trees):
        g, h = grad_hess(y, pred)
        gd = torch.from_numpy(np.asarray(g, np.float32)).to(dev)
        hd = torch.from_numpy(np.asarray(h, np.float32)).to(dev)
        if t == 0:
            _maybe_autotune_hist(binned, gd, hd, d, config.max_bins)
        features[t], thresholds[t], values[t], tree_pred = _train_one_tree(
            binned, gd, hd, d, config)
        pred = pred + config.learning_rate * tree_pred.cpu().numpy().astype(
            np.float64)

    return Forest(features, thresholds, values, edges, base_score,
                  config.learning_rate)


def _route_to_level(binned, feature_rows, threshold_rows, level: int):
    """Node ids entering ``level`` by walking the assembled tree-so-far
    (level-major layout; ``feature == -1`` marks a non-splitting node,
    matching :func:`_apply_split`'s ``gain > 0`` routing exactly)."""
    ids = torch.zeros((binned.shape[0],), dtype=torch.int32,
                      device=binned.device)
    base = 0
    for lvl in range(level):
        live = ids >= 0
        safe = torch.where(live, ids, 0)
        gnode = base + safe
        f = feature_rows[gnode]
        thr = threshold_rows[gnode]
        split = f >= 0
        row_bin = _row_bins(binned, torch.clamp_min(f, 0))
        ids = torch.where(live & split,
                          2 * safe + (row_bin > thr).to(torch.int32), -1)
        base += 2 ** lvl
    return ids


def _chunk_level_histograms(binned_c, g_c, h_c, feature_rows,
                            threshold_rows, g_init, h_init, level: int,
                            n_nodes: int, d: int, bins: int,
                            hist_impl: str):
    """Chunked histogram pass: the level histograms of a whole (W, rows,
    d) chunk, batch by batch.  The RUNNING histograms come in as
    ``g_init``/``h_init``, so accumulation stays strictly per-batch
    sequential across chunk boundaries — f32 addition is
    non-associative, and summing each chunk separately would make the
    result W-dependent.  Zero-gradient (padding) batches add exact
    zeros."""
    hist = _HIST_IMPLS[resolve_hist_impl(hist_impl)]
    g_hist, h_hist = g_init, h_init
    for b, g, h in zip(binned_c, g_c, h_c):
        ids = _route_to_level(b, feature_rows, threshold_rows, level)
        gh, hh = hist(b, ids, g, h, n_nodes, d, bins)
        g_hist, h_hist = g_hist + gh, h_hist + hh
    return g_hist, h_hist


def _chunk_leaf_sums(binned_c, g_c, h_c, feature_rows, threshold_rows,
                     depth: int, n_nodes: int):
    """Chunked leaf-sum pass: stacked per-batch (G, H) node sums (kept
    per-batch so the f64 accumulation order stays per-batch, whatever
    W)."""
    sums = [_leaf_sums(_route_to_level(b, feature_rows, threshold_rows,
                                       depth), g, h, n_nodes)
            for b, g, h in zip(binned_c, g_c, h_c)]
    return (torch.stack([s[0] for s in sums]),
            torch.stack([s[1] for s in sums]))


def _chunk_tree_preds(binned_c, feature, threshold, value, depth: int):
    """Chunked margin pass: stacked (W, rows) tree predictions."""
    return torch.stack([_predict_tree_device(b, feature, threshold, value,
                                             depth) for b in binned_c])


def train_forest_outofcore(make_reader, grad_hess, base_score,
                           config: GBTConfig, *,
                           features_key: str = "features",
                           label_key: str = "label",
                           work_dir: Optional[str] = None,
                           sample_rows: int = 1 << 18,
                           batch_device_rows: int = 1 << 16,
                           device="cuda") -> Forest:
    """Out-of-core :func:`train_forest`: the dataset streams from
    ``make_reader()`` (a fresh iterator of host batch dicts per call —
    the ``sgd_fit_outofcore`` protocol, but STRICTLY zero-arg and
    order-stable: the margin memmap is aligned to ROW ORDER across passes
    — every call must yield the same rows in the same order, or margins
    silently desynchronize.  A ``lambda epoch:`` factory fails loudly
    with a TypeError; a zero-arg factory that varies order per call is
    the caller's contract violation and cannot be detected here)
    instead of living in host or device memory.

    Design: histogram building is ADDITIVE over row batches, so each tree
    level is one streamed pass accumulating the level histograms on the
    device, followed by the same ``_level_splits`` decision the in-core
    path uses — the classic out-of-core GBDT recipe.

    - Bin edges come from the stream's leading ``sample_rows`` rows
      (quantile sketching on a bounded sample); each batch then bins
      through the HOST searchsorted (bit-identical to in-core training
      and to predict-time binning; see :func:`apply_bins_device` for why
      the f32 device variant is not used here).
    - The binned matrix is written once to a :class:`DataCacheWriter`
      cache in a fresh run directory under ``work_dir`` (uint8 when
      ``max_bins <= 256``: 4x smaller than the raw f32 stream, and the
      bytes each chunk copies to the device), every later pass replays
      the cache, and the run directory is removed on return (margins
      included).
    - Per-row boosting margins live in a disk-backed memmap (float64,
      8 bytes/row — the only O(n) state).
    - ``base_score`` may be a float or a callable receiving the leading
      sample's labels.

    Passes per tree: ``max_depth`` histogram passes + one leaf-sum pass +
    one margin-update pass.  Results match :func:`train_forest` on the
    same rows up to f32 accumulation order (asserted in tests).  Runs on
    ``device``.
    """
    import shutil
    import tempfile

    from ...data.datacache import DataCacheReader, DataCacheWriter

    dev = resolve_device(device)
    bins = config.max_bins

    # pass A: edges (and optionally the base score) from the leading sample
    sample: List[np.ndarray] = []
    sample_y: List[np.ndarray] = []
    seen = 0
    for batch in make_reader():
        sample.append(np.asarray(batch[features_key], np.float64))
        sample_y.append(np.asarray(batch[label_key], np.float64))
        seen += len(sample[-1])
        if seen >= sample_rows:
            break
    if not sample:
        raise ValueError("make_reader() returned an empty stream")
    Xs = np.concatenate(sample)[:sample_rows]
    d = Xs.shape[1]
    edges = quantile_edges(Xs, bins)
    if callable(base_score):
        base_score = float(base_score(np.concatenate(sample_y)[:sample_rows]))
    del sample, sample_y, Xs

    # pass B: binned cache + labels, in a unique per-fit run directory
    # (DataCacheWriter refuses dirty directories; retries and repeated
    # fits against one work_dir must each get a fresh cache)
    if work_dir is not None:
        os.makedirs(work_dir, exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="gbt-run-", dir=work_dir)
    try:
        cache_dir = os.path.join(run_dir, "binned")
        bin_dtype = np.uint8 if bins <= 256 else np.int32
        writer = DataCacheWriter(cache_dir, segment_rows=1 << 20)
        n = 0
        for batch in make_reader():
            X = np.asarray(batch[features_key], np.float64)
            b = apply_bins(X, edges).astype(bin_dtype)
            writer.append({"binned": b,
                           "label": np.asarray(batch[label_key],
                                               np.float64)})
            n += len(b)
        writer.finish()
        margins = np.memmap(os.path.join(run_dir, "margins.f64"),
                            np.float64, mode="w+", shape=(n,))
        margins[:] = base_score

        def cache_batches():
            """(slice, binned HOST in the cache's dtype, y f64, margins
            f64) batches — host-side so the chunked passes stack W
            batches and pay one device copy per chunk."""
            reader = DataCacheReader(cache_dir,
                                     batch_rows=batch_device_rows)
            start = 0
            for batch in reader:
                rows = len(batch["label"])
                sl = slice(start, start + rows)
                start += rows
                yield (sl, batch["binned"],
                       np.asarray(batch["label"], np.float64), margins[sl])

        return _boost_outofcore(cache_batches, margins, grad_hess,
                                base_score, edges, n, d, config, dev)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _boost_outofcore(cache_batches, margins, grad_hess, base_score: float,
                     edges: np.ndarray, n: int, d: int,
                     config: GBTConfig, dev: torch.device) -> Forest:
    bins = config.max_bins
    depth = config.max_depth
    W = max(1, int(config.steps_per_dispatch))
    impl = resolve_hist_impl()

    # Chunked dispatch (config.steps_per_dispatch): every streamed pass
    # stacks W batches into one (W, rows, d) device chunk — one
    # host-to-device copy per chunk instead of one per batch.  Rows pad
    # to the first batch's count and short final chunks pad with whole
    # zero batches: zero gradients/hessians make every padded slot an
    # exact no-op in the additive passes, and the margin pass writes back
    # only each real batch's real rows.
    def chunked_batches(need_gh: bool):
        """Yield (sls, binned_c (W, R, d) device i32, g_c, h_c (W, R)
        device f32 or None): ``sls`` lists the real batches' row
        slices.  Grouping rides the prefetch pipeline's ``_grouped``
        (one W-grouping protocol in the package)."""
        from ...data.prefetch import _grouped

        rows_full: Optional[int] = None

        def emit(group):
            R = rows_full
            sls = [sl for sl, _, _, _ in group]
            if (len(group) == W
                    and all(b.shape[0] == R for _, b, _, _ in group)):
                # the steady case: equal full batches stack in one copy
                binned_c = np.stack([b for _, b, _, _ in group])
                if need_gh:
                    g_c = np.stack([g for _, _, g, _ in group])
                    h_c = np.stack([h for _, _, _, h in group])
            else:
                # ragged tail: zero-pad short rows / missing batches
                binned_c = np.zeros((W, R, d), group[0][1].dtype)
                g_c = np.zeros((W, R), np.float32) if need_gh else None
                h_c = np.zeros((W, R), np.float32) if need_gh else None
                for j, (_, b, g, h) in enumerate(group):
                    binned_c[j, :b.shape[0]] = b
                    if need_gh:
                        g_c[j, :b.shape[0]] = g
                        h_c[j, :b.shape[0]] = h

            def put(a):
                return torch.from_numpy(a).to(dev)

            return (sls, put(binned_c).to(torch.int32),
                    put(g_c) if need_gh else None,
                    put(h_c) if need_gh else None)

        def prepared():
            for sl, binned_b, y_b, m_b in cache_batches():
                if need_gh:
                    g, h = grad_hess(y_b, m_b)
                    yield (sl, binned_b, np.asarray(g, np.float32),
                           np.asarray(h, np.float32))
                else:
                    yield (sl, binned_b, None, None)

        for group in _grouped(prepared(), W):
            if rows_full is None:
                rows_full = group[0][1].shape[0]
            yield emit(group)

    n_nodes_total = 2 ** (depth + 1) - 1
    features = np.full((config.num_trees, n_nodes_total), -1, np.int32)
    thresholds = np.zeros((config.num_trees, n_nodes_total), np.int32)
    values = np.zeros((config.num_trees, n_nodes_total), np.float32)

    for t in range(config.num_trees):
        # the tree-so-far lives on the device; each level's splits join
        # it there, and the finished tree reaches the host in one copy
        feature_row = torch.full((n_nodes_total,), -1, dtype=torch.int32,
                                 device=dev)
        threshold_row = torch.zeros((n_nodes_total,), dtype=torch.int32,
                                    device=dev)
        value_row = torch.zeros((n_nodes_total,), dtype=torch.float32,
                                device=dev)
        base = 0
        for level in range(depth):
            n_nodes = 2 ** level
            # running histograms thread through every chunk (strictly
            # sequential per-batch accumulation, W-independent)
            g_hist = torch.zeros((n_nodes, d, bins), dtype=torch.float32,
                                 device=dev)
            h_hist = torch.zeros_like(g_hist)
            for _, binned_c, g_c, h_c in chunked_batches(True):
                g_hist, h_hist = _chunk_level_histograms(
                    binned_c, g_c, h_c, feature_row, threshold_row, g_hist,
                    h_hist, level, n_nodes, d, bins, impl)
            bf, bb, bg = _level_splits(g_hist, h_hist, config.reg_lambda,
                                       config.min_child_weight)
            split = bg > 0
            feature_row[base:base + n_nodes] = torch.where(split, bf, -1)
            threshold_row[base:base + n_nodes] = bb
            # leaf value for rows that STOP at this level: Newton step on
            # the per-node totals the histograms already carry
            g_tot = torch.sum(g_hist, dim=(1, 2)) / d
            h_tot = torch.sum(h_hist, dim=(1, 2)) / d
            vals = -g_tot / (h_tot + config.reg_lambda)
            value_row[base:base + n_nodes] = torch.where(split, 0.0, vals)
            base += n_nodes

        # deepest level: always leaves — one leaf-sum pass (per-batch
        # sums accumulate in f64 batch by batch: the order of the
        # unchunked path, on the device)
        n_nodes = 2 ** depth
        G = torch.zeros((n_nodes,), dtype=torch.float64, device=dev)
        H = torch.zeros((n_nodes,), dtype=torch.float64, device=dev)
        for sls, binned_c, g_c, h_c in chunked_batches(True):
            gs, hs = _chunk_leaf_sums(binned_c, g_c, h_c, feature_row,
                                      threshold_row, depth, n_nodes)
            for j in range(len(sls)):
                G += gs[j].double()
                H += hs[j].double()
        value_row[base:base + n_nodes] = (
            -G / (H + config.reg_lambda)).float()

        # margin-update pass
        for sls, binned_c, _, _ in chunked_batches(False):
            preds = _chunk_tree_preds(binned_c, feature_row, threshold_row,
                                      value_row, depth).cpu().numpy(
                                      ).astype(np.float64)
            for j, sl in enumerate(sls):
                margins[sl] += (config.learning_rate
                                * preds[j, :sl.stop - sl.start])
        features[t], thresholds[t], values[t] = _rows_to_host(
            feature_row, threshold_row, value_row)
    margins.flush()
    return Forest(features, thresholds, values, edges, base_score,
                  config.learning_rate)


@dataclass
class SoftmaxForest:
    """K-class boosted forest: ``num_trees`` rounds x ``n_classes`` trees
    (the standard softmax objective — one tree per class per round, the
    XGBoost ``multi:softmax`` formulation)."""

    feature: np.ndarray       # (T, K, n_nodes) int32, -1 for leaf
    threshold: np.ndarray     # (T, K, n_nodes) int32
    value: np.ndarray         # (T, K, n_nodes) f32
    bin_edges: np.ndarray     # (d, max_bins - 1) f64
    base_scores: np.ndarray   # (K,) f64 log-priors
    learning_rate: float

    @property
    def n_classes(self) -> int:
        return self.feature.shape[1]


def _softmax_rows(m: np.ndarray) -> np.ndarray:
    e = np.exp(m - m.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def train_forest_softmax(X: np.ndarray, y_ids: np.ndarray, n_classes: int,
                         config: GBTConfig, device="cuda") -> SoftmaxForest:
    """Multiclass boosting: each round trains one tree per class against the
    softmax gradients ``g_k = p_k - 1[y=k]``, ``h_k = p_k (1 - p_k)``; class
    margins start at the log-priors.  Runs on ``device``."""
    dev = resolve_device(device)
    n, d = X.shape
    binned_host, edges = bin_features(X, config.max_bins)
    binned = torch.from_numpy(binned_host).to(dev)
    n_nodes_total = 2 ** (config.max_depth + 1) - 1
    T, K = config.num_trees, n_classes

    features = np.full((T, K, n_nodes_total), -1, np.int32)
    thresholds = np.zeros((T, K, n_nodes_total), np.int32)
    values = np.zeros((T, K, n_nodes_total), np.float32)

    priors = np.bincount(y_ids, minlength=K) / max(n, 1)
    base_scores = np.log(np.clip(priors, 1e-6, None))
    margins = np.tile(base_scores, (n, 1))
    onehot = (y_ids[:, None] == np.arange(K)[None, :]).astype(np.float64)

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    for t in range(T):
        p = _softmax_rows(margins)
        for k in range(K):
            g = p[:, k] - onehot[:, k]
            h = np.maximum(p[:, k] * (1.0 - p[:, k]), 1e-12)
            (features[t, k], thresholds[t, k], values[t, k],
             tree_pred) = _train_one_tree(binned, put(g), put(h), d, config)
            margins[:, k] += config.learning_rate * tree_pred.cpu().numpy(
            ).astype(np.float64)

    return SoftmaxForest(features, thresholds, values, edges, base_scores,
                         config.learning_rate)


def _tree_preds(binned: np.ndarray, feature: np.ndarray,
                threshold: np.ndarray, value: np.ndarray, depth: int,
                device) -> np.ndarray:
    """f32 outputs ``(trees, n)`` of every tree of ``(trees, nodes)`` rows
    on the (bucket-padded) host ``binned`` rows: one copy in, the walks on
    ``device``, one copy out."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    b = put(binned)
    feat, thr, val = put(feature), put(threshold), put(value)
    return torch.stack([_predict_tree_device(b, feat[t], thr[t], val[t],
                                             depth)
                        for t in range(feature.shape[0])]).cpu().numpy()


def predict_forest_softmax(X: np.ndarray, forest: SoftmaxForest,
                           device="cuda") -> np.ndarray:
    """Per-class margins (n, K).  Rows zero-pad to the shared power-of-two
    bucket (``utils/padding.py``); routing is per-row, pad rows slice
    off."""
    from ...utils.padding import pad_rows_to_bucket

    binned = apply_bins(X, forest.bin_edges)
    (binned,), n = pad_rows_to_bucket((binned,))
    T, K, nodes = forest.feature.shape
    depth = int(np.log2(nodes + 1)) - 1
    margins = np.tile(forest.base_scores, (binned.shape[0], 1))
    outs = _tree_preds(binned, forest.feature.reshape(T * K, nodes),
                       forest.threshold.reshape(T * K, nodes),
                       forest.value.reshape(T * K, nodes), depth,
                       device).reshape(T, K, -1)
    for t in range(T):
        for k in range(K):
            margins[:, k] += forest.learning_rate * outs[t, k].astype(
                np.float64)
    return margins[:n]


def _predict_tree(binned: np.ndarray, feature: np.ndarray,
                  threshold: np.ndarray, value: np.ndarray,
                  depth: int, device="cuda") -> np.ndarray:
    return _tree_preds(binned, feature[None], threshold[None], value[None],
                       depth, device)[0]


def _predict_tree_device(binned, feature, threshold, value, depth: int):
    """One tree's output per row on the tensors' device: ``depth + 1``
    steps down the complete tree (no arithmetic on the values, so any
    device gives the same bits)."""
    n = binned.shape[0]
    dev = binned.device
    node = torch.zeros((n,), dtype=torch.int64, device=dev)  # global index
    out = torch.zeros((n,), dtype=torch.float32, device=dev)
    settled = torch.zeros((n,), dtype=torch.bool, device=dev)
    for _ in range(depth + 1):
        feat = feature[node]
        is_leaf = feat < 0
        newly = is_leaf & ~settled
        out = torch.where(newly, value[node], out)
        settled = settled | is_leaf
        row_bin = _row_bins(binned, torch.clamp_min(feat, 0))
        child = 2 * node + 1 + (row_bin > threshold[node]).long()
        node = torch.where(settled, node,
                           torch.clamp_max(child, feature.shape[0] - 1))
    return out


def predict_forest(X: np.ndarray, forest: Forest,
                   device="cuda") -> np.ndarray:
    """Sum of tree outputs, margin scale.  Rows zero-pad to the shared
    power-of-two bucket (``utils/padding.py``); pad rows slice off."""
    from ...utils.padding import pad_rows_to_bucket

    binned = apply_bins(X, forest.bin_edges)
    (binned,), n = pad_rows_to_bucket((binned,))
    depth = int(np.log2(forest.feature.shape[1] + 1)) - 1
    pred = np.full((binned.shape[0],), forest.base_score, np.float64)
    outs = _tree_preds(binned, forest.feature, forest.threshold,
                       forest.value, depth, device)
    for t in range(forest.feature.shape[0]):
        pred += forest.learning_rate * outs[t]
    return pred[:n]


# ---------------------------------------------------------------------------
# kernel-registry entries: op ``gbt_level_histograms``.  Both forms run on
# both devices; "segsum" has the priority (module docstring), a recorded
# autotune decision overrides it.
# ---------------------------------------------------------------------------

def _register_gbt_kernels() -> None:
    from ...kernels.registry import register_kernel

    register_kernel("gbt_level_histograms", "segsum",
                    _level_histograms_segsum, priority=10)
    register_kernel("gbt_level_histograms", "mxu", _level_histograms_mxu)


_register_gbt_kernels()
