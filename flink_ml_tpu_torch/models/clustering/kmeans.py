"""KMeans: Lloyd's algorithm with the points on the device.

Capability mirror of ``flink-ml-lib/.../clustering/kmeans/KMeans.java:79-337``
+ ``KMeansModel.java:62-214`` + ``KMeansParams.java``/``KMeansModelParams``.

One Lloyd's round is the reference's broadcast-assign-reduce subgraph
(``KMeans.java:172-315``); here it is one kernel launch over
device-resident points (``ops/kmeans.py``), and the centroids stay on the
device between rounds.  The epoch loop is :func:`..iteration.iterate`;
the BSP fit never waits for the device inside it, the workset fit reads
one scalar per round to decide its exit.

A port of the JAX package's ``models/clustering/kmeans.py``.  The fit
plans by shape and measure only: the kernel path for n >= 65536 rows and
the euclidean measure, else the plain body; only the kernel wrappers
branch on the tensors' device.  The out-of-core fit
(:func:`kmeans_fit_outofcore`) applies the same rule to the stream's batch
rows, so the stats kernel carries every batch of a stream of 65536-row
batches.  ``KMeansModel.transform`` and the chain terminal
(``transform_kernel``, ``api/chain.py``) run one function: the
``kmeans_assign_reduce`` kernel on the card with the euclidean measure,
else the measure's pairwise distances and ``argmin``.  ``initMode
"k-means++"`` seeds on the device (:func:`select_kmeanspp_centroids`).

Data parallel: where a ``torch.distributed`` process group is initialized
(``parallel/distributed.py``), ``KMeans.fit`` takes each rank's rows as
its shard and follows the JAX package's multi-host fit: one allgather of
the row counts first, the plan from the global count, rank 0's init
broadcast, and each round this rank's stats (the kernel on the kernel
plan) plus one all-reduce.  The streamed fit over ranks
(``kmeans_fit_outofcore(mesh=)``) streams each rank's own shard, B4 at the
rank's batch and one all-reduce a batch.  Every stage runs on
``device`` (default ``"cuda"``; raises without a card unless ``"cpu"`` is
asked for).  The device and the stats kernel's ``compute_dtype`` are
runtime choices, not params, so they are not saved.
"""

from __future__ import annotations

import time

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ...api.chain import (StageKernel, apply_kernel_or_none, as_matrix,
                          numeric_entry, run_kernel)
from ...api.stage import Estimator, Model
from ...data.table import Table
from ...distance import DistanceMeasure
from ...iteration import (IterationBodyResult, IterationConfig, Workset,
                          iterate)
from ...linalg import stack_vectors
from ...obs.trace import tracer
from ...ops.kmeans import (
    kmeans_assign_reduce,
    kmeans_update_stats,
    kmeans_update_stats_plain,
    kmeans_workset_update,
    kmeans_workset_update_plain,
    pad_correction,
    stats_from_assign as _stats_from_assign,
    update_stats_sharded,
)
from ...params.param import BoolParam, IntParam, ParamValidators, StringParam
from ...params.shared import (
    HasDistanceMeasure,
    HasFeaturesCol,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
)
from ...parallel.collectives import axis_index, psum_packed
from ...parallel.distributed import broadcast_from_host0, process_allgather
from ...parallel.mesh import DATA_AXIS, default_mesh, local_axis_multiple
from ...utils import persist
from ...utils.device import resolve_device

__all__ = ["KMeans", "KMeansModel", "KMeansParams", "KMeansModelParams",
           "FitPlan", "select_random_centroids", "select_kmeanspp_centroids",
           "kmeans_epoch_step", "kmeans_epoch_step_kernel",
           "kmeans_workset_epoch_step", "workset_points_scored",
           "fit_centroids", "kmeans_fit_outofcore"]


class KMeansModelParams(HasDistanceMeasure, HasFeaturesCol, HasPredictionCol):
    """``KMeansModelParams.java`` mixin set."""


class KMeansParams(KMeansModelParams, HasSeed, HasMaxIter):
    """``KMeansParams.java``: adds K (>= 2) and the training-only params.

    ``tiePolicy`` picks the fit kernel's handling of exactly tied
    distances: ``"first"`` (default) the first-index argmin, the
    reference's semantics; ``"split"`` a fractional share to each tied
    centroid; ``"fast"`` a full count to each.  The plain body (below the
    kernel threshold, or a non-euclidean measure) always takes the
    first-index argmin and ignores it."""

    K = IntParam("k", "Number of clusters.", default=2,
                 validator=ParamValidators.gt_eq(2))
    INIT_MODE = StringParam(
        "initMode",
        "Initial centroid selection: 'random' (the reference's "
        "shuffle-take-k) or 'k-means++' (distance-weighted seeding).",
        default="random",
        validator=ParamValidators.in_array(["random", "k-means++"]))
    TIE_POLICY = StringParam(
        "tiePolicy",
        "Fit-kernel handling of exactly-tied distances: 'first' "
        "(reference argmin semantics), 'fast', or 'split'.",
        default="first",
        validator=ParamValidators.in_array(["first", "fast", "split"]))
    WORKSET = BoolParam(
        "workset",
        "Delta/workset iteration mode: carry Hamerly center-movement "
        "bounds through the fit and stop at Lloyd's fixed point instead "
        "of always running maxIter rounds.  Settled points keep their "
        "cached assignment.  On the plain body the final centroids are "
        "bit-identical to the BSP fit's.  The fit records a per-round "
        "report in estimator.last_workset_report.",
        default=False)

    def get_workset(self) -> bool:
        return self.get(KMeansParams.WORKSET)

    def set_workset(self, value: bool):
        return self.set(KMeansParams.WORKSET, value)

    def get_k(self) -> int:
        return self.get(KMeansParams.K)

    def set_k(self, value: int):
        return self.set(KMeansParams.K, value)

    def get_tie_policy(self) -> str:
        return self.get(KMeansParams.TIE_POLICY)

    def set_tie_policy(self, value: str):
        return self.set(KMeansParams.TIE_POLICY, value)

    def get_init_mode(self) -> str:
        return self.get(KMeansParams.INIT_MODE)

    def set_init_mode(self, value: str):
        return self.set(KMeansParams.INIT_MODE, value)


def select_random_centroids(points: np.ndarray, k: int, seed: int) -> np.ndarray:
    """Semantics of ``KMeans.selectRandomCentroids`` (``KMeans.java:317-336``):
    shuffle all points with the seed, take k.  numpy, so both packages
    pick the same init from the same seed."""
    n = points.shape[0]
    if n < k:
        raise ValueError(f"Need at least k={k} points, got {n}")
    idx = np.random.default_rng(seed).permutation(n)[:k]
    return points[idx]


def select_kmeanspp_centroids(points: torch.Tensor, k: int, *,
                              generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding (Arthur & Vassilvitskii 2007) on the points'
    device: the first center drawn uniformly, then k-1 rounds, each one
    ``(n, d)`` pass that updates the squared distance to the nearest
    chosen center (``d2 = min(d2, ||x - c||^2)``) and draws the next
    center with probability proportional to ``d2``.  The draw is the JAX
    package's categorical over ``log(d2)``, points with ``d2 == 0`` at
    ``-inf`` (a chosen point never repeats while unchosen mass remains):
    the argmax of the logits plus Gumbel noise.  Every round stays on the
    device, with no host read; ``generator`` (on the points' device)
    makes the draws, so one seed on one device gives one result.  The
    JAX package draws from ``jax.random``, whose stream this cannot
    reproduce."""
    n, d = points.shape
    if n < k:
        raise ValueError(f"Need at least k={k} points, got {n}")
    dev = points.device
    tiny = torch.finfo(torch.float32).tiny
    first = torch.randint(0, n, (1,), generator=generator, device=dev)
    chosen = torch.empty((k, d), dtype=points.dtype, device=dev)
    chosen[0:1] = points.index_select(0, first)
    d2 = torch.sum(torch.square(points - chosen[0:1]), dim=1)
    for i in range(1, k):
        logits = torch.where(d2 > 0, torch.log(d2), -torch.inf)
        u = torch.rand(n, generator=generator, device=dev).clamp_min(tiny)
        idx = torch.argmax(logits - torch.log(-torch.log(u)))[None]
        chosen[i:i + 1] = points.index_select(0, idx)
        d2 = torch.minimum(
            d2, torch.sum(torch.square(points - chosen[i:i + 1]), dim=1))
    return chosen


def _select_init(mode: str, host_points: np.ndarray, points: torch.Tensor,
                 k: int, seed: int) -> torch.Tensor:
    """The fit's initial centroids on the points' device: the seeded
    shuffle-take-k of the host rows (numpy, the JAX package's draw), or
    k-means++ over the device rows from a generator seeded with ``seed``
    on that device."""
    if mode == "random":
        return torch.from_numpy(np.ascontiguousarray(
            select_random_centroids(host_points, k, seed))).to(points.device)
    gen = torch.Generator(device=points.device)
    gen.manual_seed(seed)
    return select_kmeanspp_centroids(points, k, generator=gen)


def _assign_stats(measure: DistanceMeasure, k: int, points, mask, centroids):
    """The Lloyd's statistics of the plain body: ``(sums, counts)`` of the
    masked points by first-index nearest centroid."""
    assign = torch.argmin(measure.pairwise(points, centroids), dim=1)
    return _stats_from_assign(k, points, mask, assign)


def _update_centroids(centroids, sums, counts):
    """Empty clusters keep their previous centroid."""
    counts = counts[:, None]
    return torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0),
                       centroids)


def kmeans_epoch_step(measure: DistanceMeasure, k: int, *, mesh=None):
    """One Lloyd's round, the plain body (``data`` = ``(points, mask)``).
    With ``mesh`` the stats are this rank's rows', summed over the mesh's
    group."""

    def body(centroids, epoch, data):
        points, mask = data
        sums, counts = _assign_stats(measure, k, points, mask, centroids)
        if mesh is not None:
            sums, counts = psum_packed((sums, counts), mesh=mesh)
        return IterationBodyResult(
            feedback=_update_centroids(centroids, sums, counts))

    return body


def kmeans_epoch_step_kernel(k: int, *, tie_policy: str = "first",
                             plain: bool = False,
                             compute_dtype=torch.float32, mesh=None,
                             n_pad=None):
    """One Lloyd's round on the stats kernel (``ops/kmeans.py``), the
    counterpart of the JAX package's ``kmeans_epoch_step_pallas``.  Zero
    pad rows (mask 0) are removed by :func:`pad_correction`.  ``plain``
    runs the kernel's plain version instead (for comparisons on the
    card).  ``compute_dtype`` is the kernel's product type (f32 or bf16).
    With ``mesh`` each round is this rank's kernel launch and one
    all-reduce (:func:`~flink_ml_tpu_torch.ops.kmeans.update_stats_sharded`)
    and ``n_pad`` is the group's pad-row count."""
    if mesh is not None and plain:
        raise ValueError("a sharded round runs the kernel (plain=False)")
    stats = kmeans_update_stats_plain if plain else kmeans_update_stats

    def body(centroids, epoch, data):
        points, mask = data
        if mesh is None:
            sums, counts = stats(points, centroids, tie_policy=tie_policy,
                                 compute_dtype=compute_dtype)
            pads = points.shape[0] - torch.sum(mask)
        else:
            sums, counts = update_stats_sharded(
                points, centroids, mesh, tie_policy=tie_policy,
                compute_dtype=compute_dtype)
            pads = n_pad
        counts = pad_correction(counts, centroids, pads,
                                tie_policy=tie_policy)[:, None]
        # no clamp to 1: "split" ties give fractional counts in (0, 1)
        safe = torch.where(counts > 0, counts, 1.0)
        new_centroids = torch.where(counts > 0, sums / safe, centroids)
        return IterationBodyResult(feedback=new_centroids)

    return body


def workset_points_scored(active_fraction, n_real: int,
                          n_padded: int) -> np.ndarray:
    """Points scored per round, from the post-round active-fraction trace:
    round 0 scores every real point, round ``e`` scores round ``e-1``'s
    survivors (the fraction is over padded rows)."""
    frac = np.asarray(active_fraction, np.float64)
    if not frac.size:
        return np.zeros((0,))
    return np.concatenate([[float(n_real)], frac[:-1] * n_padded])


#: relative slack on the Hamerly bound decay: f32 rounding of
#: ``upper + drift`` / ``lower - drift`` may land below the true bound, so
#: every decayed bound is nudged outward — a loose bound only keeps a
#: settled point active one more round, never freezes one that could flip.
_WS_BOUND_SLACK = 1e-5


def kmeans_workset_epoch_step(measure: DistanceMeasure, k: int, *,
                              kernel: bool = False, mesh=None):
    """One bound-filtered Lloyd's round as a workset body (Hamerly 2010 on a
    device-resident mask).  ``kernel`` scores through the fused
    ``kmeans_workset_update`` kernel, else through its plain version; the
    bound decay, settle rule and centroid update are shared.  With
    ``mesh`` the workset is this rank's rows' and the stats and the flip
    count are summed over the mesh's group (one all-reduce), so every rank
    takes the same centroids and the same settle decision.

    ``workset.bounds`` carries the cached assignment, an upper bound on the
    distance to the assigned centroid and a lower bound on the distance to
    every other one.  A point is settled when ``upper < lower`` after both
    decay by the centroids' movement: its argmin cannot have flipped, so
    its cached assignment feeds the stats and the result is bit-identical
    to the BSP body.  A round with no flip and no drift drains the
    workset, so the loop exits at Lloyd's fixed point.

    Euclidean only: the decay leans on the triangle inequality in root
    distance space."""
    if measure.name != "euclidean":
        raise ValueError(
            "workset KMeans requires the euclidean measure (Hamerly "
            f"bounds need the triangle inequality), got {measure.name!r}")
    update = kmeans_workset_update if kernel else kmeans_workset_update_plain

    def body(centroids, ws, epoch, data):
        points, pad_mask = data
        active = ws.mask
        prev_assign = ws.bounds["assign"]
        assign, d_best, d_second, sums, counts = update(
            points, centroids, prev_assign, active, pad_mask)
        on = active > 0
        # settled points keep their cached bounds; assign is merged
        upper = torch.where(on, d_best, ws.bounds["upper"])
        lower = torch.where(on, d_second, ws.bounds["lower"])
        changed = torch.sum(active * (assign != prev_assign))
        if mesh is not None:
            sums, counts, changed = psum_packed((sums, counts, changed),
                                                mesh=mesh)
        new_centroids = _update_centroids(centroids, sums, counts)

        drift = torch.sqrt(torch.clamp_min(
            torch.sum(torch.square(new_centroids - centroids), dim=1), 0.0))
        drift_max = torch.max(drift)
        # conservative f32 decay (see _WS_BOUND_SLACK)
        upper = upper + drift[assign.long()]
        upper = upper + torch.abs(upper) * _WS_BOUND_SLACK
        lower = lower - drift_max
        lower = lower - torch.abs(lower) * _WS_BOUND_SLACK
        # fixed point: nothing moved and nothing flipped
        settled = torch.logical_and(drift_max == 0.0, changed == 0.0)
        next_active = torch.logical_and(upper >= lower,
                                        torch.logical_not(settled))
        new_mask = torch.where(pad_mask > 0, next_active.to(torch.float32),
                               0.0)
        new_ws = Workset(new_mask, {"assign": assign, "upper": upper,
                                    "lower": lower})
        return IterationBodyResult(feedback=(new_centroids, new_ws))

    return body


# The kernels take over from this row count; below it the plain body is as
# fast and keeps the reference's exact semantics.
_KERNEL_MIN_ROWS = 65536


@dataclass(frozen=True)
class FitPlan:
    """The per-fit implementation contract, shared by the BSP and the
    workset fit.  ``impl``: ``"kernel"`` (stats kernel), ``"kernel_ws"``
    (workset kernel) or ``"plain"``.  Unlike the JAX package's plan it
    carries no padding rule: the kernels take any row count."""

    impl: str
    k: int
    d: int

    def init_workset(self, pad_mask: torch.Tensor) -> Workset:
        """Every real point starts active with vacuous bounds (+inf upper,
        -inf lower: a full first-round rescore, exactly BSP round 0); pad
        rows are born settled."""
        mask = pad_mask.to(torch.float32)
        return Workset(
            mask=mask,
            bounds={"assign": torch.zeros_like(mask, dtype=torch.int32),
                    "upper": torch.full_like(mask, float("inf")),
                    "lower": torch.full_like(mask, float("-inf"))})


def _fit_plan(n: int, d: int, k: int, measure: DistanceMeasure, *,
              workset: bool = False, data_devs: int = 1) -> FitPlan:
    """Plan by shape and measure only: the kernel route for n >= 65536
    and the euclidean measure, else the plain body.  On a data axis of
    more than one device the workset fit plans the plain body, as the JAX
    package does (its workset kernel is single-device).

    The plan decides the kernel route against the measure-generic body,
    as ``sgd.plan_mixed_impl`` decides ELL against plain; which
    implementation of the route's op runs is the kernel registry's
    (:func:`_register_kmeans_kernels`): the route's wrappers resolve op
    ``kmeans_update_stats`` (``kmeans_workset_update``) at a signature
    ending in the device type, the kernel on the card and its plain twin
    on the CPU, so the plan is the same on both devices."""
    kernel = measure.name == "euclidean" and n >= _KERNEL_MIN_ROWS
    if not kernel or (workset and data_devs > 1):
        return FitPlan("plain", k, d)
    return FitPlan("kernel_ws" if workset else "kernel", k, d)


def fit_centroids(points: torch.Tensor, mask: torch.Tensor,
                  init: torch.Tensor, plan: FitPlan, *,
                  measure: DistanceMeasure, max_iter: int,
                  workset: bool = False, tie_policy: str = "first",
                  plain: bool = False, compute_dtype=torch.float32,
                  mesh=None):
    """Lloyd's rounds from ``init`` over device-resident ``(points, mask)``
    under ``plan`` (BSP, or bound-filtered with ``workset``); returns the
    :class:`IterationResult`.  ``plain`` swaps the kernels for their plain
    versions (for comparisons on the card); ``compute_dtype`` is the stats
    kernel's product type.  With ``mesh`` (a process group's) the rows are
    this rank's shard and every round's stats, and the workset's exit
    fraction, are the group's."""
    k = plan.k
    if workset:
        body = kmeans_workset_epoch_step(
            measure, k, kernel=plan.impl == "kernel_ws" and not plain,
            mesh=mesh)
        frac = None
        if mesh is not None:
            def frac(ws):
                act, total = psum_packed(
                    (torch.sum(ws.mask.to(torch.float32)),
                     torch.full((), float(ws.mask.numel()),
                                device=ws.mask.device)), mesh=mesh)
                return act / total
        return iterate(body, init, (points, mask), max_epochs=max_iter,
                       workset=plan.init_workset(mask),
                       workset_fraction=frac,
                       config=IterationConfig(mode="fused"))
    if plan.impl == "kernel":
        n_pad = None
        if mesh is not None:
            (n_pad,) = psum_packed((points.shape[0] - torch.sum(mask),),
                                   mesh=mesh)
        body = kmeans_epoch_step_kernel(
            k, tie_policy=tie_policy, plain=plain,
            compute_dtype=compute_dtype, mesh=mesh, n_pad=n_pad)
    else:
        body = kmeans_epoch_step(measure, k, mesh=mesh)
    return iterate(body, init, (points, mask), max_epochs=max_iter,
                   config=IterationConfig(mode="fused"))


def kmeans_fit_outofcore(make_reader, k: int, *,
                         measure_name: str = "euclidean",
                         max_iter: int = 20, seed: int = 0, mesh=None,
                         features_key: str = "features",
                         prefetch_depth: int = 2,
                         prefetch_stats=None, device="cuda",
                         plain: bool = False, info: Optional[dict] = None,
                         init: Optional[np.ndarray] = None) -> np.ndarray:
    """Out-of-core Lloyd's: the dataset streams from ``make_reader()`` (a
    fresh per-epoch iterator of host batch dicts, the ``sgd_fit_outofcore``
    protocol; epoch-aware factories receive ``epoch=``) instead of living
    on the device; the replay-per-epoch semantics of the reference's
    ReplayOperator (``operator/ReplayOperator.java:62-311``).

    Each epoch accumulates per-batch ``(sums, counts)`` on the device
    (batch N+1's read and transfer overlap batch N's stats through
    :func:`~flink_ml_tpu_torch.data.prefetch.prefetch_to_device`) and
    applies one centroid update per epoch: exact Lloyd's, the in-memory
    fit's result on the concatenated rows up to f32 summation order.  The
    accumulation has two levels: f32 on the device within a window of
    ``max(1, 2^23 // rows)`` batches (counts stay inside f32's exact
    integers), folded into a host float64 total; the update runs in
    float64 on the host.  Initial centroids are the seeded
    shuffle-take-k of the FIRST batch (:func:`select_random_centroids`,
    the JAX fit's draw), or ``init`` (host ``(k, d)``) where given.

    The per-batch stats take the in-memory rule (:func:`_fit_plan`) at the
    stream's batch rows (its first batch's): the stats kernel (tie policy
    "first") for the euclidean measure and >= 65536 rows a batch, else the
    plain assign-and-reduce.  The kernel takes any row count, so the
    ragged final batch runs at its own size, with no pad rows.  ``plain``
    runs the kernel's plain version instead (for comparisons on the
    card).  ``info`` (a dict, filled in place) gets the plan and the
    per-epoch wall seconds.

    Returns the final ``(k, d)`` centroids (host float32).

    **Several ranks** (``mesh=``, a
    :class:`~flink_ml_tpu_torch.parallel.mesh.Mesh` of a process group):
    call from every rank with a reader over its own shard; global batch
    ``b`` is the ranks' batch ``b`` in rank order.  One allgather at the
    first batch compares the ranks' plans (``_fit_plan`` at each rank's
    batch rows, and ``d``) and raises on every rank if they differ; each
    batch's stats run on the rank's rows (B4 through
    ``ops/kmeans.py::update_stats_sharded`` on the kernel plan) and meet
    in one packed all-reduce; before each batch one all-reduce of a flag
    says whether every rank has one, so readers that yield different
    batch counts raise on every rank rather than hang.  The f32 window is sized by the
    global rows of a batch, and the float64 fold and the update are the
    same bits on every rank.  The init is the seeded shuffle-take-k of
    the global first batch (a rank-order gather of the first batches),
    unless ``init`` is given.  A mesh of one rank is the one-process
    fit."""
    from ...data.prefetch import prefetch_to_device
    from ...parallel.mesh import Mesh
    from ..common.sgd import _mesh_ranks, _reader_for_epoch

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh= takes a flink_ml_tpu_torch.parallel.mesh.Mesh "
                        f"(a process group's axes), got {type(mesh).__name__}")
    multi = _mesh_ranks(mesh) > 1
    dev = resolve_device(device)
    measure = DistanceMeasure.get_instance(measure_name)

    def to_host_batch(batch):
        return np.ascontiguousarray(
            np.asarray(batch[features_key], np.float32))

    stats = None     # (points) -> (sums, counts), planned at batch 0
    impl = None
    rows = None      # the stream's batch rows (its first batch's)
    window = None    # batches an f32 window holds
    centroids = (None if init is None else torch.from_numpy(
        np.ascontiguousarray(init, np.float32)).to(dev))
    epoch_secs = []
    for iteration in range(max_iter):
        t_epoch = time.perf_counter()
        host_sums = host_counts = None
        sums = counts = None
        window_used = 0

        def fold():
            nonlocal host_sums, host_counts, sums, counts, window_used
            if sums is None:
                return
            s64 = sums.cpu().numpy().astype(np.float64)
            c64 = counts.cpu().numpy().astype(np.float64)
            host_sums = s64 if host_sums is None else host_sums + s64
            host_counts = c64 if host_counts is None else host_counts + c64
            sums = counts = None
            window_used = 0

        # Lloyd statistics are order-invariant, so per-epoch reshuffled
        # readers change the IO pattern only; the init samples epoch 0's
        # first batch.  The pipeline is closed on every exit, joining its
        # reader threads.
        pipeline = prefetch_to_device(
            _reader_for_epoch(make_reader, iteration), depth=prefetch_depth,
            device=dev, transform=to_host_batch, stats=prefetch_stats)
        try:
            for pts in _batches(pipeline, mesh if multi else None, dev):
                if stats is None:
                    rows = int(pts.shape[0])
                    impl = _fit_plan(rows, int(pts.shape[1]), k,
                                     measure).impl
                    window = max(1, (1 << 23) // rows)
                    first = pts
                    if multi:
                        window, first = _agree_plan(pts, impl, mesh)
                    stats = _batch_stats(measure, k, impl, plain,
                                         mesh if multi else None)
                    if centroids is None:
                        centroids = torch.from_numpy(np.ascontiguousarray(
                            select_random_centroids(first.cpu().numpy(), k,
                                                    seed))).to(dev)
                s, c = stats(pts, centroids)
                if sums is None:
                    sums, counts = s, c
                else:
                    sums, counts = sums + s, counts + c
                window_used += 1
                if window_used >= window:
                    fold()
        finally:
            pipeline.close()
        fold()
        if host_sums is None:
            raise ValueError("make_reader() returned an empty epoch")
        prev = centroids.cpu().numpy().astype(np.float64)
        cnt = host_counts[:, None]
        new = np.where(cnt > 0, host_sums / np.maximum(cnt, 1.0), prev)
        centroids = torch.from_numpy(new.astype(np.float32)).to(dev)
        epoch_secs.append(time.perf_counter() - t_epoch)
    if info is not None:
        info["impl"] = impl
        info["batch_rows"] = rows
        info["epoch_seconds"] = epoch_secs
    if centroids is None:
        raise ValueError("kmeans_fit_outofcore needs max_iter >= 1")
    return centroids.cpu().numpy()


def _batches(pipeline, mesh, dev):
    """The stream's batches; over the ranks of ``mesh`` each batch only
    while every rank has one: one all-reduce of a flag a batch, read on
    the host, ends the epoch where no rank has a batch and raises on
    every rank where some have and some have not (a rank left in a
    collective the others never reach would hang)."""
    from ...parallel.collectives import psum

    it = iter(pipeline)
    while True:
        pts = next(it, None)
        if mesh is not None:
            flag = torch.tensor([0.0 if pts is None else 1.0], device=dev)
            have = int(psum(flag, mesh.axis_names, mesh=mesh)[0])
            if 0 < have < mesh.size:
                raise ValueError(
                    f"the ranks' readers yielded different batch counts: "
                    f"{have} of {mesh.size} ranks had a batch where the "
                    "others had ended; give every rank the same number of "
                    "batches an epoch")
        if pts is None:
            return
        yield pts


def _agree_plan(pts: torch.Tensor, impl: str, mesh):
    """The ranks' first batches compared (one allgather of ``(rows, d,
    plan)``; a difference in ``d`` or the plan raises on every rank) and
    gathered: ``(window, first)``, the f32 window sized by the global
    rows of a batch and the global first batch, the ranks' first batches
    in rank order (the init's draw)."""
    from ...parallel.collectives import all_gather
    from ...parallel.distributed import process_allgather

    rows, d = int(pts.shape[0]), int(pts.shape[1])
    got = process_allgather(np.asarray([rows, d, impl == "kernel"],
                                       np.int64), mesh=mesh)
    if not (np.all(got[:, 1] == d) and np.all(got[:, 2] == got[0, 2])):
        raise ValueError(
            "the ranks planned the streamed KMeans fit apart: (rows, d, "
            f"kernel plan) per rank {got.tolist()}; give every rank batches "
            "of the same width and the same plan (>= 65536 rows a batch "
            "on every rank, or fewer on every rank)")
    top = int(got[:, 0].max())
    padded = torch.zeros((top, d), dtype=pts.dtype, device=pts.device)
    padded[:rows] = pts
    parts = all_gather(padded, tuple(mesh.axis_names), tiled=False,
                       mesh=mesh)
    first = torch.cat([parts[r, :int(n)] for r, n in enumerate(got[:, 0])])
    return max(1, (1 << 23) // int(got[:, 0].sum())), first


def _batch_stats(measure: DistanceMeasure, k: int, impl: str, plain: bool,
                 mesh=None):
    """The per-batch ``(sums, counts)`` of the out-of-core fit: the stats
    kernel (or its plain version) under ``impl == "kernel"``, else the
    plain assign-and-reduce.  No pad rows, so no correction.  With
    ``mesh`` the stats of this rank's rows are summed over every axis of
    the mesh (B4 through :func:`update_stats_sharded` on the kernel
    plan; one packed all-reduce)."""
    if impl != "kernel":
        def plain_stats(points, centroids):
            mask = torch.ones(points.shape[0], dtype=points.dtype,
                              device=points.device)
            return _assign_stats(measure, k, points, mask, centroids)

        fn = plain_stats
    elif mesh is not None and not plain:
        return lambda points, centroids: update_stats_sharded(
            points, centroids, mesh, tie_policy="first",
            axis=tuple(mesh.axis_names))
    else:
        def fn(points, centroids):
            stats = (kmeans_update_stats_plain if plain
                     else kmeans_update_stats)
            return stats(points, centroids, tie_policy="first")
    if mesh is None:
        return fn
    return lambda points, centroids: psum_packed(
        fn(points, centroids), tuple(mesh.axis_names), mesh=mesh)


class KMeans(KMeansParams, Estimator["KMeansModel"]):
    """Estimator: Lloyd's algorithm for ``maxIter`` rounds (termination
    parity with ``TerminateOnMaxIterationNum``), or until the workset
    drains with ``set_workset(True)``.  ``compute_dtype`` (f32 or bf16)
    is the stats kernel's product type on the kernel plan, the JAX
    kernel's ``compute_dtype``."""

    def __init__(self, device="cuda", compute_dtype=torch.float32):
        super().__init__()
        self.device = device
        self.compute_dtype = compute_dtype
        self.planned_impl: Optional[str] = None
        self.last_workset_report: Optional[dict] = None

    def fit(self, *inputs) -> "KMeansModel":
        """Fit on this process's rows; inside a process group each rank
        passes its own shard and every rank gets the same model."""
        (table,) = inputs
        # the report describes this fit only
        self.last_workset_report = None
        dev = resolve_device(self.device)
        mesh = default_mesh()
        grouped = mesh.group is not None
        k = self.get_k()
        measure = DistanceMeasure.get_instance(self.get_distance_measure())
        # the fit's host steps, copies and rounds, each a child span of
        # "kmeans.fit"
        span = tracer.recorder()
        with span("kmeans.fit", cat="train", device=dev):
            with span("kmeans.points", cat="train"):
                host_points = stack_vectors(
                    table[self.get_features_col()]).astype(np.float32)
            n, d = host_points.shape
            n_for_plan = n
            if grouped:
                # One allgather of the raw row counts before any other
                # collective, so every rank takes the same branches from
                # the same facts: the plan from the global count (ranks
                # planning apart would run different collectives and
                # deadlock), rank 0's too-small shard raising on every
                # rank (raising on one would strand the rest in the init
                # broadcast), and the padded counts checked here.
                rows = process_allgather(np.asarray([n], np.int64),
                                         mesh=mesh).reshape(-1)
                n_for_plan = int(rows.sum())
                if rows[0] < k:
                    raise ValueError(
                        f"multi-host KMeans selects initial centroids from "
                        f"host 0's shard, which holds {int(rows[0])} rows "
                        f"< k={k}; give host 0 at least k rows")
            workset = self.get_workset()
            plan = _fit_plan(n_for_plan, d, k, measure, workset=workset,
                             data_devs=mesh.shape[DATA_AXIS])
            self.planned_impl = plan.impl
            with span("kmeans.copy_in", cat="train", device=dev):
                points_t = torch.from_numpy(
                    np.ascontiguousarray(host_points)).to(dev)
                mask_t = torch.ones(n, dtype=torch.float32, device=dev)
            mode, seed = self.get_init_mode(), self.get_seed()
            with span("kmeans.init", cat="train", device=dev):
                if grouped:
                    # the kernels take any row count: a rank pads to a
                    # multiple of one, so its padded count is its row
                    # count
                    multiple = local_axis_multiple(mesh)
                    padded_rows = -(-rows // multiple) * multiple
                    if not np.all(padded_rows == padded_rows[0]):
                        raise ValueError(
                            "multi-host KMeans requires equal padded row "
                            f"counts per process; got "
                            f"{padded_rows.tolist()}")
                    init_t = (_select_init(mode, host_points, points_t, k,
                                           seed)
                              if axis_index(mesh=mesh) == 0 else
                              torch.zeros((k, d), dtype=torch.float32,
                                          device=dev))
                    init_t = broadcast_from_host0(init_t, mesh=mesh)
                else:
                    init_t = _select_init(mode, host_points, points_t, k,
                                          seed)
            with span("kmeans.rounds", cat="train", device=dev):
                result = fit_centroids(
                    points_t, mask_t, init_t, plan, measure=measure,
                    max_iter=self.get_max_iter(), workset=workset,
                    tie_policy=self.get_tie_policy(),
                    compute_dtype=self.compute_dtype,
                    mesh=mesh if grouped else None)
            with span("kmeans.copy_out", cat="train", device=dev):
                if workset:
                    self.last_workset_report = self._workset_report(
                        result, n_real=n_for_plan,
                        n_padded=int(padded_rows.sum()) if grouped else n)
                centroids = result.state.cpu().numpy()

                model = KMeansModel(device=self.device)
                model.copy_params_from(self)
                model.set_model_data(
                    Table({"centroids": centroids[None, :, :]}))
                model.planned_impl = plan.impl
        return model

    def _workset_report(self, result, *, n_real: int, n_padded: int) -> dict:
        """Convergence report of a workset fit: ``active_fraction[e]`` is the
        fraction left active after round ``e`` (over padded rows);
        ``points_scored`` the points each round scored."""
        trace = result.side.get("epoch_trace", {})
        frac = np.asarray(trace.get("active_fraction", ()), np.float64)
        return {
            "rounds": result.num_epochs,
            "max_epochs": self.get_max_iter(),
            "n_points": int(n_real),
            "active_fraction": frac,
            "points_scored": workset_points_scored(frac, n_real, n_padded),
        }

    def fit_outofcore(self, make_reader, *, mesh=None,
                      features_key: Optional[str] = None,
                      prefetch_stats=None) -> "KMeansModel":
        """Out-of-core ``fit`` (:func:`kmeans_fit_outofcore`): the dataset
        streams from ``make_reader()``, a fresh per-epoch iterator of host
        batch dicts (e.g. a re-seeked ``DataCacheReader``), instead of
        living in host memory or on the device.  ``planned_impl`` says
        which stats carried the batches ("kernel" or "plain")."""
        info: dict = {}
        centroids = kmeans_fit_outofcore(
            make_reader, self.get_k(),
            measure_name=self.get_distance_measure(),
            max_iter=self.get_max_iter(), seed=self.get_seed(), mesh=mesh,
            features_key=features_key or self.get_features_col(),
            prefetch_stats=prefetch_stats, device=self.device, info=info)
        self.planned_impl = info["impl"]
        model = KMeansModel(device=self.device)
        model.copy_params_from(self)
        model.set_model_data(Table({"centroids": centroids[None, :, :]}))
        model.planned_impl = info["impl"]
        return model

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "KMeans":
        stage = persist.load_stage_param(path)
        stage.device = device
        return stage


def _kmeans_chain_kernel(static, params, cols):
    """Nearest centroid of each row: the stage of op ``kmeans_assign``
    the kernel registry resolves at ``(measure, device)``: on the card
    with the euclidean measure the ``kmeans_assign_reduce`` kernel (B5),
    of which only the assignments are kept; otherwise ``argmin`` of the
    measure's pairwise distances."""
    from ...kernels.registry import lookup

    (fcol, _acol, measure_name) = static
    entry = lookup("kmeans_assign",
                   sig=(measure_name, cols[fcol].device.type))
    return entry.fn(static, params, cols)


def _kmeans_assign_cuda(static, params, cols):
    """Op ``kmeans_assign``, backend ``"cuda"`` (euclidean): the B5
    kernel's assignments."""
    (fcol, acol, _measure_name) = static
    points = as_matrix(cols[fcol]).to(torch.float32).contiguous()
    return {acol: kmeans_assign_reduce(points, params["centroids"])[0]}


def _kmeans_assign_plain(static, params, cols):
    """Op ``kmeans_assign``, backend ``"plain"``: ``argmin`` of the
    measure's pairwise distances (any measure; the JAX package's
    ``"xla"`` entry)."""
    (fcol, acol, measure_name) = static
    points = as_matrix(cols[fcol]).to(torch.float32).contiguous()
    measure = DistanceMeasure.get_instance(measure_name)
    return {acol: torch.argmin(measure.pairwise(points,
                                                params["centroids"]),
                               dim=1)}


class KMeansModel(KMeansModelParams, Model):
    """Batch prediction: the nearest centroid of each row, appended as the
    prediction column (int64)."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self.planned_impl: Optional[str] = None
        self._centroids: Optional[np.ndarray] = None

    # -- model data ---------------------------------------------------------
    def set_model_data(self, *inputs) -> "KMeansModel":
        (table,) = inputs
        self._centroids = np.asarray(table["centroids"][0], dtype=np.float32)
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"centroids": self._centroids[None, :, :]})]

    def _require_model(self):
        if self._centroids is None:
            raise RuntimeError(
                "KMeansModel has no model data; fit a KMeans or call "
                "set_model_data first")

    def transform_kernel(self, schema):
        """Chain TERMINAL: the in-segment assignment is the standalone
        transform's (:func:`_kmeans_chain_kernel`); the host ``post``
        applies the int64 cast.  Bit-exact with the stagewise
        transform."""
        self._require_model()
        fcol = self.get_features_col()
        if numeric_entry(schema, fcol) is None:
            return None
        pred_col = self.get_prediction_col()
        assign_col = f"__chain_assign__{pred_col}"

        def post(host):
            return {pred_col: host[assign_col].astype(np.int64)}

        return StageKernel(
            fn=_kmeans_chain_kernel,
            static=(fcol, assign_col, self.get_distance_measure()),
            params={"centroids": self._centroids},
            consumes=(fcol,), produces=(assign_col,), post=post,
            device=self.device)

    # -- inference ----------------------------------------------------------
    def transform(self, *inputs) -> List[Table]:
        """The chain terminal as a one-stage segment (rows padded to the
        shared bucket); a column of vectors is stacked to f32 first."""
        (table,) = inputs
        self._require_model()
        cols = apply_kernel_or_none(self.transform_kernel(table.schema()),
                                    table)
        if cols is None:        # object column / f32-unsafe integers
            fcol = self.get_features_col()
            stacked = Table({fcol: stack_vectors(table[fcol]).astype(
                np.float32)})
            cols = run_kernel(self.transform_kernel(stacked.schema()),
                              stacked)
        pred_col = self.get_prediction_col()
        return [table.with_column(pred_col, cols[pred_col])]

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model",
                                  {"centroids": self._centroids})

    @classmethod
    def load(cls, path: str, device="cuda") -> "KMeansModel":
        """Load a model saved by this package or by the JAX package."""
        model = persist.load_stage_param(path)
        if not isinstance(model, cls):
            raise IOError(f"Stage at {path} is a {type(model).__name__}, "
                          f"not a {cls.__name__}")
        model.device = device
        data = persist.load_model_arrays(path, "model")
        model._centroids = data["centroids"].astype(np.float32)
        return model


# ---------------------------------------------------------------------------
# kernel-registry entries (the JAX package registers these ops here too)
# ---------------------------------------------------------------------------

def _euclidean_cuda(sig: tuple) -> bool:
    """``supports`` of the KMeans kernels at ``(n, d, k, measure, ...,
    device)``: the euclidean measure on CUDA tensors (the kernels take
    any row count; a workset signature also needs one data device)."""
    from ...kernels.registry import on_cuda

    if len(sig) == 6 and sig[4] != 1:
        return False
    return on_cuda(sig) and sig[3] == "euclidean"


def _euclidean(sig: tuple) -> bool:
    return len(sig) >= 4 and sig[3] == "euclidean"


def _register_kmeans_kernels() -> None:
    """Op ``kmeans_update_stats``: ``"cuda"`` and its twin ``"plain"`` take
    ``fn(points, centroids, *, tie_policy, compute_dtype)``; ``"torch"``
    is the measure-generic body, ``fn(measure, k, points, mask,
    centroids)`` (the planning op's backends take different operands, as
    in the JAX package).  Op ``kmeans_workset_update``: ``fn(points,
    centroids, prev_assign, active, pad_mask)``.  Op ``kmeans_assign``:
    the stage convention at ``(measure, device)``."""
    from ...kernels.registry import cuda_only, on_cuda, register_kernel
    from ...ops import kmeans as K

    register_kernel("kmeans_assign", "cuda", _kmeans_assign_cuda,
                    priority=10, convention="stage",
                    supports=lambda sig: on_cuda(sig)
                    and sig[0] == "euclidean", available=cuda_only)
    register_kernel("kmeans_assign", "plain", _kmeans_assign_plain,
                    convention="stage")
    register_kernel("kmeans_update_stats", "cuda", K._update_stats_cuda,
                    priority=10, supports=_euclidean_cuda,
                    available=cuda_only)
    register_kernel("kmeans_update_stats", "plain",
                    K.kmeans_update_stats_plain, priority=5,
                    supports=_euclidean)
    register_kernel("kmeans_update_stats", "torch", _assign_stats)
    register_kernel("kmeans_workset_update", "cuda",
                    K._workset_update_cuda, priority=10,
                    supports=_euclidean_cuda, available=cuda_only)
    register_kernel("kmeans_workset_update", "plain",
                    K.kmeans_workset_update_plain, supports=_euclidean)


_register_kmeans_kernels()
