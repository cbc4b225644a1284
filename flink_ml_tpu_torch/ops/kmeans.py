"""KMeans kernels: one Lloyd's round fused over the points, with their plain
PyTorch versions.

The plain expansion of a round (score product -> argmin -> one-hot ->
product) writes two ``(n, k)`` intermediates to device memory: 1 GB each
at the headline shape (n = 2^20, d = 64, k = 256, f32).  The kernels
(CUDA C++ for Hopper, ``kernels/csrc/kmeans.cu``; its header note says
what bounds them on the H100 and how they are built) keep scores and
one-hot on chip and read the points once:

- :func:`kmeans_update_stats` — the fit's ``(sums, counts)`` under a tie
  policy (``first``, ``fast``, ``split``);
- :func:`kmeans_assign_reduce` — the first-index argmin assignment, plus
  sums and counts (the transform path);
- :func:`kmeans_workset_update` — one bound-filtered workset round: root
  distances, merged assignment, best and second-best distance, and the
  pad-masked stats.

The fit's ``first`` policy, the assignment and the workset round score
on the tensor cores (3xTF32: each product within ~1e-6 of its f32 value,
relative); the ``fast`` and ``split`` policies keep the CUDA cores' f32
FMAs, whose scores their exact-tie rule recomputes.

``kmeans_update_stats(..., compute_dtype=torch.bfloat16)`` is the JAX
package's bf16 variant: the points and centroids are rounded to bf16 for
the score product (f32 sums), ``|c|²`` stays f32 from the un-rounded
centroids, and the sums product takes bf16 points and bf16 shares (a
``split`` share of 1/3 enters the sums as 0.333984375) while ``counts``
adds the f32 shares.  Its kernel is ``kernels/csrc/kmeans_bf16.cu`` at
every shape, both products on ``wgmma`` for every tie policy, on the plan
:func:`bf16_plan` returns: at k <= 256, d <= 64 (the headline and the
data-parallel fit) one fused pass, the tiles by bulk copy and the ties
from the score registers; past it two passes over bf16 panels of the
points, a scoring pass that keeps each row's (minimum, first index, tie
count) and a sums pass per 256-cluster slab and 64-dim panel.  Either
way the op counts one launch under
``LAUNCHES["kmeans_update_stats_bf16"]``.

The kernels mask their ragged edge and take any row count.  They take
zero pad rows too, as the JAX package's maskless contract has it: a zero
row lands on the centroid(s) of least norm and adds nothing to ``sums``,
and :func:`pad_correction` removes it from ``counts``.

Each wrapper checks its operands and resolves through the kernel
registry (``kernels/registry.py``; the entries register in
``models/clustering/kmeans.py``, next to the model's plan): ops
``kmeans_update_stats``, ``kmeans_assign`` and ``kmeans_workset_update``
at a signature ending in the device type, so tensors on the CPU take
the plain version (``*_plain``) and CUDA tensors launch the kernel or
raise: it never falls back.  A launch adds one to :data:`LAUNCHES`.

A port of the JAX package's ``ops/kmeans_pallas.py``.  The TPU block
planning (``pick_block_n*``, ``supported``) has no counterpart: the
kernels plan their own shared memory.  Nor does its measured block
picker (``pick_block_n_measured``, autotuned through
``kernels/autotune.py`` there): the CUDA kernels' tiles are fixed in
their sources, so there is nothing to tune.  :func:`update_stats_sharded` runs
the stats kernel on this rank's rows and sums ``(sums, counts)`` over the
process group with one all-reduce (``parallel/collectives.py``).
"""

from __future__ import annotations

import ctypes
from collections import namedtuple
from typing import Dict, Tuple

import torch

from ..distance import DistanceMeasure
from ..kernels.build import count_launch
from ..kernels.registry import kernel_or_plain, lookup
from ..obs.trace import tracer

__all__ = ["kmeans_update_stats", "kmeans_update_stats_plain",
           "kmeans_assign_reduce", "kmeans_assign_reduce_plain",
           "kmeans_workset_update", "kmeans_workset_update_plain",
           "update_stats_sharded", "stats_from_assign", "pad_correction",
           "bf16_plan", "Bf16Plan", "TIE_POLICIES", "COMPUTE_DTYPES",
           "LAUNCHES", "reset_launch_counts"]

TIE_POLICIES = ("first", "fast", "split")
#: score-product types of :func:`kmeans_update_stats`
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)

#: Launches of each kernel since the last :func:`reset_launch_counts`.
#: Only a launch of the CUDA kernel counts, never a plain version.
#: The bf16 stats kernel counts under its own name.
LAUNCHES: Dict[str, int] = {"kmeans_update_stats": 0,
                            "kmeans_update_stats_bf16": 0,
                            "kmeans_assign_reduce": 0,
                            "kmeans_workset_update": 0}

# kernel modes of kmeans.cu (the first three are kmeans_bf16.cu's policies)
_MODES = {"first": 0, "fast": 1, "split": 2, "assign": 3, "workset": 4}
# kmeans_bf16.cu's fused pass: the bf16 centroids resident in shared
# memory in products of 128; a consumer lane's (k, d) partial (2 cluster
# blocks x 32 dims) beside a product's 64 scores in its 232 registers
_BF16_MAX_K, _BF16_MAX_D = 256, 64
# its two-pass plan: 16 KB panels (128 rows x 64 dims of bf16) a scoring
# block holds; up to 4 panels a row the launch's centroids are held there
# beside a ring of at least two tiles (and, at d 64 or 128, at least two
# 16 KB pieces of the f32 rows that the first launch packs), past that
# every panel streams.  The launcher lays out the plan it is given and
# refuses one that does not fit.
_SCORE_PANELS, _HELD_MAX_PANELS, _STREAM_CHUNKS, _SLAB = 13, 4, 16, 256
_F32_PIECES = 2

#: ``route`` "fused" or "two_pass"; ``panels`` 64-dim panels of a row;
#: ``held`` whether a scoring launch holds its centroids in shared memory;
#: ``chunks_per_launch`` 128-centroid chunks a scoring launch takes (the
#: fused pass: its score products); ``score_launches`` scoring launches
#: (super-slabs, in chunk order); ``slabs`` 256-cluster slabs and ``jobs``
#: (slabs x panels) of the sums pass.
Bf16Plan = namedtuple("Bf16Plan", "route panels held chunks_per_launch "
                      "score_launches slabs jobs")


def bf16_plan(k: int, d: int):
    """The plan of ``kmeans_bf16.cu`` for ``k`` centroids of ``d`` dims
    (``None`` for k < 1 or d < 1): the wrapper hands its route and chunk
    count to the launcher.

    k <= 256 and d <= 64: one fused pass (a consumer thread's share of
    the (k, d) partial, 2 blocks of 64 clusters x 64 dims, fits its
    registers beside a product's scores; the bf16 centroids fit shared
    memory), 1 or 2 score products of 128 centroids a tile.

    Past that, two passes over the points packed once into bf16 panels:
    scoring launches of ``chunks_per_launch`` chunks each carry every
    row's (minimum, first index, tie count) on, in chunk order; then one
    sums launch runs a job per (256-cluster slab, 64-dim panel), its
    partial in registers, rescoring the slab only on tiles with a tied
    row under ``fast``/``split``.  Up to 4 panels (d <= 256) a scoring
    block holds its chunks (13 panels less a ring of two tiles, and at
    d 64 or 128 less two panels' worth of f32 rows: there the first
    scoring launch packs the points itself), else every (points,
    centroids) panel pair streams, 16 chunks a launch."""
    if k < 1 or d < 1:
        return None
    if k <= _BF16_MAX_K and d <= _BF16_MAX_D:
        return Bf16Plan("fused", 1, True, 1 if k <= 128 else 2, 1, 1, 1)
    panels = -(-d // 64)
    kchunks = -(-k // 128)
    held = panels <= _HELD_MAX_PANELS
    f32 = _F32_PIECES if d in (64, 128) else 0
    cmax = ((_SCORE_PANELS - 2 * panels - f32) // panels if held
            else _STREAM_CHUNKS)
    launches = -(-kchunks // cmax)
    slabs = -(-k // _SLAB)
    return Bf16Plan("two_pass", panels, held, -(-kchunks // launches),
                    launches, slabs, slabs * panels)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest, ties to even) and held in f32:
    a product of two such values is exact in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _scores(points: torch.Tensor, centroids: torch.Tensor,
            compute_dtype=torch.float32) -> torch.Tensor:
    """``-2 p·cᵀ + |c|²`` (n, k): ``|p|²`` shifts a row uniformly and
    cannot change which centroids attain its minimum.  Under bf16 the
    product takes the rounded operands (f32 sums); ``|c|²`` is f32 from
    the un-rounded centroids either way."""
    c2 = torch.sum(centroids * centroids, dim=1)[None, :]
    if compute_dtype == torch.bfloat16:
        return -2.0 * (_bf16(points) @ _bf16(centroids).T) + c2
    return -2.0 * (points @ centroids.T) + c2


def _onehot(assign: torch.Tensor, k: int, dtype) -> torch.Tensor:
    iota = torch.arange(k, device=assign.device, dtype=assign.dtype)
    return (assign[:, None] == iota[None, :]).to(dtype)


def stats_from_assign(k: int, points: torch.Tensor, mask: torch.Tensor,
                      assign: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sums (k, d), counts (k,))`` of the points weighted by ``mask``,
    keyed by ``assign`` (an out-of-range index counts nowhere, as a JAX
    one-hot)."""
    onehot = _onehot(assign, k, points.dtype) * mask[:, None]
    return onehot.T @ points, torch.sum(onehot, dim=0)


def kmeans_update_stats_plain(points: torch.Tensor, centroids: torch.Tensor,
                              *, tie_policy: str = "fast",
                              compute_dtype=torch.float32
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sums, counts)`` of every row under ``tie_policy``: ``first`` the
    first-index argmin, ``fast`` every index equal to the row minimum,
    ``split`` 1/#ties to each.  Under ``compute_dtype=torch.bfloat16``
    the JAX kernel's casts, literally: bf16 operands in both products,
    f32 sums, ``counts`` of the f32 shares."""
    _check_policy(tie_policy)
    _check_dtype(compute_dtype)
    k = centroids.shape[0]
    scores = _scores(points, centroids, compute_dtype)
    if tie_policy == "first":
        onehot = _onehot(torch.argmin(scores, dim=1), k, points.dtype)
    else:
        onehot = (scores <= torch.min(scores, dim=1, keepdim=True).values
                  ).to(points.dtype)
        if tie_policy == "split":
            onehot = onehot / torch.sum(onehot, dim=1, keepdim=True)
    del scores
    counts = torch.sum(onehot, dim=0)
    if compute_dtype == torch.bfloat16:
        return _bf16(onehot).T @ _bf16(points), counts
    return onehot.T @ points, counts


def kmeans_assign_reduce_plain(points: torch.Tensor, centroids: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """``(assign (n,) int32, sums, counts)``: first-index argmin of the
    scores, and the stats of every row."""
    assign = torch.argmin(_scores(points, centroids), dim=1).to(torch.int32)
    ones = torch.ones(points.shape[0], dtype=points.dtype,
                      device=points.device)
    sums, counts = stats_from_assign(centroids.shape[0], points, ones, assign)
    return assign, sums, counts


def kmeans_workset_update_plain(points: torch.Tensor, centroids: torch.Tensor,
                                prev_assign: torch.Tensor,
                                active: torch.Tensor, pad_mask: torch.Tensor):
    """One workset round's scoring and stats, the expression of the JAX
    package's ``kmeans_workset_update_xla``: ``(assign, d_best, d_second,
    sums, counts)`` with ``assign`` merged (fresh where ``active``, the
    cached ``prev_assign`` elsewhere) and the fresh root distances."""
    k = centroids.shape[0]
    dists = DistanceMeasure.get_instance("euclidean").pairwise(points,
                                                               centroids)
    fresh = torch.argmin(dists, dim=1).to(torch.int32)
    is_min = _onehot(fresh, k, torch.bool)
    d_best = torch.min(dists, dim=1).values
    d_second = torch.min(torch.where(is_min, torch.inf, dists), dim=1).values
    del dists, is_min
    assign = torch.where(active > 0, fresh, prev_assign).to(torch.int32)
    sums, counts = stats_from_assign(k, points, pad_mask, assign)
    return assign, d_best, d_second, sums, counts


def pad_correction(counts: torch.Tensor, centroids: torch.Tensor, n_pad,
                   tie_policy: str = "fast") -> torch.Tensor:
    """Remove ``n_pad`` all-zero pad rows from ``counts``: they landed on
    the centroid(s) of least norm and added nothing to ``sums``.
    ``tie_policy`` names the policy of the kernel that counted them
    (``"argmin"`` for :func:`kmeans_assign_reduce`), so the fix stays exact
    when several centroids tie for least norm."""
    c2 = torch.sum(centroids * centroids, dim=1)
    if tie_policy in ("argmin", "first"):
        tied = _onehot(torch.argmin(c2)[None], counts.shape[0],
                       counts.dtype)[0]
    elif tie_policy in ("fast", "split"):
        tied = (c2 <= torch.min(c2)).to(counts.dtype)
        if tie_policy == "split":
            tied = tied / torch.sum(tied)
    else:
        raise ValueError(
            f"tie_policy must be 'first', 'fast', 'split' or 'argmin', "
            f"got {tie_policy!r}")
    return counts - n_pad * tied


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_LIB = None


def _kernels():
    """The built ``kmeans`` library with its C signatures declared (built
    on first use)."""
    global _LIB
    if _LIB is None:
        from ..kernels.build import load_library

        lib = load_library("kmeans")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kmeans_grid.argtypes = [ci, ci, ci, ci,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int64)]
        lib.kmeans_launch.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                      vp, vp, ci, ci, ci, ci, vp]
        lib.kmeans_grid.restype = ctypes.c_int
        lib.kmeans_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


_LIB_BF16 = None


def _kernels_bf16():
    """The built ``kmeans_bf16`` library with its C signatures declared
    (built on first use)."""
    global _LIB_BF16
    if _LIB_BF16 is None:
        from ..kernels.build import load_library

        lib = load_library("kmeans_bf16")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kmeans_bf16_grid.argtypes = [ci, ci, ci, ci, ci, ci,
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int64)]
        lib.kmeans_bf16_launch.argtypes = [ci, vp, vp, vp, vp, vp, ci, ci,
                                           ci, ci, ci, ci, vp]
        lib.kmeans_bf16_grid.restype = ctypes.c_int
        lib.kmeans_bf16_launch.restype = ctypes.c_int
        _LIB_BF16 = lib
    return _LIB_BF16


def _check_policy(tie_policy: str) -> None:
    if tie_policy not in TIE_POLICIES:
        raise ValueError(f"tie_policy must be 'first', 'fast' or 'split', "
                         f"got {tie_policy!r}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_dtype(compute_dtype) -> None:
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {compute_dtype!r}")


def _check_problem(points: torch.Tensor, centroids: torch.Tensor,
                   compute_dtype=torch.float32) -> Tuple[int, int, int]:
    _check_dtype(compute_dtype)
    if points.dim() != 2 or centroids.dim() != 2:
        raise ValueError("points and centroids must be 2-D")
    n, d = points.shape
    k = centroids.shape[0]
    if k < 1 or d < 1:
        raise ValueError(f"need k >= 1 and d >= 1, got k={k}, d={d}")
    dev = points.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _check("points", points, torch.float32, (n, d), dev)
    _check("centroids", centroids, torch.float32, (k, d), dev)
    return n, d, k


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name: str, mode: str, points: torch.Tensor,
            centroids: torch.Tensor, *, prev=None, active=None, pad_mask=None,
            assign=None, d_best=None, d_second=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``kmeans.cu`` in ``mode``; returns ``(sums, counts)`` and
    fills the given per-row outputs."""
    n, d = points.shape
    k = centroids.shape[0]
    dev = points.device
    lib = _kernels()
    with torch.cuda.device(dev):
        grid, size = ctypes.c_int(0), ctypes.c_int64(0)
        rc = lib.kmeans_grid(_MODES[mode], n, k, d, ctypes.byref(grid),
                             ctypes.byref(size))
        if rc != 0:
            raise RuntimeError(f"{name}: kernel planning failed: CUDA error "
                               f"{rc}")
        scratch = torch.empty(size.value, dtype=torch.float32, device=dev)
        sums = torch.empty((k, d), dtype=torch.float32, device=dev)
        counts = torch.empty(k, dtype=torch.float32, device=dev)
        rc = lib.kmeans_launch(
            _MODES[mode], _ptr(points), _ptr(centroids), _ptr(prev),
            _ptr(active), _ptr(pad_mask), _ptr(assign), _ptr(d_best),
            _ptr(d_second), _ptr(scratch), _ptr(sums), _ptr(counts), n, k, d,
            grid.value, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, name)
    return sums, counts


def _launch_bf16(tie_policy: str, points: torch.Tensor,
                 centroids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``kmeans_bf16.cu`` on the plan of :func:`bf16_plan`; returns
    ``(sums, counts)``."""
    n, d = points.shape
    k = centroids.shape[0]
    dev = points.device
    lib = _kernels_bf16()
    policy = _MODES[tie_policy]
    plan = bf16_plan(k, d)
    route = (0 if plan.route == "fused" else 1, plan.chunks_per_launch)
    with torch.cuda.device(dev):
        grid, size = ctypes.c_int(0), ctypes.c_int64(0)
        rc = lib.kmeans_bf16_grid(policy, n, k, d, *route,
                                  ctypes.byref(grid), ctypes.byref(size))
        if rc != 0:
            raise RuntimeError(f"kmeans_update_stats_bf16: kernel planning "
                               f"failed: CUDA error {rc}")
        scratch = torch.empty(size.value, dtype=torch.float32, device=dev)
        sums = torch.empty((k, d), dtype=torch.float32, device=dev)
        counts = torch.empty(k, dtype=torch.float32, device=dev)
        rc = lib.kmeans_bf16_launch(
            policy, _ptr(points), _ptr(centroids), _ptr(scratch), _ptr(sums),
            _ptr(counts), n, k, d, *route, grid.value,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kmeans_update_stats_bf16 kernel launch failed: "
                           f"CUDA error {rc}")
    count_launch(LAUNCHES, "kmeans_update_stats_bf16")
    return sums, counts


def _update_stats_cuda(points: torch.Tensor, centroids: torch.Tensor, *,
                       tie_policy: str = "fast", compute_dtype=torch.float32
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Op ``kmeans_update_stats``, backend ``"cuda"``: one launch of
    ``kmeans.cu`` (f32) or ``kmeans_bf16.cu`` (bf16)."""
    _on_card("kmeans_update_stats", points)
    if compute_dtype == torch.bfloat16:
        return _launch_bf16(tie_policy, points, centroids)
    return _launch("kmeans_update_stats", tie_policy, points, centroids)


def _on_card(name: str, points: torch.Tensor) -> None:
    if points.device.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, got "
                         f"{points.device}")


def kmeans_update_stats(points: torch.Tensor, centroids: torch.Tensor, *,
                        tie_policy: str = "fast",
                        compute_dtype=torch.float32
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit hot path: ``(points (n, d), centroids (k, d)) -> (sums (k, d),
    counts (k,))``, f32 in and out; ``compute_dtype`` (f32 or bf16) is the
    type of both products' operands.  Replaces the JAX package's
    ``kmeans_update_stats``.  Zero pad rows are counted; remove them with
    :func:`pad_correction`.  Deterministic."""
    _check_policy(tie_policy)
    n, d, k = _check_problem(points, centroids, compute_dtype)
    entry = lookup("kmeans_update_stats",
                   (n, d, k, "euclidean", points.device.type))
    with tracer.span("kmeans.stats", cat="train", device=points.device,
                     op=entry.backend):
        return entry.fn(points, centroids, tie_policy=tie_policy,
                        compute_dtype=compute_dtype)


def update_stats_sharded(points: torch.Tensor, centroids: torch.Tensor,
                         mesh=None, *, tie_policy: str = "fast",
                         compute_dtype=torch.float32, axis="data"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data-parallel stats: :func:`kmeans_update_stats` on this rank's
    rows (one kernel launch on the card), then one all-reduce sums
    ``(sums, counts)`` over ``axis`` (a name or a tuple of names) of
    ``mesh``'s process group (default: the default mesh), so every rank
    holds the global stats.  The counterpart of the JAX package's
    ``update_stats_sharded`` (a psum over the ``data`` axis)."""
    from ..parallel.collectives import psum_packed

    return psum_packed(kmeans_update_stats(points, centroids,
                                           tie_policy=tie_policy,
                                           compute_dtype=compute_dtype),
                       axis, mesh=mesh)


def _assign_reduce_cuda(points: torch.Tensor, centroids: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of ``kmeans.cu`` in its assign mode (op
    ``kmeans_assign``'s ``"cuda"`` stage runs it)."""
    _on_card("kmeans_assign_reduce", points)
    assign = torch.empty(points.shape[0], dtype=torch.int32,
                         device=points.device)
    sums, counts = _launch("kmeans_assign_reduce", "assign", points,
                           centroids, assign=assign)
    return assign, sums, counts


def kmeans_assign_reduce(points: torch.Tensor, centroids: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Transform path: ``(assign (n,) int32, sums (k, d), counts (k,))``,
    first-index argmin.  Replaces the JAX package's
    ``kmeans_assign_reduce``.  Deterministic."""
    _check_problem(points, centroids)
    fn = kernel_or_plain("kmeans_assign",
                         ("euclidean", points.device.type),
                         _assign_reduce_cuda, kmeans_assign_reduce_plain)
    return fn(points, centroids)


def _workset_update_cuda(points: torch.Tensor, centroids: torch.Tensor,
                         prev_assign: torch.Tensor, active: torch.Tensor,
                         pad_mask: torch.Tensor):
    """Op ``kmeans_workset_update``, backend ``"cuda"``: one launch of
    ``kmeans.cu`` in its workset mode."""
    _on_card("kmeans_workset_update", points)
    n = points.shape[0]
    dev = points.device
    assign = torch.empty(n, dtype=torch.int32, device=dev)
    d_best = torch.empty(n, dtype=torch.float32, device=dev)
    d_second = torch.empty(n, dtype=torch.float32, device=dev)
    sums, counts = _launch("kmeans_workset_update", "workset", points,
                           centroids, prev=prev_assign, active=active,
                           pad_mask=pad_mask, assign=assign, d_best=d_best,
                           d_second=d_second)
    return assign, d_best, d_second, sums, counts


def kmeans_workset_update(points: torch.Tensor, centroids: torch.Tensor,
                          prev_assign: torch.Tensor, active: torch.Tensor,
                          pad_mask: torch.Tensor):
    """One workset round: ``(points (n, d), centroids (k, d), prev_assign
    (n,) int32, active (n,) f32 0/1, pad_mask (n,) f32 0/1) -> (assign,
    d_best, d_second, sums, counts)``.  ``assign`` is merged (fresh where
    active, cached elsewhere); ``d_best``/``d_second`` are the fresh root
    distances; the stats are weighted by ``pad_mask``.  Replaces the JAX
    package's ``kmeans_workset_update``.  Euclidean only.
    Deterministic."""
    n, d, k = _check_problem(points, centroids)
    dev = points.device
    _check("prev_assign", prev_assign, torch.int32, (n,), dev)
    _check("active", active, torch.float32, (n,), dev)
    _check("pad_mask", pad_mask, torch.float32, (n,), dev)
    entry = lookup("kmeans_workset_update",
                   (n, d, k, "euclidean", 1, dev.type))
    return entry.fn(points, centroids, prev_assign, active, pad_mask)
