"""Statically routed embedding-table gradients, the Wide&Deep backward hot
path, with the fold kernel and its plain PyTorch version.

The backward forms the dense gradient of the stacked ``(total_vocab, E)``
table from per-slot rows: ``g_table[ids[s]] += g_rows[s]`` for ~213k slots a
step at the bench shape.  Autograd's scatter-add does one random
read-modify-write per slot (atomics on the card).  A bounded fit replays the
same epoch tensor every epoch, so the slot routing is static: one host sort
per fit turns the per-step scatter into streaming stages.

1. ``g_sorted = g_flat[order]``, a permutation gather
   (``torch.index_select``);
2. a segmented suffix fold over runs of equal ids: after
   ``ceil(log2(max_run))`` masked shift-adds the slot at each run's start
   holds the run's sum (:func:`fold_runs`, the CUDA kernel of
   ``kernels/csrc/emb_grad.cu``, one launch per group of up to seven
   passes; ``fold_passes`` is static per fit, 0 when
   every id of every step is unique, and then nothing launches);
3. placement of the run sums into the dense table:

   - ``placement="gather"``: ``dense = g_folded_ext[pos_map]``, one row
     gather at a per-step inverse map (``pos_map[v]`` = sorted position of
     row ``v``'s run start, ``S`` for untouched rows, which read an appended
     zero row).  Costs ``steps x num_rows`` i32 of route storage.
   - ``placement="scatter"``: the run-start rows picked at static positions
     and copied into a zero table at their unique ascending ids
     (``index_copy_`` into ``num_rows + U`` rows; pad entries carry the
     out-of-range ids ``num_rows + rank`` and land in the rows sliced off,
     the counterpart of XLA's ``mode="drop"``, with no host sync).  Route
     storage stays ``O(slots)``.

The result equals a scatter-add up to f32 summation order (runs fold
pairwise).  The same route serves any payload width; the wide tower's
``(total_vocab,)`` scalar table uses it with ``E == 1`` squeezed.

:func:`fold_runs` takes its plain version (:func:`fold_runs_plain`, the
masked shift-add tree of the JAX package's ``_folded_ext``) for tensors on
the CPU, and launches the kernel for CUDA tensors or raises: it never falls
back.  A launch adds one to :data:`LAUNCHES`.  The kernel equals the plain
version bit for bit on every row.

The choice is the kernel registry's (``kernels/registry.py``): op
``routed_table_grad`` registers here (:func:`_register_emb_grad_kernels`)
as ``"cuda"`` (the route's stages with the fold kernel) and ``"plain"``
(with :func:`fold_runs_plain`), both taking ``fn(route, g_flat,
*step_arrays)`` at the signature :meth:`EmbGradRoute.kernel_sig`
``(placement, fold_passes, slots, device type)``; :meth:`EmbGradRoute.apply`
and :func:`fold_runs` resolve through it.

A port of the JAX package's ``ops/emb_grad.py`` and
``ops/emb_grad_pallas.py``.  Unlike the TPU kernel, the CUDA kernel has
no block-divisibility rule, so its entry serves every ``S`` and both
placements.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch

from ..kernels.build import count_launch
from ..kernels.registry import (cuda_only, kernel_or_plain, lookup, on_cuda,
                                register_kernel)

__all__ = ["EmbGradRoute", "emb_grad_route", "routed_table_grad",
           "routed_table_grad_gather", "fold_runs", "fold_runs_plain",
           "LAUNCHES", "reset_launch_counts"]

#: placement="auto" picks gather until the inverse map would cost more than
#: this (steps x num_rows x 4 bytes of route storage), then scatter.
_POS_MAP_BUDGET_BYTES = 512 << 20

#: Launches of the fold kernel since the last :func:`reset_launch_counts`
#: (one per :func:`fold_runs` call on the card, whatever number of CUDA
#: launches it takes).  Only a launch of the CUDA kernel counts.
LAUNCHES: Dict[str, int] = {"fold_runs": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass
class EmbGradRoute:
    """Static per-step routing for :func:`routed_table_grad` /
    :func:`routed_table_grad_gather`: int32 tensors stacked per step
    (leading dim = steps).  Exactly one placement group is set:
    ``pos_map`` for ``"gather"``, ``out_pos``/``out_ids`` for
    ``"scatter"``."""

    order: torch.Tensor       # (steps, S): stable sort of the slot ids
    sorted_ids: torch.Tensor  # (steps, S): the ids in sorted order
    fold_passes: int          # ceil(log2(longest run)) over every step
    num_rows: int             # rows of the destination table
    placement: str = "gather"
    pos_map: Optional[torch.Tensor] = None   # (steps, num_rows), S = none
    out_pos: Optional[torch.Tensor] = None   # (steps, U), pad = S
    out_ids: Optional[torch.Tensor] = None   # (steps, U), pad = num_rows+rank

    @property
    def steps(self) -> int:
        return self.order.shape[0]

    def stacked_arrays(self):
        """The per-step stacks, in :meth:`step_slice` order."""
        if self.placement == "gather":
            return (self.order, self.sorted_ids, self.pos_map)
        return (self.order, self.sorted_ids, self.out_pos, self.out_ids)

    def step_slice(self, i: int):
        """The route tensors of step ``i``."""
        return tuple(a[i] for a in self.stacked_arrays())

    def to(self, device) -> "EmbGradRoute":
        """The same route with its tensors on ``device``."""
        def move(a):
            return None if a is None else a.to(device)

        return replace(self, order=move(self.order),
                       sorted_ids=move(self.sorted_ids),
                       pos_map=move(self.pos_map), out_pos=move(self.out_pos),
                       out_ids=move(self.out_ids))

    def kernel_sig(self, device: str) -> tuple:
        """The signature op ``routed_table_grad`` resolves at:
        ``(placement, fold_passes, slots, device type)``."""
        return (self.placement, self.fold_passes, int(self.order.shape[-1]),
                device)

    def apply(self, g_flat: torch.Tensor, *step_arrays,
              plain: bool = False) -> torch.Tensor:
        """Dense table gradient from one step's route tensors (either
        placement), through the implementation of op
        ``routed_table_grad`` the kernel registry resolves.  ``plain``
        forces the plain version whatever the device (for comparisons on
        the card)."""
        entry = lookup("routed_table_grad",
                       sig=self.kernel_sig(g_flat.device.type),
                       backend="plain" if plain else None)
        return entry.fn(self, g_flat, *step_arrays)

    def _apply(self, g_flat, step_arrays, plain: bool) -> torch.Tensor:
        if self.placement == "gather":
            order, sid, pos_map = step_arrays
            return routed_table_grad_gather(
                g_flat, order, sid, pos_map, fold_passes=self.fold_passes,
                plain=plain)
        order, sid, out_pos, out_ids = step_arrays
        return routed_table_grad(
            g_flat, order, sid, out_pos, out_ids, num_rows=self.num_rows,
            fold_passes=self.fold_passes, plain=plain)


def emb_grad_route(cat_steps: np.ndarray, num_rows: int,
                   u_cap: Optional[int] = None,
                   placement: str = "gather") -> EmbGradRoute:
    """The static routing of a ``(steps, batch, fields)`` int epoch tensor
    of (already offset) ids: host numpy, one stable argsort per step, once
    per fit.  Returns CPU tensors; :meth:`EmbGradRoute.to` moves them.

    ``placement``: ``"gather"``, ``"scatter"`` or ``"auto"`` (gather while
    the inverse map fits ``_POS_MAP_BUDGET_BYTES``).  ``u_cap`` forces the
    unique-run capacity of the scatter placement; a step with more unique
    ids raises (under either placement) rather than drop gradient rows."""
    if placement not in ("auto", "gather", "scatter"):
        raise ValueError(f"unknown placement {placement!r}")
    cat_steps = np.asarray(cat_steps)
    steps = cat_steps.shape[0]
    S = int(np.prod(cat_steps.shape[1:]))
    if placement == "auto":
        placement = ("gather"
                     if steps * num_rows * 4 <= _POS_MAP_BUDGET_BYTES
                     else "scatter")
    orders = np.empty((steps, S), np.int32)
    sids = np.empty((steps, S), np.int32)
    starts_list = []
    max_run = 1
    for s in range(steps):
        flat = cat_steps[s].reshape(-1)
        order = np.argsort(flat, kind="stable").astype(np.int32)
        sid = flat[order].astype(np.int32)
        orders[s] = order
        sids[s] = sid
        start = np.empty(S, bool)
        start[0] = True
        np.not_equal(sid[1:], sid[:-1], out=start[1:])
        pos = np.flatnonzero(start).astype(np.int32)
        starts_list.append((pos, sid[pos]))
        runs = np.diff(np.append(pos, S))
        max_run = max(max_run, int(runs.max(initial=1)))
    fold_passes = (max(0, int(np.ceil(np.log2(max_run))))
                   if max_run > 1 else 0)
    need_u = max(p.size for p, _ in starts_list)
    if u_cap is not None and need_u > u_cap:
        raise ValueError(
            f"route needs {need_u} unique ids in some step > forced "
            f"u_cap {u_cap}; gradient rows would silently drop — raise "
            "the cap")
    t = torch.from_numpy
    if placement == "gather":
        pos_map = np.full((steps, num_rows), S, np.int32)
        for s, (pos, uids) in enumerate(starts_list):
            pos_map[s][uids] = pos
        return EmbGradRoute(order=t(orders), sorted_ids=t(sids),
                            pos_map=t(pos_map), fold_passes=fold_passes,
                            num_rows=num_rows, placement="gather")
    U = u_cap if u_cap is not None else need_u
    out_pos = np.full((steps, U), S, np.int32)
    # pad ids: ascending, unique and out of range (sliced off after the copy)
    out_ids = (num_rows
               + np.arange(U, dtype=np.int32)[None, :].repeat(steps, 0))
    for s, (pos, uids) in enumerate(starts_list):
        out_pos[s, :pos.size] = pos
        out_ids[s, :uids.size] = uids
    return EmbGradRoute(order=t(orders), sorted_ids=t(sids),
                        out_pos=t(out_pos), out_ids=t(out_ids),
                        fold_passes=fold_passes, num_rows=num_rows,
                        placement="scatter")


# ---------------------------------------------------------------------------
# the fold: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def fold_runs_plain(g_sorted: torch.Tensor, sorted_ids: torch.Tensor,
                    fold_passes: int) -> torch.Tensor:
    """All ``fold_passes`` masked shift-add passes of the sorted rows
    ``(S, E)`` (or ``(S,)``): after pass k (offset 2^k), ``g[i]`` holds the
    sum of rows ``i .. min(run_end, i + 2^(k+1) - 1)``.  The tree of the
    JAX package's ``_folded_ext``; rows past ``S`` read as 0 and never
    match."""
    squeeze = g_sorted.dim() == 1
    g = g_sorted[:, None] if squeeze else g_sorted
    S = g.shape[0]
    offs = 1
    for _ in range(fold_passes):
        same = torch.zeros(S, dtype=torch.bool, device=g.device)
        shifted = torch.zeros_like(g)
        if offs < S:
            same[:S - offs] = sorted_ids[offs:] == sorted_ids[:-offs]
            shifted[:S - offs] = g[offs:]
        g = g + torch.where(same[:, None], shifted, 0.0)
        offs *= 2
    return g[:, 0] if squeeze else g


_LIB = None


def _kernels():
    """The built ``emb_grad`` library with its C signatures declared (built
    on first use)."""
    global _LIB
    if _LIB is None:
        from ..kernels.build import load_library

        lib = load_library("emb_grad")
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.emb_fold_group_levels.argtypes = []
        lib.emb_fold_group_levels.restype = ci
        lib.emb_fold_launch.argtypes = [vp, vp, vp, vp, cl, ci, ci, vp]
        lib.emb_fold_launch.restype = ci
        _LIB = lib
    return _LIB


def _fold_runs_cuda(g_sorted: torch.Tensor, sorted_ids: torch.Tensor,
                    fold_passes: int) -> torch.Tensor:
    """One call of the fold kernel (a launch a group of levels)."""
    g = g_sorted[:, None] if g_sorted.dim() == 1 else g_sorted
    S, E = g.shape
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"the fold_runs kernel takes CUDA tensors, got "
                         f"{dev}")
    if not g.is_contiguous() or not sorted_ids.is_contiguous():
        raise ValueError("g_sorted and sorted_ids must be contiguous")
    res = torch.empty_like(g_sorted)
    lib = _kernels()
    with torch.cuda.device(dev):
        # the level groups after the first ping-pong through a scratch copy
        scratch = (torch.empty_like(g)
                   if fold_passes > lib.emb_fold_group_levels() else None)
        rc = lib.emb_fold_launch(
            g.data_ptr(), sorted_ids.data_ptr(), res.data_ptr(),
            None if scratch is None else scratch.data_ptr(), S, E,
            fold_passes, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fold_runs kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "fold_runs")
    return res


def fold_runs(g_sorted: torch.Tensor, sorted_ids: torch.Tensor,
              fold_passes: int) -> torch.Tensor:
    """All ``fold_passes >= 1`` fold passes of the sorted rows ``(S, E)``
    f32 (or ``(S,)``) under ``sorted_ids (S,)`` int32, in one kernel call:
    run starts end up holding their run sums.  Replaces the JAX package's
    ``fold_runs_fused``.  Any ``S``; deterministic; equal bit for bit to
    :func:`fold_runs_plain`.  Kernel or plain version as op
    ``routed_table_grad`` resolves at ``(None, fold_passes, S, device
    type)`` (the fold is the same for both placements)."""
    if fold_passes < 1:
        raise ValueError(f"fold_runs needs fold_passes >= 1, got "
                         f"{fold_passes} (nothing to fold)")
    g = g_sorted[:, None] if g_sorted.dim() == 1 else g_sorted
    if g.dim() != 2:
        raise ValueError(f"g_sorted must be (S,) or (S, E), got shape "
                         f"{tuple(g_sorted.shape)}")
    S = g.shape[0]
    dev = g.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if g.dtype != torch.float32:
        raise TypeError(f"g_sorted must be torch.float32, got {g.dtype}")
    if sorted_ids.dtype != torch.int32:
        raise TypeError(f"sorted_ids must be torch.int32, got "
                        f"{sorted_ids.dtype}")
    if tuple(sorted_ids.shape) != (S,):
        raise ValueError(f"sorted_ids must have shape {(S,)}, got "
                         f"{tuple(sorted_ids.shape)}")
    if sorted_ids.device != dev:
        raise ValueError(f"sorted_ids is on {sorted_ids.device}, expected "
                         f"{dev}")
    fold = kernel_or_plain("routed_table_grad",
                           (None, fold_passes, S, dev.type),
                           _fold_runs_cuda, fold_runs_plain)
    return fold(g_sorted, sorted_ids, fold_passes)


# ---------------------------------------------------------------------------
# routed table gradients
# ---------------------------------------------------------------------------

def _folded_ext(g_flat: torch.Tensor, order: torch.Tensor,
                sorted_ids: torch.Tensor, fold_passes: int,
                plain: bool = False):
    """Stages 1-2, shared by both placements: the permutation gather, then
    the fold (the kernel on the card unless ``plain``; nothing for
    ``fold_passes == 0``).  Returns ``(g_ext, squeeze)``: ``g_ext (S + 1,
    E)`` ends in a zero row (position ``S``, what pads read)."""
    squeeze = g_flat.dim() == 1
    g = torch.index_select(g_flat[:, None] if squeeze else g_flat, 0, order)
    if fold_passes:
        fold = fold_runs_plain if plain else fold_runs
        g = fold(g, sorted_ids, fold_passes)
    return torch.cat([g, g.new_zeros((1, g.shape[1]))]), squeeze


def routed_table_grad(g_flat: torch.Tensor, order: torch.Tensor,
                      sorted_ids: torch.Tensor, out_pos: torch.Tensor,
                      out_ids: torch.Tensor, *, num_rows: int,
                      fold_passes: int, plain: bool = False) -> torch.Tensor:
    """The dense ``(num_rows, E)`` (or ``(num_rows,)``) table gradient from
    per-slot rows ``g_flat (S, E)`` through one step's route, scatter
    placement.  Equals ``zeros.index_add_(0, ids, g_flat)`` up to f32
    summation order."""
    g_ext, squeeze = _folded_ext(g_flat, order, sorted_ids, fold_passes,
                                 plain)
    run_sums = torch.index_select(g_ext, 0, out_pos)
    out = g_ext.new_zeros((num_rows + out_ids.shape[0], g_ext.shape[1]))
    out.index_copy_(0, out_ids.long(), run_sums)
    out = out[:num_rows]
    return out[:, 0] if squeeze else out


def routed_table_grad_gather(g_flat: torch.Tensor, order: torch.Tensor,
                             sorted_ids: torch.Tensor, pos_map: torch.Tensor,
                             *, fold_passes: int, plain: bool = False
                             ) -> torch.Tensor:
    """Gather placement: the dense gradient is one row gather of the folded
    rows at the inverse map ``pos_map (num_rows,)`` (``S`` = untouched, the
    zero row).  Same result as :func:`routed_table_grad`."""
    g_ext, squeeze = _folded_ext(g_flat, order, sorted_ids, fold_passes,
                                 plain)
    out = torch.index_select(g_ext, 0, pos_map)
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# kernel-registry entries: op ``routed_table_grad``
# ---------------------------------------------------------------------------

def routed_apply_cuda(route: EmbGradRoute, g_flat, *step_arrays):
    """Backend ``"cuda"``: the route's stages with the fold kernel."""
    return route._apply(g_flat, step_arrays, plain=False)


def routed_apply_plain(route: EmbGradRoute, g_flat, *step_arrays):
    """Backend ``"plain"``: the route's stages with the plain fold."""
    return route._apply(g_flat, step_arrays, plain=True)


def _register_emb_grad_kernels() -> None:
    register_kernel("routed_table_grad", "cuda", routed_apply_cuda,
                    priority=20, supports=on_cuda, available=cuda_only)
    register_kernel("routed_table_grad", "plain", routed_apply_plain)


_register_emb_grad_kernels()
