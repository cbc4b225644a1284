"""ELL static routing for the hashed-layout linear trainers (the mixed
layout, and the generic sparse (indices, values) layout, whose slots carry
values): the host and device layout builds, and the three ELL kernels with
their plain PyTorch versions.

One SGD step on the Criteo-shaped mixed layout gathers ``w[cat[b, j]]`` for
the margin and applies ``w[cat[b, j]] += -lr * r[b]`` for ~1M (slot ->
weight) pairs per batch.  The trainer replays the SAME epoch tensor every
epoch, so the slot -> weight routing is static: :func:`ell_layout` sorts
each step's slots once per fit and buckets them by weight-table row
``idx >> 7`` (the table viewed as ``(d/128, 128)`` lanes).  Each table row
gets up to 128 slots (``src`` = the batch row each slot charges, sorted by
lane within the row); rows with more slots spill to a short overflow list,
and an index repeated more than ``heavy_threshold`` times in a step (a label
marker, a dominant category) leaves the grid for a dense count matrix.

Per row the scatter then needs no random writes: with ``P[row, l]`` the
position of the last slot whose lane is ``<= l`` (``pos``, with ``mask`` = 0
where there is none), the lane totals are differences of the running sum
of the slot updates picked at ``P``::

    C     = cumsum(u, lanes)
    G     = C[P] * mask
    delta = G - shift(G, 1 lane)

The margin reads the layout the other way round: :func:`sample_routing`
inverts it once per fit into a sample-major routing (each sample's in-grid
weight indices, in ascending grid position), so each sample's margin is a
gather-and-sum in a fixed order, with no atomics.

The three kernels (CUDA C++ for Hopper, ``kernels/csrc/ell_scatter.cu``;
its header note says what bounds each on the H100 and how each is built):

- :func:`ell_margin` — per-sample margin of the in-grid slots, over the
  sample routing;
- :func:`ell_scatter_apply_fused` — ``w + scatter(-lr * val * r_ext[src])``;
- :func:`ell_scatter_apply` — the same scatter of a precomputed ``upd``
  (the pair path, for grids whose row count is not a multiple of 8).

The kernel registry (``kernels/registry.py``) is the one place that
picks between a kernel and its plain PyTorch version (``*_plain``): each
wrapper checks its operands and resolves through ``registry.lookup`` with
a signature ``(table_rows, device type)``, so tensors on the CPU take the
plain version and CUDA tensors launch the kernel or raise: it never falls
back.  The ops register here (:func:`_register_ell_kernels`): op
``ell_margin`` (``"cuda"``, ``"plain"``) and op ``ell_scatter_apply``
(``"cuda"``, the fused kernel on grids of whole 8-row blocks;
``"cuda-pair"``, the gather + pair kernel on any grid; ``"plain"``), the
trainers calling their entries with one signature.  A launch adds one to
:data:`LAUNCHES`.

A port of the JAX package's ``ops/ell_scatter.py`` (host layout, the
device-side layout builder, kernels and their XLA twins).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.build import count_launch
from ..kernels.registry import (cuda_only, kernel_or_plain, lookup, on_cuda,
                                register_kernel)

__all__ = ["EllLayout", "ell_layout", "ell_layout_device", "supported",
           "ELL_WIDTH",
           "HEAVY_THRESHOLD", "sample_routing", "ell_margin",
           "ell_margin_plain", "ell_scatter_apply_fused",
           "ell_scatter_apply_fused_plain",
           "ell_scatter_apply", "ell_scatter_apply_plain",
           "gather_weights", "LAUNCHES", "reset_launch_counts",
           "FUSED_BLOCK_ROWS"]

ELL_WIDTH = 128          # slots per table row = lanes per row
_LANES = 128             # table view (d // 128, 128)
#: The fused scatter runs on grids whose row count divides into blocks of
#: this many rows; other grids take the pair path (the JAX package's rule,
#: kept so both packages plan the same kernels for the same width).
FUSED_BLOCK_ROWS = 8

#: Launches of each kernel since the last :func:`reset_launch_counts`.
#: Only a launch of the CUDA kernel counts, never a plain version.
LAUNCHES: Dict[str, int] = {"ell_margin": 0, "ell_scatter_apply_fused": 0,
                            "ell_scatter_apply": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supported(num_features: int) -> bool:
    """Kernel precondition: the weight table reshapes into at least 128
    whole 128-lane rows."""
    return num_features % _LANES == 0 and num_features // _LANES >= 128


# ---------------------------------------------------------------------------
# host layout
# ---------------------------------------------------------------------------

@dataclass
class EllLayout:
    """Static per-step routing.  All arrays are per-step stacks (leading
    dim = steps): host numpy from :func:`ell_layout`, torch tensors after
    :meth:`to`.

    Heavy hitters: an index occurring more than ``heavy_threshold`` times
    in a step leaves the per-slot paths for a dense count matrix; its
    update is ``-lr * (counts @ r)``."""
    src: object        # (steps, rows, 128) i32: batch row charged, or
                       #   ``batch`` (points at the zero pad of r_ext)
    pos: object        # (steps, rows, 128) i32: clamped csum pick P
    mask: object       # (steps, rows, 128) f32: 0 where P was empty
    ovf_idx: object    # (steps, cap) i32: overflow weight indices (0 pad)
    ovf_src: object    # (steps, cap) i32: overflow batch rows (batch pad)
    heavy_idx: object  # (steps, H) i32: heavy indices (0 pad)
    heavy_cnt: object  # (steps, H, batch): per-row counts (i16), or
                       #   per-row VALUE SUMS (f32) with `values`
    batch: int
    num_features: int
    # generic (indices, values) sparse layout only
    val: Optional[object] = None       # (steps, rows, 128) f32
    ovf_val: Optional[object] = None   # (steps, cap) f32
    # slots NEEDED per step (host numpy), whatever the caps could hold
    need_ovf: Optional[np.ndarray] = None    # (steps,) i32
    need_heavy: Optional[np.ndarray] = None  # (steps,) i32

    @property
    def steps(self) -> int:
        return self.src.shape[0]

    def assert_capacities(self) -> "EllLayout":
        """Fail loudly if any step needs more overflow/heavy slots than the
        caps hold."""
        if self.need_ovf is not None:
            cap = self.ovf_idx.shape[1]
            worst = int(np.max(self.need_ovf))
            if worst > cap:
                raise ValueError(
                    f"ELL overflow needs {worst} slots in some step > "
                    f"ovf_cap {cap}; gradients would silently drop slots "
                    "— raise ovf_cap")
        if self.need_heavy is not None:
            hcap = self.heavy_idx.shape[1]
            worst_h = int(np.max(self.need_heavy))
            if worst_h > hcap:
                raise ValueError(
                    f"ELL heavy path needs {worst_h} indices in some step "
                    f"> heavy_cap {hcap}; raise heavy_cap")
        return self

    def trim_overflow(self, margin: int = 2) -> "EllLayout":
        """Slice the overflow arrays down to the measured need (x
        ``margin``, rounded to 8).  Both layout paths front-compact the real
        entries, so slicing is exact.  No-op when the cap is already tight
        or the need is unknown."""
        if self.need_ovf is None:
            return self
        cap = max(8, int(np.asarray(self.need_ovf).max()) * margin)
        cap += (-cap) % 8
        if cap >= self.ovf_idx.shape[1]:
            return self
        return replace(
            self, ovf_idx=self.ovf_idx[:, :cap],
            ovf_src=self.ovf_src[:, :cap],
            ovf_val=None if self.ovf_val is None
            else self.ovf_val[:, :cap])

    def to(self, device) -> "EllLayout":
        """The same layout as torch tensors on ``device`` (one copy)."""
        def put(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)).to(device)
        return replace(
            self, src=put(self.src), pos=put(self.pos), mask=put(self.mask),
            ovf_idx=put(self.ovf_idx), ovf_src=put(self.ovf_src),
            heavy_idx=put(self.heavy_idx), heavy_cnt=put(self.heavy_cnt),
            val=put(self.val), ovf_val=put(self.ovf_val))


HEAVY_THRESHOLD = 512   # slots per index per step before the dense path


def _check_heavy_threshold(heavy_threshold: int) -> None:
    """A threshold below ELL_WIDTH would let a heavy run inflate the raw
    ``pos`` of kept same-row slots past their rank among kept slots, so
    their cumsum picks would read the zero pad — silently dropped
    updates.  With threshold >= ELL_WIDTH every slot after a heavy run
    has pos > 127 and routes to overflow, which is exact."""
    if heavy_threshold < ELL_WIDTH:
        raise ValueError(
            f"heavy_threshold must be >= ELL_WIDTH ({ELL_WIDTH}); "
            f"got {heavy_threshold}")


def _ell_one_step(flat: np.ndarray, batch: int, nnz: int, rows: int,
                  heavy_threshold: int,
                  values: "Optional[np.ndarray]" = None
                  ) -> Tuple[np.ndarray, ...]:
    """Numpy layout for one step's flattened indices (batch*nnz,).  With
    ``values`` (same flat shape), each slot carries a coefficient: the
    layout also emits the value arrays and the heavy matrix holds VALUE
    SUMS instead of counts."""
    b_of = np.repeat(np.arange(batch, dtype=np.int32), nnz)
    # sentinel indices (>= num_features, padding rows) drop out entirely
    in_range = flat < rows * _LANES
    if not in_range.all():
        flat = flat[in_range]
        b_of = b_of[in_range]
        if values is not None:
            values = values[in_range]
    order = np.argsort(flat, kind="stable")
    sidx = flat[order]
    ssrc = b_of[order]
    svals = values[order] if values is not None else None
    row = sidx >> 7
    lo = (sidx & 127).astype(np.int32)
    starts = np.searchsorted(row, np.arange(rows, dtype=np.int64))
    pos = np.arange(flat.size, dtype=np.int64) - starts[row]
    # heavy indices: the whole run leaves the per-slot paths
    run_start = np.searchsorted(sidx, sidx, side="left")
    run_end = np.searchsorted(sidx, sidx, side="right")
    heavy_slot = (run_end - run_start) > heavy_threshold
    keep = (pos < ELL_WIDTH) & ~heavy_slot

    src = np.full((rows, ELL_WIDTH), batch, np.int32)
    src[row[keep], pos[keep]] = ssrc[keep]
    val = None
    if svals is not None:
        val = np.zeros((rows, ELL_WIDTH), np.float32)
        val[row[keep], pos[keep]] = svals[keep]
    hist = np.zeros((rows, 128), np.int64)
    np.add.at(hist, (row[keep], lo[keep]), 1)
    P = np.cumsum(hist, axis=1) - 1
    mask = (P >= 0).astype(np.float32)
    Pc = np.maximum(P, 0).astype(np.int32)

    spill = ~keep & ~heavy_slot
    ovf_idx = sidx[spill].astype(np.int32)
    ovf_src = ssrc[spill]
    ovf_val = svals[spill].astype(np.float32) if svals is not None else None

    h_idx = np.unique(sidx[heavy_slot]).astype(np.int32)
    h_cnt = np.zeros((h_idx.size, batch),
                     np.int16 if svals is None else np.float32)
    if h_idx.size:
        h_rank = np.searchsorted(h_idx, sidx[heavy_slot])
        np.add.at(h_cnt, (h_rank, ssrc[heavy_slot]),
                  1 if svals is None else svals[heavy_slot])
    return src, Pc, mask, ovf_idx, ovf_src, h_idx, h_cnt, val, ovf_val


_ELL_NATIVE = None
_ELL_NATIVE_TRIED = False


def _native_ell():
    """The C++ layout library (``native/ell_layout.cpp``) or None (numpy path)."""
    global _ELL_NATIVE, _ELL_NATIVE_TRIED
    if not _ELL_NATIVE_TRIED:
        _ELL_NATIVE_TRIED = True
        from ..utils.native_lib import load_native_lib

        _ELL_NATIVE = load_native_lib("ell_layout")
    return _ELL_NATIVE


def _ell_layout_native(lib, cat_indices: np.ndarray, num_features: int,
                       heavy_threshold: int,
                       values: "Optional[np.ndarray]",
                       pad_ovf_cap: Optional[int],
                       pad_heavy_cap: Optional[int]):
    """Native counting-sort build; semantics identical to the numpy path
    (heavy f32 value-sums may differ in summation order only)."""
    steps, batch, nnz = cat_indices.shape
    rows = num_features // _LANES
    flat = np.ascontiguousarray(cat_indices, np.int32)
    with_values = values is not None
    vals = (np.ascontiguousarray(values, np.float32) if with_values
            else None)

    src = np.empty((steps, rows, ELL_WIDTH), np.int32)
    pos = np.empty((steps, rows, ELL_WIDTH), np.int32)
    mask = np.empty((steps, rows, ELL_WIDTH), np.float32)
    val = (np.empty((steps, rows, ELL_WIDTH), np.float32) if with_values
           else None)
    need_o = np.zeros((steps,), np.int32)
    need_h = np.zeros((steps,), np.int32)

    def run(ovf_cap: int, heavy_cap: int):
        ovf_idx = np.empty((steps, ovf_cap), np.int32)
        ovf_src = np.empty((steps, ovf_cap), np.int32)
        ovf_val = (np.empty((steps, ovf_cap), np.float32) if with_values
                   else None)
        heavy_idx = np.empty((steps, heavy_cap), np.int32)
        heavy_cnt = np.empty((steps, heavy_cap, batch),
                             np.float32 if with_values else np.int16)

        def ptr(a, typ):
            return (a.ctypes.data_as(ctypes.POINTER(typ))
                    if a is not None else None)

        rc = lib.ell_build(
            ptr(flat, ctypes.c_int32), ptr(vals, ctypes.c_float),
            ctypes.c_int64(steps), ctypes.c_int64(batch),
            ctypes.c_int64(nnz), ctypes.c_int64(rows),
            ctypes.c_int64(heavy_threshold),
            ctypes.c_int64(ovf_cap), ctypes.c_int64(heavy_cap),
            ptr(src, ctypes.c_int32), ptr(pos, ctypes.c_int32),
            ptr(mask, ctypes.c_float), ptr(val, ctypes.c_float),
            ptr(ovf_idx, ctypes.c_int32), ptr(ovf_src, ctypes.c_int32),
            ptr(ovf_val, ctypes.c_float), ptr(heavy_idx, ctypes.c_int32),
            heavy_cnt.ctypes.data_as(ctypes.c_void_p),
            ptr(need_o, ctypes.c_int32), ptr(need_h, ctypes.c_int32))
        return rc, ovf_idx, ovf_src, ovf_val, heavy_idx, heavy_cnt

    # first call: forced caps verbatim, else a generous guess; a capacity
    # miss reports exact needs and one retry lands it
    cap0 = pad_ovf_cap if pad_ovf_cap is not None else max(1024, batch)
    cap0 += (-cap0) % 8
    h0 = pad_heavy_cap if pad_heavy_cap is not None else 16
    rc, ovf_idx, ovf_src, ovf_val, heavy_idx, heavy_cnt = run(cap0, h0)
    need_ovf, need_heavy = int(need_o.max()), int(need_h.max())
    if pad_ovf_cap is not None and need_ovf > pad_ovf_cap:
        raise ValueError(
            f"overflow needs {need_ovf} slots > forced cap "
            f"{pad_ovf_cap}; raise the cap (streaming: ell_ovf_cap)")
    if pad_heavy_cap is not None and need_heavy > pad_heavy_cap:
        raise ValueError(
            f"{need_heavy} heavy indices > forced cap "
            f"{pad_heavy_cap}; raise the cap (streaming: "
            "ell_heavy_cap)")
    if rc:
        cap0 = max(cap0, need_ovf + (-need_ovf) % 8)
        h0 = max(h0, need_heavy)
        rc, ovf_idx, ovf_src, ovf_val, heavy_idx, heavy_cnt = run(cap0, h0)
        if rc:
            raise RuntimeError(
                "native ell_build retry with exact caps failed")

    # shrink to the numpy path's exact cap arithmetic
    cap = pad_ovf_cap if pad_ovf_cap is not None else max(8, need_ovf)
    cap += (-cap) % 8
    H = pad_heavy_cap if pad_heavy_cap is not None else max(1, need_heavy)
    return (src, pos, mask,
            np.ascontiguousarray(ovf_idx[:, :cap]),
            np.ascontiguousarray(ovf_src[:, :cap]),
            None if not with_values
            else np.ascontiguousarray(ovf_val[:, :cap]),
            np.ascontiguousarray(heavy_idx[:, :H]),
            np.ascontiguousarray(heavy_cnt[:, :H]),
            val, need_o.copy(), need_h.copy())


def ell_layout(cat_indices: np.ndarray, num_features: int,
               heavy_threshold: int = HEAVY_THRESHOLD,
               values: "Optional[np.ndarray]" = None,
               pad_ovf_cap: Optional[int] = None,
               pad_heavy_cap: Optional[int] = None) -> EllLayout:
    """Build the static routing from a ``(steps, batch, nnz)`` int epoch
    tensor of categorical indices (host numpy; once per fit).  Pass
    ``values`` (same shape, float) for the generic sparse layout — slots
    then scatter ``value * r`` instead of ``r``.

    ``pad_ovf_cap`` / ``pad_heavy_cap`` force EXACT capacities; a batch
    exceeding a forced cap raises rather than dropping slots.  Indices
    >= num_features are sentinels and drop out of the layout (padding
    rows).  Returns host numpy arrays; :meth:`EllLayout.to` moves them."""
    _check_heavy_threshold(heavy_threshold)
    steps, batch, nnz = cat_indices.shape
    rows = num_features // _LANES
    lib = _native_ell()
    if lib is not None:
        (n_src, n_pos, n_mask, n_oi, n_os, n_ov, n_hi, n_hc, n_val,
         need_o, need_h) = _ell_layout_native(
            lib, np.asarray(cat_indices), num_features, heavy_threshold,
            values, pad_ovf_cap, pad_heavy_cap)
        return EllLayout(
            src=n_src, pos=n_pos, mask=n_mask, ovf_idx=n_oi, ovf_src=n_os,
            heavy_idx=n_hi, heavy_cnt=n_hc, val=n_val, ovf_val=n_ov,
            batch=batch, num_features=num_features,
            need_ovf=need_o, need_heavy=need_h)
    outs = [_ell_one_step(
        np.asarray(cat_indices[s], np.int64).reshape(-1), batch, nnz, rows,
        heavy_threshold,
        None if values is None
        else np.asarray(values[s], np.float32).reshape(-1))
        for s in range(steps)]
    need_ovf = max(o[3].size for o in outs)
    need_heavy = max(o[5].size for o in outs)
    if pad_ovf_cap is not None and need_ovf > pad_ovf_cap:
        raise ValueError(
            f"overflow needs {need_ovf} slots > forced cap {pad_ovf_cap}; "
            "raise the cap (streaming: ell_ovf_cap)")
    if pad_heavy_cap is not None and need_heavy > pad_heavy_cap:
        raise ValueError(
            f"{need_heavy} heavy indices > forced cap {pad_heavy_cap}; "
            "raise the cap (streaming: ell_heavy_cap)")
    cap = pad_ovf_cap if pad_ovf_cap is not None else max(8, need_ovf)
    cap += (-cap) % 8
    ovf_idx = np.zeros((steps, cap), np.int32)
    ovf_src = np.full((steps, cap), batch, np.int32)
    H = (pad_heavy_cap if pad_heavy_cap is not None
         else max(1, need_heavy))
    heavy_idx = np.zeros((steps, H), np.int32)
    heavy_cnt = np.zeros((steps, H, batch),
                         np.int16 if values is None else np.float32)
    val = ovf_val = None
    if values is not None:
        val = np.zeros((steps, rows, ELL_WIDTH), np.float32)
        ovf_val = np.zeros((steps, cap), np.float32)
    for s, o in enumerate(outs):
        ovf_idx[s, :o[3].size] = o[3]
        ovf_src[s, :o[4].size] = o[4]
        heavy_idx[s, :o[5].size] = o[5]
        heavy_cnt[s, :o[6].shape[0]] = o[6]
        if values is not None:
            val[s] = o[7]
            ovf_val[s, :o[8].size] = o[8]
    return EllLayout(
        src=np.stack([o[0] for o in outs]),
        pos=np.stack([o[1] for o in outs]),
        mask=np.stack([o[2] for o in outs]),
        ovf_idx=ovf_idx, ovf_src=ovf_src,
        heavy_idx=heavy_idx, heavy_cnt=heavy_cnt,
        val=val, ovf_val=ovf_val,
        batch=batch, num_features=num_features,
        need_ovf=np.asarray([o[3].size for o in outs], np.int32),
        need_heavy=np.asarray([o[5].size for o in outs], np.int32))


def ell_layout_device(cat_indices: torch.Tensor, num_features: int,
                      ovf_cap: int = 1 << 16, heavy_cap: int = 8,
                      heavy_threshold: int = HEAVY_THRESHOLD,
                      values: Optional[torch.Tensor] = None) -> EllLayout:
    """Device-side layout builder for callers whose ``(steps, batch,
    nnz)`` epoch tensor already lives on the device: torch ops on its
    device, one stable sort per step, the same layout as
    :func:`ell_layout` within the static capacities.  Slots beyond
    ``ovf_cap`` overflow slots or ``heavy_cap`` heavy indices in a step are
    DROPPED from the layout; ``need_ovf``/``need_heavy`` (host numpy)
    record what each step needed, so callers size the caps generously or
    call :meth:`EllLayout.assert_capacities`, which raises.  With
    ``values`` (same shape, float) the layout carries the value grids and
    ``heavy_cnt`` holds f32 value sums.  Indices must lie in ``[0,
    num_features)``."""
    _check_heavy_threshold(heavy_threshold)
    steps, batch, nnz = cat_indices.shape
    rows = num_features // _LANES
    dev = cat_indices.device
    if cat_indices.numel() and (int(cat_indices.min()) < 0 or
                                int(cat_indices.max()) >= num_features):
        raise ValueError(f"indices must lie in [0, {num_features})")
    flat_all = cat_indices.reshape(steps, -1).long()
    vals_all = (None if values is None
                else values.reshape(steps, -1).to(torch.float32))
    b_of = torch.arange(batch, dtype=torch.int32,
                        device=dev).repeat_interleave(nnz)
    slot = torch.arange(batch * nnz, device=dev)
    row_ids = torch.arange(rows, device=dev)
    out = {k: [] for k in ("src", "pos", "mask", "val", "ovf_idx", "ovf_src",
                           "ovf_val", "heavy_idx", "heavy_cnt", "n_ovf",
                           "n_heavy")}

    def dropped(keep, rank, cap):
        """Destination ``rank`` where ``keep`` and within ``cap``, else the
        dump slot ``cap`` (sliced off)."""
        return torch.where(keep & (rank < cap), rank, cap)

    for s in range(steps):
        sidx, order = torch.sort(flat_all[s], stable=True)
        ssrc = b_of[order]
        svals = None if vals_all is None else vals_all[s][order]
        row = sidx >> 7
        starts = torch.searchsorted(row, row_ids)
        pos = slot - starts[row]
        run_start = torch.searchsorted(sidx, sidx, side="left")
        run_end = torch.searchsorted(sidx, sidx, side="right")
        heavy_slot = (run_end - run_start) > heavy_threshold
        keep = (pos < ELL_WIDTH) & ~heavy_slot
        src = torch.full((rows, ELL_WIDTH), batch, dtype=torch.int32,
                         device=dev)
        src[row[keep], pos[keep]] = ssrc[keep]
        if svals is not None:
            val = torch.zeros((rows, ELL_WIDTH), dtype=torch.float32,
                              device=dev)
            val[row[keep], pos[keep]] = svals[keep]
            out["val"].append(val)
        hist = torch.bincount(sidx[keep], minlength=rows * _LANES).view(
            rows, _LANES)
        P = torch.cumsum(hist, dim=1) - 1
        out["src"].append(src)
        out["mask"].append((P >= 0).to(torch.float32))
        out["pos"].append(P.clamp_min(0).to(torch.int32))

        spill = ~keep & ~heavy_slot
        at = dropped(spill, torch.cumsum(spill, 0) - 1, ovf_cap)
        ovf_i = torch.zeros(ovf_cap + 1, dtype=torch.int32, device=dev)
        ovf_s = torch.full((ovf_cap + 1,), batch, dtype=torch.int32,
                           device=dev)
        ovf_i[at] = torch.where(spill, sidx, 0).to(torch.int32)
        ovf_s[at] = torch.where(spill, ssrc, batch)
        out["ovf_idx"].append(ovf_i[:ovf_cap])
        out["ovf_src"].append(ovf_s[:ovf_cap])
        if svals is not None:
            ovf_v = torch.zeros(ovf_cap + 1, dtype=torch.float32, device=dev)
            ovf_v[at] = torch.where(spill, svals, 0.0)
            out["ovf_val"].append(ovf_v[:ovf_cap])

        # heavy runs, compacted by first occurrence: a slot's rank is the
        # number of heavy runs starting at or before it, less one
        first = heavy_slot & (slot == run_start)
        h_rank = torch.cumsum(first, 0) - 1
        h_i = torch.zeros(heavy_cap + 1, dtype=torch.int32, device=dev)
        h_i[dropped(first, h_rank, heavy_cap)] = torch.where(
            heavy_slot, sidx, 0).to(torch.int32)
        h_c = torch.zeros((heavy_cap + 1, batch), device=dev,
                          dtype=torch.int32 if svals is None
                          else torch.float32)
        h_c.index_put_((dropped(heavy_slot, h_rank, heavy_cap), ssrc.long()),
                       torch.ones_like(ssrc) if svals is None else svals,
                       accumulate=True)
        out["heavy_idx"].append(h_i[:heavy_cap])
        out["heavy_cnt"].append(h_c[:heavy_cap].to(
            torch.int16 if svals is None else torch.float32))
        out["n_ovf"].append(spill.sum())
        out["n_heavy"].append(first.sum())

    stack = {k: torch.stack(v) if v else None for k, v in out.items()}
    return EllLayout(
        src=stack["src"], pos=stack["pos"], mask=stack["mask"],
        ovf_idx=stack["ovf_idx"], ovf_src=stack["ovf_src"],
        heavy_idx=stack["heavy_idx"], heavy_cnt=stack["heavy_cnt"],
        val=stack["val"], ovf_val=stack["ovf_val"], batch=batch,
        num_features=num_features,
        need_ovf=stack["n_ovf"].cpu().numpy().astype(np.int32),
        need_heavy=stack["n_heavy"].cpu().numpy().astype(np.int32))


def gather_weights(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``w[idx]``.  The JAX package's lane-blocked gather was a TPU
    lowering trick (whole 128-lane rows per DMA); on the card a plain
    index is the gather."""
    return w[idx]


def sample_routing(src: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
                   batch: int, val: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layout's in-grid slots regrouped by sample, for the margin:
    ``(route_w, route_val)``, each ``(steps, nnz, batch)``.

    ``route_w[i, t, b]`` is the weight index ``row * 128 + lane`` of
    sample ``b``'s ``t``-th in-grid slot in step ``i``, the slots taken in
    ascending grid position ``row * 128 + s``; ``-1`` after the sample's
    last slot.  ``route_val`` holds the same slots' ``val`` (0 after the
    last), or is None without ``val``.  ``nnz`` is the most in-grid slots
    any sample of any step has.  A slot is in-grid when it lies at or
    before its row's last kept slot and charges a sample ``< batch``.

    Built from ``src``/``pos``/``mask`` (``(steps, rows, 128)`` or one
    step's ``(rows, 128)``, which gives ``(nnz, batch)``) with torch ops
    only: one stable sort of the kept slots by (step, sample), on the
    tensors' device, once per fit."""
    one_step = src.dim() == 2
    if one_step:
        src, pos, mask = src[None], pos[None], mask[None]
        val = None if val is None else val[None]
    steps, rows, width = src.shape
    if width != ELL_WIDTH:
        raise ValueError(f"layout rows must be {ELL_WIDTH} wide, got {width}")
    dev = src.device
    lanes, pos_eff = _slot_lanes(pos.reshape(-1, ELL_WIDTH),
                                 mask.reshape(-1, ELL_WIDTH))
    s = torch.arange(ELL_WIDTH, dtype=torch.int32, device=dev)
    flat_src = src.reshape(-1, ELL_WIDTH)
    take = ((s[None, :] <= pos_eff[:, -1:]) & (flat_src >= 0)
            & (flat_src < batch))
    slot = torch.nonzero(take.reshape(-1)).squeeze(1)     # grid order
    grid = rows * ELL_WIDTH
    step = torch.div(slot, grid, rounding_mode="floor")
    widx = (slot % grid - slot % ELL_WIDTH
            + lanes.reshape(-1)[slot]).to(torch.int32)
    key = step * batch + flat_src.reshape(-1)[slot].long()
    key, order = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=steps * batch)
    nnz = int(counts.max()) if key.numel() else 0
    rank = (torch.arange(key.numel(), device=dev)
            - (torch.cumsum(counts, 0) - counts)[key])
    at = (torch.div(key, batch, rounding_mode="floor"), rank, key % batch)
    route_w = torch.full((steps, nnz, batch), -1, dtype=torch.int32,
                         device=dev)
    route_w[at] = widx[order]
    route_val = None
    if val is not None:
        route_val = torch.zeros((steps, nnz, batch), dtype=torch.float32,
                                device=dev)
        route_val[at] = val.reshape(-1)[slot][order]
    if one_step:
        return route_w[0], None if route_val is None else route_val[0]
    return route_w, route_val


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the oracle on the card)
# ---------------------------------------------------------------------------

def _slot_lanes(pos: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lanes, pos_eff)``: ``lane(s) = #{l : pos_eff[l] < s}`` per slot,
    clamped to 127; ``pos_eff = pos + mask - 1`` is nondecreasing along
    each row, and ``pos_eff[:, -1]`` is the row's last kept slot."""
    pos_eff = pos + mask.to(torch.int32) - 1
    s = torch.arange(ELL_WIDTH, dtype=torch.int32, device=pos.device)
    lanes = torch.searchsorted(
        pos_eff, s.expand(pos.shape[0], ELL_WIDTH).contiguous())
    return lanes.clamp_max(ELL_WIDTH - 1), pos_eff


def ell_margin_plain(w: torch.Tensor, route_w: torch.Tensor, m_len: int,
                     route_val: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """In-grid margin contributions per sample over one step's routing
    ``route_w (nnz, batch)`` (:func:`sample_routing`), as an ``(m_len,)``
    table whose entries ``[batch:]`` are 0 (callers slice ``[:batch]``).
    ``w[route_w]`` (an entry outside ``[0, w.numel())``, such as the
    ``-1`` after a sample's last slot, read as 0), times ``route_val``, summed left to
    right over the ``nnz`` columns from 0.0, one rounded add each: the
    kernel's order, so the two agree bit for bit.  The JAX twin
    ``ell_margin_xla`` scatter-adds the same slots in grid order, as this
    sum does."""
    nnz, batch = route_w.shape
    inside = (route_w >= 0) & (route_w < w.numel())
    g = torch.where(inside, w[torch.where(inside, route_w, 0).long()], 0.0)
    if route_val is not None:
        g = g * route_val
    acc = torch.zeros(batch, dtype=torch.float32, device=w.device)
    for t in range(nnz):
        acc = acc + g[t]
    out = torch.zeros(m_len, dtype=torch.float32, device=w.device)
    out[:batch] = acc
    return out


def _csum_pick_tail(x: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """Inclusive lane cumsum by 7 shifted adds (the kernel's order), pick
    at ``pos``, mask, boundary difference, add to ``w``."""
    for k in (1, 2, 4, 8, 16, 32, 64):
        x = x + F.pad(x[:, :-k], (k, 0))
    G = torch.gather(x, 1, pos.long()) * mask
    Gs = F.pad(G[:, :-1], (1, 0))
    return (w2 + G - Gs).reshape(-1)


def ell_scatter_apply_fused_plain(w: torch.Tensor, r_ext: torch.Tensor,
                                  src: torch.Tensor, pos: torch.Tensor,
                                  mask: torch.Tensor, *, lr: float,
                                  val: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """``w + scatter(-lr * val * r_ext[src])`` — the same arithmetic in the
    same order as the kernel, so the two agree bit for bit."""
    u = ((-lr) * r_ext)[src.long()]
    if val is not None:
        u = u * val
    return _csum_pick_tail(u, pos, mask, w.view(src.shape[0], _LANES))


def ell_scatter_apply_plain(w: torch.Tensor, upd: torch.Tensor,
                            pos: torch.Tensor, mask: torch.Tensor
                            ) -> torch.Tensor:
    """``w + scatter(upd)`` for per-slot updates ``upd (rows, 128)`` in ELL
    order."""
    return _csum_pick_tail(upd, pos, mask, w.view(upd.shape[0], _LANES))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_LIB = None


def _kernels():
    """The built ``ell_scatter`` library with its C signatures declared
    (built on first use)."""
    global _LIB
    if _LIB is None:
        from ..kernels.build import load_library

        lib = load_library("ell_scatter")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ell_margin_launch.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci,
                                          vp]
        lib.ell_scatter_fused_launch.argtypes = [vp, vp, ci, vp, vp, vp, vp,
                                                 cf, vp, ci, vp]
        lib.ell_scatter_pair_launch.argtypes = [vp, vp, vp, vp, vp, ci, vp]
        for fn in (lib.ell_margin_launch, lib.ell_scatter_fused_launch,
                   lib.ell_scatter_pair_launch):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(name: str, t: Optional[torch.Tensor], dtype: torch.dtype,
           shape: tuple, device: torch.device) -> None:
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_grid(w, src_like, pos, mask, val) -> int:
    rows = src_like.shape[0]
    dev = w.device
    _check("w", w, torch.float32, (rows * _LANES,), dev)
    _check("pos", pos, torch.int32, (rows, ELL_WIDTH), dev)
    _check("mask", mask, torch.float32, (rows, ELL_WIDTH), dev)
    _check("val", val, torch.float32, (rows, ELL_WIDTH), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return rows


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, name)


def _check_margin(w, route_w, m_len, route_val) -> None:
    dev = w.device
    if route_w.dim() != 2:
        raise ValueError(f"route_w must be (nnz, batch), got shape "
                         f"{tuple(route_w.shape)}")
    nnz, batch = route_w.shape
    _check("w", w, torch.float32, (w.numel(),), dev)
    _check("route_w", route_w, torch.int32, (nnz, batch), dev)
    _check("route_val", route_val, torch.float32, (nnz, batch), dev)
    if m_len < batch:
        raise ValueError(f"m_len {m_len} < batch {batch}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _on_card(name: str, w: torch.Tensor) -> None:
    if w.device.type != "cuda":
        raise ValueError(f"the {name} kernel takes CUDA tensors, got "
                         f"{w.device}")


def _ell_margin_cuda(w: torch.Tensor, route_w: torch.Tensor, *, m_len: int,
                     route_val: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Op ``ell_margin``, backend ``"cuda"``: one launch of the margin
    kernel."""
    _on_card("ell_margin", w)
    nnz, batch = route_w.shape
    out = torch.empty(m_len, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        rc = _kernels().ell_margin_launch(
            _ptr(w), w.numel(), _ptr(route_w), _ptr(route_val), _ptr(out),
            nnz, batch, m_len, torch.cuda.current_stream().cuda_stream)
    _launched("ell_margin", rc)
    return out


def ell_margin(w: torch.Tensor, route_w: torch.Tensor, *, m_len: int,
               route_val: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample margin contributions of the in-grid slots over one
    step's routing ``route_w (nnz, batch)`` (:func:`sample_routing`), as an
    ``(m_len,)`` f32 table whose entries ``[batch:]`` are 0 (callers slice
    ``[:batch]``).  Replaces the JAX package's ``ell_margin_fused``.  Sums
    each sample in a fixed order: deterministic, and bit for bit its plain
    version.  A route entry outside ``[0, w.numel())`` reads 0 there too:
    the kernel bounds every gather by ``w``'s size."""
    _check_margin(w, route_w, m_len, route_val)
    entry = lookup("ell_margin", sig=(w.numel() // _LANES, w.device.type))
    return entry.fn(w, route_w, m_len=m_len, route_val=route_val)


def _ell_scatter_fused_cuda(w: torch.Tensor, r_ext: torch.Tensor,
                            src: torch.Tensor, pos: torch.Tensor,
                            mask: torch.Tensor, *, lr: float,
                            val: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Op ``ell_scatter_apply``, backend ``"cuda"``: one launch of the
    fused gather + scatter kernel."""
    _on_card("ell_scatter_apply_fused", w)
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        rc = _kernels().ell_scatter_fused_launch(
            _ptr(w), _ptr(r_ext), r_ext.shape[0], _ptr(src), _ptr(pos),
            _ptr(mask), _ptr(val), float(lr), _ptr(out), src.shape[0],
            torch.cuda.current_stream().cuda_stream)
    _launched("ell_scatter_apply_fused", rc)
    return out


def _ell_scatter_pair_cuda(w: torch.Tensor, upd: torch.Tensor,
                           pos: torch.Tensor, mask: torch.Tensor
                           ) -> torch.Tensor:
    """One launch of the pair scatter kernel."""
    _on_card("ell_scatter_apply", w)
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        rc = _kernels().ell_scatter_pair_launch(
            _ptr(w), _ptr(upd), _ptr(pos), _ptr(mask), _ptr(out),
            upd.shape[0], torch.cuda.current_stream().cuda_stream)
    _launched("ell_scatter_apply", rc)
    return out


def _pair_update(r_ext, src, lr, val):
    """The pair path's per-slot updates ``-lr * val * r_ext[src]``."""
    g = gather_weights(r_ext, src)
    return (-lr) * (g if val is None else val * g)


def _ell_scatter_pair_entry(w, r_ext, src, pos, mask, *, lr, val=None):
    """Op ``ell_scatter_apply``, backend ``"cuda-pair"``: the slot gather,
    then one launch of the pair kernel (any grid)."""
    return _ell_scatter_pair_cuda(w, _pair_update(r_ext, src, lr, val),
                                  pos, mask)


def ell_scatter_apply_plain_entry(w, r_ext, src, pos, mask, *, lr,
                                  val=None):
    """Op ``ell_scatter_apply``, backend ``"plain"``: the plain version of
    the kernel the grid plans, the fused one on grids of whole
    :data:`FUSED_BLOCK_ROWS`-row blocks, else the gather + pair one."""
    if src.shape[0] % FUSED_BLOCK_ROWS == 0:
        return ell_scatter_apply_fused_plain(w, r_ext, src, pos, mask,
                                             lr=lr, val=val)
    return ell_scatter_apply_plain(w, _pair_update(r_ext, src, lr, val),
                                   pos, mask)


def ell_scatter_apply_fused(w: torch.Tensor, r_ext: torch.Tensor,
                            src: torch.Tensor, pos: torch.Tensor,
                            mask: torch.Tensor, *, lr: float,
                            val: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``w + scatter(-lr * val * r_ext[src])`` with the gather fused into the
    kernel; returns a new tensor (``w`` is not changed).  Replaces the JAX
    package's ``ell_scatter_apply_fused``; the gather is exact f32, so the
    JAX ``precision`` knob has no counterpart.  Deterministic."""
    rows = _check_grid(w, src, pos, mask, val)
    _check("src", src, torch.int32, (rows, ELL_WIDTH), w.device)
    _check("r_ext", r_ext, torch.float32, (r_ext.shape[0],), w.device)
    fn = kernel_or_plain("ell_scatter_apply", (rows, w.device.type),
                         _ell_scatter_fused_cuda,
                         ell_scatter_apply_fused_plain)
    return fn(w, r_ext, src, pos, mask, lr=lr, val=val)


def ell_scatter_apply(w: torch.Tensor, upd: torch.Tensor,
                      pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``w + scatter(upd)`` for per-slot updates ``upd (rows, 128)`` in ELL
    order; returns a new tensor.  Replaces the JAX package's
    ``ell_scatter_apply`` (the pair path).  Deterministic."""
    rows = _check_grid(w, upd, pos, mask, None)
    _check("upd", upd, torch.float32, (rows, ELL_WIDTH), w.device)
    fn = kernel_or_plain("ell_scatter_apply", (rows, w.device.type),
                         _ell_scatter_pair_cuda, ell_scatter_apply_plain)
    return fn(w, upd, pos, mask)


def _fused_blockable(sig: tuple) -> bool:
    """The fused kernel's grid contract at ``sig = (table_rows, device)``:
    CUDA tensors, rows in whole :data:`FUSED_BLOCK_ROWS`-row blocks (the
    JAX package's rule, so both packages plan the same kernel)."""
    return on_cuda(sig) and sig[0] % FUSED_BLOCK_ROWS == 0


def _register_ell_kernels() -> None:
    register_kernel("ell_margin", "cuda", _ell_margin_cuda, priority=20,
                    supports=on_cuda, available=cuda_only)
    register_kernel("ell_margin", "plain", ell_margin_plain)
    register_kernel("ell_scatter_apply", "cuda", _ell_scatter_fused_cuda,
                    priority=30, supports=_fused_blockable,
                    available=cuda_only)
    register_kernel("ell_scatter_apply", "cuda-pair",
                    _ell_scatter_pair_entry, priority=20, supports=on_cuda,
                    available=cuda_only)
    register_kernel("ell_scatter_apply", "plain",
                    ell_scatter_apply_plain_entry)


_register_ell_kernels()
