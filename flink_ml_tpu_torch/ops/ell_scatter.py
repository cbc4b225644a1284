"""ELL static routing for the mixed-layout linear trainers: the host layout
build, and the three ELL kernels with their plain PyTorch versions.

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

The three kernels (CUDA C++ for Hopper, ``kernels/csrc/ell_scatter.cu``;
its header note says what bounds each on the H100 and how each is built):

- :func:`ell_margin` — per-sample margin of the in-grid slots;
- :func:`ell_scatter_apply_fused` — ``w + scatter(-lr * val * r_ext[src])``;
- :func:`ell_scatter_apply` — the same scatter of a precomputed ``upd``
  (the pair path, for grids whose row count is not a multiple of 8).

Each wrapper takes its plain PyTorch version (``*_plain``) for tensors on
the CPU, and launches its kernel for CUDA tensors or raises: it never falls
back.  A launch adds one to :data:`LAUNCHES`.

A port of the JAX package's ``ops/ell_scatter.py`` (host layout, kernels
and their XLA twins).  ``ell_layout_device`` is not ported yet.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["EllLayout", "ell_layout", "supported", "ELL_WIDTH",
           "HEAVY_THRESHOLD", "ell_margin", "ell_margin_plain",
           "ell_scatter_apply_fused", "ell_scatter_apply_fused_plain",
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
            f"{pad_ovf_cap}; raise the cap")
    if pad_heavy_cap is not None and need_heavy > pad_heavy_cap:
        raise ValueError(
            f"{need_heavy} heavy indices > forced cap "
            f"{pad_heavy_cap}; raise the cap")
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
            "raise the cap")
    if pad_heavy_cap is not None and need_heavy > pad_heavy_cap:
        raise ValueError(
            f"{need_heavy} heavy indices > forced cap {pad_heavy_cap}; "
            "raise the cap")
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


def gather_weights(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``w[idx]``.  The JAX package's lane-blocked gather was a TPU
    lowering trick (whole 128-lane rows per DMA); on the card a plain
    index is the gather."""
    return w[idx]


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


def ell_margin_plain(w: torch.Tensor, src: torch.Tensor, pos: torch.Tensor,
                     mask: torch.Tensor, m_len: int,
                     val: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-grid margin contributions scattered to an ``(m_len,)`` extended
    per-sample table (callers slice ``[:batch]``).  Slots past a row's
    last kept slot are pad slots and add nothing, as in the kernel; so
    only the pad entries of the table differ from the JAX twin
    ``ell_margin_xla``, which adds them at ``src == batch``."""
    rows = src.shape[0]
    lanes, pos_eff = _slot_lanes(pos, mask)
    g = torch.gather(w.view(rows, _LANES), 1, lanes)
    if val is not None:
        g = g * val
    s = torch.arange(ELL_WIDTH, dtype=torch.int32, device=src.device)
    take = (s[None, :] <= pos_eff[:, -1:]) & (src < m_len) & (src >= 0)
    return torch.zeros(m_len, dtype=torch.float32,
                       device=w.device).index_add_(
        0, src[take].long(), g[take])


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
        lib.ell_margin_launch.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, vp]
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
    LAUNCHES[name] += 1


def ell_margin(w: torch.Tensor, src: torch.Tensor, pos: torch.Tensor,
               mask: torch.Tensor, *, m_len: int,
               val: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample margin contributions of the in-grid slots, as an
    ``(m_len,)`` f32 table (callers slice ``[:batch]``).  Replaces the JAX
    package's ``ell_margin_fused``.  The kernel sums with atomics, so its
    result varies from run to run in f32 rounding."""
    rows = _check_grid(w, src, pos, mask, val)
    _check("src", src, torch.int32, (rows, ELL_WIDTH), w.device)
    if w.device.type == "cpu":
        return ell_margin_plain(w, src, pos, mask, m_len, val=val)
    out = torch.zeros(m_len, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        rc = _kernels().ell_margin_launch(
            _ptr(w), _ptr(src), _ptr(pos), _ptr(mask), _ptr(val), _ptr(out),
            rows, m_len, torch.cuda.current_stream().cuda_stream)
    _launched("ell_margin", rc)
    return out


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
    if w.device.type == "cpu":
        return ell_scatter_apply_fused_plain(w, r_ext, src, pos, mask,
                                             lr=lr, val=val)
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        rc = _kernels().ell_scatter_fused_launch(
            _ptr(w), _ptr(r_ext), r_ext.shape[0], _ptr(src), _ptr(pos),
            _ptr(mask), _ptr(val), float(lr), _ptr(out), rows,
            torch.cuda.current_stream().cuda_stream)
    _launched("ell_scatter_apply_fused", rc)
    return out


def ell_scatter_apply(w: torch.Tensor, upd: torch.Tensor,
                      pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``w + scatter(upd)`` for per-slot updates ``upd (rows, 128)`` in ELL
    order; returns a new tensor.  Replaces the JAX package's
    ``ell_scatter_apply`` (the pair path).  Deterministic."""
    rows = _check_grid(w, upd, pos, mask, None)
    _check("upd", upd, torch.float32, (rows, ELL_WIDTH), w.device)
    if w.device.type == "cpu":
        return ell_scatter_apply_plain(w, upd, pos, mask)
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        rc = _kernels().ell_scatter_pair_launch(
            _ptr(w), _ptr(upd), _ptr(pos), _ptr(mask), _ptr(out), rows,
            torch.cuda.current_stream().cuda_stream)
    _launched("ell_scatter_apply", rc)
    return out
