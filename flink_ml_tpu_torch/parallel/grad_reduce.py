"""Configurable gradient reduction: exact / sparse / quantized / hierarchical.

A port of the JAX package's ``parallel/grad_reduce.py``: the data-parallel
gradient sum as an explicit, configurable operator, so the bytes a
participant puts on the wire are a measured quantity (the SparCML and
SwitchML posture, arXiv:1802.08021, arXiv:1903.06701).

- ``mode="exact"``: the plain sum.  Here it is :func:`~.collectives.
  psum_ordered` (every rank's gradient gathered and added in rank order),
  so a reduce cut into buckets gives the bits of the uncut one.
- ``mode="topk"``: top-|g| sparsification at ``density`` with **error
  feedback**: what a rank did not send this step is carried in reducer
  state (``ef``) and added to its next gradient.  The selection is the
  first k of a stable descending sort of ``|g|`` (ties go to the lower
  index, as ``lax.top_k`` sends them).  The sparse transport is recursive
  halving/doubling (``wire_protocol="rd"``, measured fill-in) or the
  all-gather form.
- ``mode="int8"``: block-quantized reduce with per-``block_size`` max-abs
  scales and stochastic rounding, dequantized then summed
  (``int8_accum="dequant"``) or summed as int32 against one shared scale
  (``"fixed"``).  The rounding draws come from :func:`draw_uniform`, a
  counter-based stream per rank: ``state["key"]`` is ``(seed, rank,
  step)`` and advances once a reduce, so the stream rides checkpoints as
  three integers, repeats from run to run and is the same on the CPU and
  on the card.  (The JAX package draws threefry bits; a test that needs
  its codes feeds its draws in place of :func:`draw_uniform`.)
- hierarchical (``dcn_axis`` set): an exact reduce-scatter over the fast
  axis, the compressed all-reduce over ``dcn_axis`` on the shard, then an
  all-gather over the fast axis (:func:`~.distributed.hybrid_mesh`).
- ``bucket_count``, ``overlap``, ``adaptive``, ``wire_protocol``,
  ``int8_accum`` and ``dcn_schedule`` as in the JAX package.

Each rank calls :func:`reduce_gradients` on its own gradients and its
own state: the port keeps each rank's state, with no leading participant
dim (the JAX package stacks the participants' states and shards that dim
over the mesh; its ``squeeze_state``/``unsqueeze_state`` are artefacts of
``shard_map`` with no counterpart here, and ``utils/convert.py``
``grad_reduce_state_from_jax`` takes rank r's slice of a stacked state).
Every rank must make the same calls in the same order (they run
collectives).  ``reshard_state`` (elastic fleets) is ROADMAP A10.2.

Host reads.  The adaptive policy picks each bucket's rung on the host (a
rung launches its own collectives): :class:`RungReader` reads the
all-reduced rung indices once every ``adaptive_window`` steps (after the
step whose tick crossed the window), and every rank reads the same bits.
The rd protocol reads one scalar a transport unit: its switchover flag
after the union count's all-reduce (:func:`~.collectives.
sparse_all_reduce_rd`).  Nothing else in a reduce reads the device.

Overlap.  :func:`start_pipelined` reduces the carried ``pending``
gradient (the previous step's) on a worker thread over the mesh's lane
(groups of its own, so its collectives never interleave with the
caller's), while the caller computes this step's gradient;
:meth:`PendingReduce.finish` waits and stores the new gradient as
pending.  :func:`drain_pending` all-reduces ``pending + ef`` exactly at
fit end.

``dcn_schedule``: a process group runs collectives in the order they are
issued, and the buckets are issued in index order, the order the apply
consumes them; so ``"earliest"`` and ``"free"`` give the same bits and
the same issue order here.  The field and its validation are kept.
"""

from __future__ import annotations

import math

from dataclasses import dataclass
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from . import collectives as C
from .collectives import (
    FILL_DOUBLING_BASE,
    FILL_POSTFOLD_SLOT,
    FILL_PREFOLD_SLOT,
    FILL_SWITCH_SLOT,
    FILL_UNION_SLOT,
    FILL_VEC_LEN,
    rd_topology,
)
from .mesh import Mesh, default_mesh

__all__ = [
    "BucketPlan",
    "GradReduceConfig",
    "MODES",
    "PendingReduce",
    "RungReader",
    "bucket_report",
    "draw_uniform",
    "drain_pending",
    "effective_ladder",
    "hop_axis",
    "init_state",
    "mesh_layout",
    "needs_state",
    "payload_bytes",
    "pipelined_reduce",
    "plan_buckets",
    "reduce_gradients",
    "reduction_axes",
    "resolved_wire_protocol",
    "start_pipelined",
    "state_participants",
    "wants_overlap",
]

MODES = ("exact", "topk", "int8")
WIRE_PROTOCOLS = ("auto", "rd", "allgather")
INT8_ACCUMS = ("dequant", "fixed")
DCN_SCHEDULES = ("earliest", "free")

AxisSpec = Union[str, Tuple[str, ...]]


@dataclass(frozen=True)
class GradReduceConfig:
    """How data-parallel gradients are summed across the mesh.

    ``axis`` is the (fast) reduction axis; ``dcn_axis``, when set,
    selects the hierarchical composition: exact reduce-scatter over
    ``axis``, the configured compression over ``dcn_axis`` only, gather
    back.  With ``dcn_axis=None`` the compression applies to the whole
    flat reduce over ``axis``.

    ``density`` (topk) is the fraction of each unit's elements sent per
    step (``k = max(1, floor(density * n))``).  ``block_size`` (int8) is
    the elements-per-scale quantization granule; ``seed`` seeds the
    stochastic rounding stream.

    ``bucket_count=B`` cuts the flat gradient into B size-balanced
    buckets, each reduced by its own collectives (0 keeps the per-leaf
    reduce).  ``overlap=True`` asks adopters for the one-step-stale
    pipelined apply (ignored in ``exact`` mode).  ``adaptive=True`` (topk
    only) re-selects each leaf's rung of ``density_ladder`` (a density in
    (0, 1], or ``"int8"`` / ``"exact"``) every ``adaptive_window`` steps
    from the carried residual/gradient norm ratio: above
    ``adaptive_target`` the leaf climbs one rung toward fidelity, below
    half the target it descends one rung.  An empty ladder defaults to
    ``(density / 4, density, "exact")``.

    ``wire_protocol``: ``"auto"`` (recursive halving/doubling on a hop of
    one named axis, all-gather otherwise), ``"rd"`` or ``"allgather"``.
    ``int8_accum``: ``"dequant"`` or ``"fixed"``.  ``dcn_schedule``:
    ``"earliest"`` (default) or ``"free"``.
    """

    mode: str = "exact"
    density: float = 0.1
    block_size: int = 256
    axis: AxisSpec = "data"
    dcn_axis: Optional[str] = None
    seed: int = 0
    bucket_count: int = 0
    overlap: bool = False
    adaptive: bool = False
    adaptive_window: int = 8
    adaptive_target: float = 0.5
    density_ladder: Tuple = ()
    wire_protocol: str = "auto"
    int8_accum: str = "dequant"
    dcn_schedule: str = "earliest"

    def __post_init__(self):
        if self.wire_protocol not in WIRE_PROTOCOLS:
            raise ValueError(f"wire_protocol must be one of "
                             f"{WIRE_PROTOCOLS}, got {self.wire_protocol!r}")
        if self.int8_accum not in INT8_ACCUMS:
            raise ValueError(f"int8_accum must be one of {INT8_ACCUMS}, "
                             f"got {self.int8_accum!r}")
        if self.dcn_schedule not in DCN_SCHEDULES:
            raise ValueError(f"dcn_schedule must be one of "
                             f"{DCN_SCHEDULES}, got {self.dcn_schedule!r}")
        single_hop = self.dcn_axis is not None or \
            isinstance(self.axis, str) or len(tuple(self.axis)) == 1
        if self.wire_protocol == "rd" and not single_hop:
            raise ValueError(
                "wire_protocol='rd' runs pairwise ppermute rounds over ONE "
                "named axis; this config's compressed hop spans "
                f"axis={self.axis!r} — set a dcn_axis or use 'allgather'")
        if self.int8_accum == "fixed" and not single_hop:
            raise ValueError(
                "int8_accum='fixed' accumulates int32 over ONE named axis; "
                f"this config's hop spans axis={self.axis!r}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.mode == "topk" and not 0.0 < self.density <= 1.0:
            raise ValueError(f"density must be in (0, 1], got {self.density}")
        if self.mode == "int8" and self.block_size <= 0:
            raise ValueError(
                f"block_size must be positive, got {self.block_size}")
        if self.dcn_axis is not None and not isinstance(self.axis, str):
            raise ValueError(
                "hierarchical reduction needs a single ICI axis name; got "
                f"axis={self.axis!r}")
        if self.bucket_count < 0:
            raise ValueError(
                f"bucket_count must be >= 0, got {self.bucket_count}")
        if self.adaptive:
            if self.mode != "topk":
                raise ValueError(
                    "adaptive density is a topk-family policy (the ladder "
                    "may contain int8/exact fallback rungs); set "
                    f"mode='topk', got mode={self.mode!r}")
            if self.adaptive_window < 1:
                raise ValueError("adaptive_window must be >= 1, got "
                                 f"{self.adaptive_window}")
            if self.adaptive_target <= 0:
                raise ValueError("adaptive_target must be positive, got "
                                 f"{self.adaptive_target}")
            for spec in self.density_ladder:
                if isinstance(spec, str):
                    if spec not in ("exact", "int8"):
                        raise ValueError(
                            "ladder rungs are densities in (0, 1] or "
                            f"'exact'/'int8', got {spec!r}")
                elif not 0.0 < float(spec) <= 1.0:
                    raise ValueError(
                        f"ladder density {spec!r} not in (0, 1]")
        elif self.density_ladder:
            raise ValueError("density_ladder requires adaptive=True")


def effective_ladder(config: GradReduceConfig) -> Tuple:
    """The adaptive rung ladder, ordered cheapest -> highest fidelity."""
    if config.density_ladder:
        return tuple(config.density_ladder)
    return (max(config.density / 4.0, 1e-4), config.density, "exact")


def _initial_rung(config: GradReduceConfig) -> int:
    """Every leaf starts at the configured density's rung (the middle of
    the default ladder)."""
    lad = effective_ladder(config)
    for i, spec in enumerate(lad):
        if not isinstance(spec, str) and float(spec) == config.density:
            return i
    return len(lad) // 2


def wants_overlap(config: Optional[GradReduceConfig]) -> bool:
    """True when adopters should run the one-step-stale pipelined apply
    (never in ``exact`` mode)."""
    return (config is not None and config.overlap
            and config.mode != "exact")


def _carries_ef(config: GradReduceConfig) -> bool:
    return config.mode == "topk" or config.adaptive


def _bucketed(config: GradReduceConfig) -> bool:
    return config.bucket_count > 0 or config.adaptive


def reduction_axes(config: GradReduceConfig) -> Tuple[str, ...]:
    """Every mesh axis the reduction sums over (the fast axes + the dcn
    axis)."""
    axes = (config.axis,) if isinstance(config.axis, str) else tuple(
        config.axis)
    if config.dcn_axis is not None:
        axes = (config.dcn_axis,) + axes
    return axes


def hop_axis(config: GradReduceConfig) -> Optional[str]:
    """The single named axis the compressed hop runs over, or ``None``
    when the flat hop spans several axes."""
    if config.dcn_axis is not None:
        return config.dcn_axis
    if isinstance(config.axis, str):
        return config.axis
    axes = tuple(config.axis)
    return axes[0] if len(axes) == 1 else None


def resolved_wire_protocol(config: GradReduceConfig) -> str:
    """The sparse transport the top-k family runs: ``"auto"`` resolves to
    ``"rd"`` whenever :func:`hop_axis` names one axis, else to
    ``"allgather"``."""
    if config.wire_protocol == "allgather":
        return "allgather"
    return "rd" if hop_axis(config) is not None else "allgather"


def _rd_engaged(config: GradReduceConfig) -> bool:
    return (config.mode == "topk" or config.adaptive) and \
        resolved_wire_protocol(config) == "rd"


def needs_state(config: GradReduceConfig) -> bool:
    return config.mode in ("topk", "int8")


def mesh_layout(config: GradReduceConfig, mesh) -> Tuple[Tuple[str, ...],
                                                         int, Any]:
    """(reduction axes, participant count, batch axis entry) for running
    this config on ``mesh``; axes the mesh lacks raise."""
    axes = reduction_axes(config)
    missing = [a for a in axes if a not in mesh.shape]
    if missing:
        raise ValueError(
            f"grad_reduce axes {missing} not in mesh {list(mesh.shape)}; "
            "build the mesh with the reduction axes (e.g. "
            "distributed.hybrid_mesh for a dcn axis)")
    n_participants = int(np.prod([mesh.shape[a] for a in axes]))
    return axes, n_participants, (axes if len(axes) > 1 else axes[0])


def _topk_k(n: int, density: float) -> int:
    return max(1, int(n * density))


# ---------------------------------------------------------------------------
# trees (the JAX package's leaf order: dict keys sorted)
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(like, leaves: list):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(np.shape(x))


def _device_of(tree) -> torch.device:
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


def init_state(config: GradReduceConfig, grads_like: Any,
               mesh: Optional[Mesh] = None) -> dict:
    """This rank's reducer state: its slice of the JAX package's
    participant-stacked ``init_state`` (the participant is this rank's
    position over the reduction axes of ``mesh``, default the default
    mesh), on the device of ``grads_like``'s first tensor leaf (the CPU
    for numpy leaves).

    ``topk`` carries the error-feedback residual ``ef`` (zeros like every
    gradient leaf); ``int8`` (or an int8 rung) the rounding stream
    ``key`` = ``(seed, rank, 0)`` (int64); ``adaptive`` adds the per-leaf
    ratio EMA ``ema``, the rungs ``rung`` (int32) and the step ``tick``
    (int32); the rd wire protocol adds ``fill`` (the last step's per-unit
    fill-in vectors) and ``union`` (their smoothed union density);
    ``overlap`` adds ``pending``, the zeros-initialized one-step-stale
    gradient.  ``exact`` needs no state (``{}``)."""
    dev = _device_of(grads_like)

    def zeros(g):
        return torch.zeros(_shape(g), dtype=torch.float32, device=dev)

    def zeros_tree(t):
        if isinstance(t, dict):
            return {k: zeros_tree(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(zeros_tree(v) for v in t)
        return zeros(t)

    state: dict = {}
    lad = effective_ladder(config) if config.adaptive else ()
    if _carries_ef(config):
        state["ef"] = zeros_tree(grads_like)
    if config.mode == "int8" or "int8" in lad:
        rank = C.axis_index(reduction_axes(config), mesh=mesh)
        state["key"] = torch.tensor([config.seed, rank, 0],
                                    dtype=torch.int64, device=dev)
    if config.adaptive:
        n_leaves = len(_leaves(grads_like))
        state["ema"] = torch.zeros(n_leaves, dtype=torch.float32, device=dev)
        state["rung"] = torch.full((n_leaves,), _initial_rung(config),
                                   dtype=torch.int32, device=dev)
        state["tick"] = torch.zeros((), dtype=torch.int32, device=dev)
    if _rd_engaged(config):
        n_units = _fill_units(grads_like, config)
        state["fill"] = torch.zeros((n_units, FILL_VEC_LEN),
                                    dtype=torch.float32, device=dev)
        state["union"] = torch.zeros(n_units, dtype=torch.float32,
                                     device=dev)
    if wants_overlap(config):
        state["pending"] = zeros_tree(grads_like)
    return state


def _fill_units(grads_like: Any, config: GradReduceConfig) -> int:
    """Transport units the fill accounting is keyed on: buckets when the
    reduce is bucketed/adaptive, leaves otherwise."""
    if _bucketed(config):
        return len(plan_buckets(grads_like, config).ranges)
    return len(_leaves(grads_like))


def state_participants(state: Optional[dict]) -> Optional[int]:
    """The participant count of a participant-stacked reducer state (the
    JAX package's layout, which ``utils/convert.py`` reads: the leading
    dim every leaf shares), or ``None`` for an empty or absent state."""
    leaves = _leaves(state or {})
    if not leaves:
        return None
    return int(_shape(leaves[0])[0])


# ---------------------------------------------------------------------------
# bucket planning (host side, static)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BucketPlan:
    """Static transport plan: the flat concatenation of all gradient
    leaves cut into size-balanced contiguous ranges.  ``bucket_leaves``
    maps each bucket to the leaf indices it overlaps (its adaptive rung is
    the highest rung of its leaves)."""

    ranges: Tuple[Tuple[int, int], ...]
    leaf_offsets: Tuple[int, ...]
    leaf_sizes: Tuple[int, ...]
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    bucket_leaves: Tuple[Tuple[int, ...], ...]

    @property
    def total(self) -> int:
        return self.leaf_offsets[-1]

    @property
    def bucket_sizes(self) -> Tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.ranges)


def plan_buckets(grads_like: Any, config: GradReduceConfig) -> BucketPlan:
    """Cut the flat gradient into ``config.bucket_count`` equal ranges
    (cut points ``round(i * total / B)``; leaf boundaries are not
    respected).  ``bucket_count=0`` (the adaptive-only case) gives one
    bucket per leaf."""
    shapes = [_shape(g) for g in _leaves(grads_like)]
    sizes = [int(np.prod(s, dtype=np.int64)) if s else 1 for s in shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    total = int(offsets[-1])
    B = int(config.bucket_count)
    if B <= 0:
        ranges = [(int(offsets[i]), int(offsets[i + 1]))
                  for i in range(len(sizes))]
    else:
        B = max(1, min(B, total))
        cuts = [int(round(i * total / B)) for i in range(B + 1)]
        ranges = [(cuts[i], cuts[i + 1]) for i in range(B)
                  if cuts[i + 1] > cuts[i]]
    bucket_leaves = []
    for lo, hi in ranges:
        bucket_leaves.append(tuple(
            i for i in range(len(sizes))
            if offsets[i] < hi and offsets[i + 1] > lo))
    return BucketPlan(tuple(ranges), tuple(int(o) for o in offsets),
                      tuple(sizes), tuple(shapes), tuple(bucket_leaves))


# ---------------------------------------------------------------------------
# the rounding stream
# ---------------------------------------------------------------------------


def _signed(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _signed(0x9E3779B97F4A7C15)
_MIX1 = _signed(0xBF58476D1CE4E5B9)
_MIX2 = _signed(0x94D049BB133111EB)


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer over int64 tensors (products wrap)."""
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    return z ^ _srl(z, 31)


def draw_uniform(key: torch.Tensor, unit: int, shape, device
                 ) -> torch.Tensor:
    """The stochastic rounding's uniform draws in [0, 1) for transport
    unit ``unit`` of the step that ``key`` = ``(seed, rank, step)``
    names: splitmix64 of the four and the element's position, its top 24
    bits as f32 (exact), on ``device``.  Integer arithmetic only, so the
    CPU and the card draw the same bits.  Looked up at call time, so a
    test can put the JAX package's draws in its place."""
    key = key.to(device)
    n = int(np.prod(shape, dtype=np.int64))
    s = _mix(key[0] * _GOLDEN + key[1])
    s = _mix(s ^ (key[2] * _MIX1))
    s = _mix(s + torch.full((), int(unit) + 1, dtype=torch.int64,
                            device=device) * _MIX2)
    pos = torch.arange(n, dtype=torch.int64, device=device)
    h = _mix(s + pos * _GOLDEN)
    return (_srl(h, 40).to(torch.float32) * (2.0 ** -24)).reshape(shape)


# ---------------------------------------------------------------------------
# per-unit compressed all-reduces
# ---------------------------------------------------------------------------


def _topk_idx(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The first k positions of a stable descending sort of ``|flat|``:
    ``lax.top_k``'s selection, ties to the lower index."""
    _, order = torch.sort(flat.abs(), descending=True, stable=True)
    return order[:k]


def _topk_allreduce(flat: torch.Tensor, axes: AxisSpec, density: float,
                    protocol: str, mesh: Mesh,
                    uniform_axes: Optional[Tuple[str, ...]] = None):
    """Sparse all-reduce of one flat unit: each rank contributes its
    top-k (index, value) pairs.  Returns ``(reduced, unsent, fill)``:
    ``unsent`` is this rank's accumulated gradient with the sent entries
    zeroed, ``fill`` the rd round counts (zeros under allgather)."""
    k = _topk_k(flat.numel(), density)
    idx = _topk_idx(flat, k)
    vals = flat[idx]
    unsent = flat.clone()
    unsent[idx] = 0.0
    if protocol == "rd":
        ax = axes if isinstance(axes, str) else tuple(axes)[0]
        reduced, fill = C.sparse_all_reduce_rd(
            idx, vals, flat.numel(), ax, uniform_axes=uniform_axes,
            mesh=mesh)
    else:
        reduced = C.sparse_all_reduce(idx, vals, flat.numel(), axes,
                                      mesh=mesh)
        fill = torch.zeros(FILL_VEC_LEN, dtype=torch.float32,
                           device=flat.device)
    return reduced, unsent, fill


def _int8_codes(blocks: torch.Tensor, scale: torch.Tensor,
                u: torch.Tensor, dtype) -> torch.Tensor:
    """``clip(floor(x / scale + u), -127, 127)``: the unbiased stochastic
    round of each block against its scale."""
    return torch.clamp(torch.floor(blocks / scale + u), -127,
                       127).to(dtype)


def _int8_allreduce(flat: torch.Tensor, axes: AxisSpec, block: int,
                    draws, accum: str, mesh: Mesh) -> torch.Tensor:
    """Block-quantized all-reduce of one flat unit: per-block max-abs
    scales and stochastic rounding; ``accum="dequant"`` all-gathers the
    int8 codes and f32 scales and dequantize-sums, ``"fixed"`` shares one
    max scale per block over the hop (one all-reduce), sums the int32
    codes by recursive doubling and dequantizes the exact total once.
    ``draws(shape)`` gives the rounding's uniforms."""
    n = flat.numel()
    n_pad = -(-n // block) * block
    padded = torch.cat([flat, flat.new_zeros(n_pad - n)]) if n_pad > n \
        else flat
    blocks = padded.reshape(-1, block)
    # a tensor divisor: the card divides by a Python scalar as a product
    # with its reciprocal, an ulp off the quotient the CPU and XLA give
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True)
                        / torch.full((), 127.0, device=flat.device),
                        min=1e-12)
    if accum == "fixed":
        ax = axes if isinstance(axes, str) else tuple(axes)[0]
        scale = C.pmax(scale, ax, mesh=mesh)
        q = _int8_codes(blocks, scale, draws(tuple(blocks.shape)),
                        torch.int32)
        total = C.fixed_point_all_reduce(q, ax, mesh=mesh)
        return (total.to(torch.float32) * scale).reshape(-1)[:n]
    q = _int8_codes(blocks, scale, draws(tuple(blocks.shape)), torch.int8)
    return C.quantized_all_reduce(q, scale, axes, mesh=mesh).reshape(
        -1)[:n]


def _hier_scatter(flat: torch.Tensor, ici_axis: str, mesh: Mesh
                  ) -> Tuple[torch.Tensor, int]:
    """Exact reduce-scatter of one flat unit over the fast axis: (this
    rank's shard summed over the axis, padded length)."""
    ici = C.axis_size(ici_axis, mesh=mesh)
    n = flat.numel()
    n_pad = -(-n // ici) * ici
    if n_pad > n:
        flat = torch.cat([flat, flat.new_zeros(n_pad - n)])
    i = C.axis_index(ici_axis, mesh=mesh)
    total = C.psum_ordered(flat, ici_axis, mesh=mesh)
    w = n_pad // ici
    return total[i * w:(i + 1) * w].contiguous(), n_pad


def _hier_gather(shard: torch.Tensor, ici_axis: str, n: int, shape,
                 mesh: Mesh) -> torch.Tensor:
    return C.all_gather(shard, ici_axis, mesh=mesh)[:n].reshape(shape)


def _embed_shard(shard: torch.Tensor, ici_axis: str, n: int, n_pad: int,
                 mesh: Mesh) -> torch.Tensor:
    """This rank's shard-domain residual placed back in the full unit
    (zeros outside its own slice): the next step's reduce-scatter routes
    it into exactly its shard again."""
    i = C.axis_index(ici_axis, mesh=mesh)
    full = shard.new_zeros(n_pad)
    full[i * shard.numel():(i + 1) * shard.numel()] = shard
    return full[:n]


def _mode_spec(config: GradReduceConfig):
    """The single rung a non-adaptive config runs every unit at."""
    return config.density if config.mode == "topk" else config.mode


def _segment_reducer(spec, config: GradReduceConfig, mesh: Mesh):
    """``branch(acc, draws) -> (reduced, unsent, fill)`` for one flat unit
    at one rung: a density (EF top-k), ``"int8"`` or ``"exact"`` (both
    consume the whole accumulated gradient: ``unsent = 0``).
    Hierarchical configs wrap the rung's hop in the fast axis's
    reduce-scatter / all-gather pair; the top-k rung's unsent comes back
    embedded in the full unit (:func:`_embed_shard`)."""
    axes = reduction_axes(config)
    hier = config.dcn_axis is not None
    proto = resolved_wire_protocol(config)

    def no_fill(acc):
        return torch.zeros(FILL_VEC_LEN, dtype=torch.float32,
                           device=acc.device)

    def gather(shard, acc):
        return _hier_gather(shard, config.axis, acc.numel(),
                            (acc.numel(),), mesh)

    if spec == "exact":
        def branch(acc, draws):
            if not hier:
                return (C.psum_ordered(acc, axes, mesh=mesh),
                        torch.zeros_like(acc), no_fill(acc))
            shard, _ = _hier_scatter(acc, config.axis, mesh)
            shard = C.psum_ordered(shard, config.dcn_axis, mesh=mesh)
            return gather(shard, acc), torch.zeros_like(acc), no_fill(acc)
    elif spec == "int8":
        def branch(acc, draws):
            if not hier:
                return (_int8_allreduce(acc, axes, config.block_size, draws,
                                        config.int8_accum, mesh),
                        torch.zeros_like(acc), no_fill(acc))
            shard, _ = _hier_scatter(acc, config.axis, mesh)
            shard = _int8_allreduce(shard, config.dcn_axis,
                                    config.block_size, draws,
                                    config.int8_accum, mesh)
            return gather(shard, acc), torch.zeros_like(acc), no_fill(acc)
    else:
        density = float(spec)

        def branch(acc, draws):
            if not hier:
                return _topk_allreduce(acc, axes, density, proto, mesh)
            shard, n_pad = _hier_scatter(acc, config.axis, mesh)
            red_s, unsent_s, fill = _topk_allreduce(
                shard, config.dcn_axis, density, proto, mesh,
                uniform_axes=reduction_axes(config))
            return (gather(red_s, acc),
                    _embed_shard(unsent_s, config.axis, acc.numel(), n_pad,
                                 mesh), fill)
    return branch


def _concat_flat(leaves) -> torch.Tensor:
    if len(leaves) == 1:
        return leaves[0].reshape(-1)
    return torch.cat([leaf.reshape(-1) for leaf in leaves])


def _split_flat(flat: torch.Tensor, plan: BucketPlan) -> list:
    return [flat[plan.leaf_offsets[i]:plan.leaf_offsets[i + 1]].reshape(
        plan.leaf_shapes[i]) for i in range(len(plan.leaf_sizes))]


def _rd_padded(n: int, ici: int, core: int) -> int:
    """Elements of one ``n``-element unit as the compressed hop sees it:
    the fast-axis shard padded to a multiple of the rd core."""
    m = -(-n // max(ici, 1))
    return -(-m // core) * core


def _update_fill_state(new_state: dict, state: dict, fill_parts,
                       unit_sizes, config: GradReduceConfig,
                       mesh: Mesh) -> None:
    """``fill`` keeps this step's raw per-unit vectors; ``union`` smooths
    the union density with the adaptive EMA's idiom."""
    fills = torch.stack(fill_parts)
    new_state["fill"] = fills
    p = C.axis_size(hop_axis(config), mesh=mesh)
    core = rd_topology(p)[0]
    ici = C.axis_size(config.axis, mesh=mesh) \
        if config.dcn_axis is not None else 1
    denom = torch.tensor([_rd_padded(int(n), ici, core) for n in unit_sizes],
                         dtype=torch.float32, device=fills.device)
    new_state["union"] = 0.9 * state["union"] + 0.1 * (
        fills[:, FILL_UNION_SLOT] / denom)


def _advance_key(state: dict, new_state: dict):
    """This step's stream position: the key advanced once, and a draw
    function for its units."""
    key = state["key"] + torch.tensor([0, 0, 1], dtype=torch.int64,
                                      device=state["key"].device)
    new_state["key"] = key

    def unit_draws(unit, device):
        return lambda shape: draw_uniform(key, unit, shape, device)

    return unit_draws


class RungReader:
    """The host's copy of the adaptive rungs for one run of reduces: read
    from the state at the first call, and again once after each step
    whose tick crossed ``adaptive_window`` (the steps where the rungs may
    move).  Every rank reads the same bits (the rungs come from
    all-reduced norms).  Call :meth:`rungs` once before each reduce."""

    def __init__(self, config: GradReduceConfig):
        self.config = config
        self._tick: Optional[int] = None
        self._rungs: Optional[list] = None
        self.reads = 0

    def rungs(self, state: dict) -> list:
        window = self.config.adaptive_window
        if self._tick is None or self._tick % window == 0:
            host = torch.cat([state["tick"].reshape(1).to(torch.int64),
                              state["rung"].to(torch.int64)]).cpu()
            self._tick = int(host[0])
            self._rungs = [int(r) for r in host[1:]]
            self.reads += 1
        self._tick += 1
        return self._rungs


def _reduce_bucketed(grads: Any, state: dict, config: GradReduceConfig,
                     mesh: Mesh, rungs) -> Tuple[Any, dict]:
    """Bucketed (and/or adaptive) reduce of the whole gradient tree: the
    flat concatenation cut per :func:`plan_buckets`, each bucket reduced
    by its own collectives, issued in index order (the order the apply
    consumes them).  With ``adaptive`` each bucket runs the highest rung
    of its leaves (``rungs``, host ints: :class:`RungReader`)."""
    leaves = _leaves(grads)
    plan = plan_buckets(grads, config)
    axes = reduction_axes(config)
    has_ef = _carries_ef(config)
    lad = effective_ladder(config) if config.adaptive else ()
    new_state = dict(state)

    flat = _concat_flat(leaves)
    acc_flat = flat + _concat_flat(_leaves(state["ef"])) if has_ef \
        else flat
    n_buckets = len(plan.ranges)
    unit_draws = (_advance_key(state, new_state)
                  if config.mode == "int8" or "int8" in lad else None)
    if config.adaptive:
        if rungs is None:
            rungs = RungReader(config).rungs(state)
        branches = [_segment_reducer(spec, config, mesh) for spec in lad]
    else:
        single = _segment_reducer(_mode_spec(config), config, mesh)
    out_parts, unsent_parts, fill_parts = [], [], []
    for bi, (lo, hi) in enumerate(plan.ranges):
        acc = acc_flat[lo:hi]
        draws = unit_draws(bi, acc.device) if unit_draws else None
        if config.adaptive:
            b_rung = max(rungs[i] for i in plan.bucket_leaves[bi])
            red, unsent, fill = branches[b_rung](acc, draws)
        else:
            red, unsent, fill = single(acc, draws)
        out_parts.append(red)
        unsent_parts.append(unsent)
        fill_parts.append(fill)
    if "fill" in state:
        _update_fill_state(new_state, state, fill_parts, plan.bucket_sizes,
                           config, mesh)
    out_leaves = _split_flat(torch.cat(out_parts) if n_buckets > 1
                             else out_parts[0], plan)
    if has_ef:
        ef_leaves = _split_flat(torch.cat(unsent_parts) if n_buckets > 1
                                else unsent_parts[0], plan)
        new_state["ef"] = _unflatten(state["ef"], ef_leaves)

    if config.adaptive:
        # psum'd per-leaf norms -> ratio EMA -> windowed rung step, the
        # same bits on every rank; ONE all-reduce for all 2*n_leaves
        # scalars
        eps = 1e-12
        n_leaves = len(leaves)
        local_n2 = torch.stack(
            [torch.sum(torch.square(g)) for g in leaves]
            + [torch.sum(torch.square(e)) for e in ef_leaves])
        summed = C.psum_ordered(local_n2, axes, mesh=mesh)
        g_n2, r_n2 = summed[:n_leaves], summed[n_leaves:]
        ratio = torch.sqrt(r_n2 / (g_n2 + eps))
        beta = 1.0 - 1.0 / config.adaptive_window
        ema = beta * state["ema"] + (1.0 - beta) * ratio
        tick = state["tick"] + 1
        up = (ema > config.adaptive_target).to(torch.int32)
        down = (ema < 0.5 * config.adaptive_target).to(torch.int32)
        proposed = torch.clamp(state["rung"] + up - down, 0, len(lad) - 1)
        new_state["rung"] = torch.where(tick % config.adaptive_window == 0,
                                        proposed, state["rung"])
        new_state["ema"] = ema
        new_state["tick"] = tick
    return _unflatten(grads, out_leaves), new_state


def reduce_gradients(grads: Any, state: dict, config: GradReduceConfig, *,
                     mesh: Optional[Mesh] = None, rungs=None
                     ) -> Tuple[Any, dict]:
    """Sum ``grads`` (this rank's tree of tensors) across the reduction
    axes of ``mesh`` (default the default mesh) under ``config``.
    ``state`` is this rank's reducer state.  Returns ``(reduced,
    new_state)``; ``reduced`` is the same bits on every rank.

    ``mode="exact"`` is :func:`~.collectives.psum_ordered` per leaf
    (hierarchical exact differs from flat only in the f32 order).
    ``bucket_count > 0`` (or ``adaptive``) routes through the bucketed
    transport: exact stays bit-identical, compressed modes select top-k
    per bucket instead of per leaf.  ``rungs``: the adaptive rungs on
    the host (a :class:`RungReader`'s); None reads them from ``state``."""
    mesh = mesh or default_mesh()
    if _bucketed(config):
        return _reduce_bucketed(grads, state, config, mesh, rungs)
    leaves = _leaves(grads)
    axes = reduction_axes(config)
    hier = config.dcn_axis is not None

    if config.mode == "exact":
        if not hier:
            return _unflatten(grads, [C.psum_ordered(g, axes, mesh=mesh)
                                      for g in leaves]), state
        out = []
        for g in leaves:
            shard, _ = _hier_scatter(g.reshape(-1), config.axis, mesh)
            shard = C.psum_ordered(shard, config.dcn_axis, mesh=mesh)
            out.append(_hier_gather(shard, config.axis, g.numel(), g.shape,
                                    mesh))
        return _unflatten(grads, out), state

    if config.mode == "topk":
        proto = resolved_wire_protocol(config)
        ef_leaves = _leaves(state["ef"])
        out, new_ef, fills = [], [], []
        for g, res in zip(leaves, ef_leaves):
            acc = (g + res).reshape(-1)
            if not hier:
                reduced, unsent, fill = _topk_allreduce(
                    acc, axes, config.density, proto, mesh)
                out.append(reduced.reshape(g.shape))
            else:
                # the residual is nonzero only in this rank's own slice of
                # the fast axis, so the reduce-scatter re-injects it into
                # exactly its shard
                shard, n_pad = _hier_scatter(acc, config.axis, mesh)
                reduced, unsent_s, fill = _topk_allreduce(
                    shard, config.dcn_axis, config.density, proto, mesh,
                    uniform_axes=reduction_axes(config))
                out.append(_hier_gather(reduced, config.axis, g.numel(),
                                        g.shape, mesh))
                unsent = _embed_shard(unsent_s, config.axis, g.numel(),
                                      n_pad, mesh)
            new_ef.append(unsent.reshape(g.shape))
            fills.append(fill)
        new_state = dict(state)
        new_state["ef"] = _unflatten(state["ef"], new_ef)
        if "fill" in state:
            _update_fill_state(new_state, state, fills,
                               [g.numel() for g in leaves], config, mesh)
        return _unflatten(grads, out), new_state

    # int8: the stream advances once a step, one unit a leaf
    new_state = dict(state)
    unit_draws = _advance_key(state, new_state)
    out = []
    for li, g in enumerate(leaves):
        draws = unit_draws(li, g.device)
        if not hier:
            out.append(_int8_allreduce(g.reshape(-1), axes,
                                       config.block_size, draws,
                                       config.int8_accum, mesh
                                       ).reshape(g.shape))
            continue
        shard, _ = _hier_scatter(g.reshape(-1), config.axis, mesh)
        shard = _int8_allreduce(shard, config.dcn_axis, config.block_size,
                                draws, config.int8_accum, mesh)
        out.append(_hier_gather(shard, config.axis, g.numel(), g.shape,
                                mesh))
    return _unflatten(grads, out), new_state


# ---------------------------------------------------------------------------
# overlap pipeline + drain
# ---------------------------------------------------------------------------


class PendingReduce:
    """The reduce of the carried ``pending`` gradient, running on a
    worker thread (or done already): :meth:`finish` waits for it and
    stores this step's gradient as the new pending."""

    def __init__(self, future=None, result=None):
        self._future = future
        self._result = result

    def finish(self, grads: Any) -> Tuple[Any, dict]:
        reduced, new_core = (self._future.result() if self._future
                             is not None else self._result)
        new_core = dict(new_core)
        new_core["pending"] = grads
        return reduced, new_core


def start_pipelined(state: dict, config: GradReduceConfig, *,
                    mesh: Optional[Mesh] = None, rungs=None,
                    executor=None) -> PendingReduce:
    """Start the one-step-stale reduce: the carried ``pending`` gradient
    (the previous step's; zeros at the first step, a no-op apply) is
    reduced with the rest of ``state``.  With ``executor`` (a one-worker
    ``ThreadPoolExecutor`` the caller owns) it runs there, over the
    mesh's lane, while the caller computes this step's gradient and runs
    its own collectives on the mesh; without, it runs now.  Every rank
    must start and finish its reduces in the same order."""
    mesh = mesh or default_mesh()
    core = {k: v for k, v in state.items() if k != "pending"}
    if executor is None:
        return PendingReduce(result=reduce_gradients(
            state["pending"], core, config, mesh=mesh, rungs=rungs))
    return PendingReduce(future=executor.submit(
        reduce_gradients, state["pending"], core, config, mesh=mesh.lane(),
        rungs=rungs))


def pipelined_reduce(grads: Any, state: dict, config: GradReduceConfig, *,
                     mesh: Optional[Mesh] = None, rungs=None
                     ) -> Tuple[Any, dict]:
    """Reduce the carried ``pending`` gradient (the previous step's) and
    store ``grads`` as the new pending: :func:`start_pipelined` and
    ``finish`` in one call, with no overlap."""
    return start_pipelined(state, config, mesh=mesh,
                           rungs=rungs).finish(grads)


def drain_pending(state: dict, config: Optional[GradReduceConfig] = None,
                  *, mesh: Optional[Mesh] = None) -> Any:
    """The exact sum over the reduction axes (``config``'s, else every
    axis of ``mesh``) of everything a finished overlapped fit has not
    applied: each rank's ``pending`` gradient plus its EF residual (for
    the hierarchical layout the residual slices are disjoint, so the sum
    is exact there too).  One all-reduce a leaf; the same bits on every
    rank."""
    mesh = mesh or default_mesh()
    axes = reduction_axes(config) if config is not None else \
        mesh.axis_names
    pend = state["pending"]
    if "ef" in state:
        pend = _unflatten(pend, [p + e for p, e in zip(
            _leaves(pend), _leaves(state["ef"]))])
    return _unflatten(pend, [C.psum_ordered(p, axes, mesh=mesh)
                             for p in _leaves(pend)])


# ---------------------------------------------------------------------------
# bytes-on-wire accounting (host side; the JAX package's arithmetic)
# ---------------------------------------------------------------------------


def _spec_payload(n: int, spec, config: GradReduceConfig) -> int:
    """Bytes ONE participant contributes for one ``n``-element unit at
    rung ``spec`` on the compressed hop."""
    if spec == "exact":
        return 4 * n
    if spec == "int8":
        nb = -(-n // config.block_size)
        return n + 4 * nb                  # int8 payload + f32 scales
    # int32 index + f32 value per sent entry
    return 8 * _topk_k(n, float(spec))


def _transport_units(grads_like: Any, config: GradReduceConfig, rungs=None):
    """The (element count, rung spec) pairs the reduce ships: per leaf,
    or per bucket when bucketed/adaptive (a bucket's rung the highest of
    its leaves'; ``rungs=None`` uses the initial rung)."""
    if not _bucketed(config):
        sizes = [int(np.prod(_shape(g), dtype=np.int64) or 1)
                 for g in _leaves(grads_like)]
        return [(n, _mode_spec(config)) for n in sizes]
    plan = plan_buckets(grads_like, config)
    if not config.adaptive:
        return [(hi - lo, _mode_spec(config)) for lo, hi in plan.ranges]
    lad = effective_ladder(config)
    if rungs is None:
        rungs = [_initial_rung(config)] * len(plan.leaf_sizes)
    rungs = [int(r) for r in np.asarray(rungs).reshape(-1)]
    return [(hi - lo, lad[max(rungs[i] for i in plan.bucket_leaves[bi])])
            for bi, (lo, hi) in enumerate(plan.ranges)]


def _rd_wire_unit(n: int, k: int, p: int) -> Tuple[float, float]:
    """Analytic (best, worst) per-participant bytes for ONE ``n``-element
    hop unit shipping ``k`` entries under recursive halving/doubling over
    ``p`` participants (total bytes over the hop divided by ``p``)."""
    core, rounds, extras = rd_topology(p)
    n_pad = -(-n // core) * core
    best = 8.0 * k * extras                       # pre-fold hand-off
    best += core * 8.0 * k * (1.0 - 1.0 / core)   # halving, union stays k
    best += 8.0 * k * (core - 1)                  # sparse doubling
    best += 4.0 * n_pad * extras                  # post-fold dense result
    worst = 8.0 * k * extras
    cap = min((2 if extras else 1) * k, n_pad)
    for r in range(rounds):
        half = n_pad >> (r + 1)
        worst += core * 8.0 * min(cap, half)
        cap = min(2 * cap, half) if half else 0
    union = min(p * k, n_pad)
    worst += (core - 1) * min(8.0 * union, 4.0 * n_pad)
    worst += 4.0 * n_pad * extras
    return best / p, worst / p


def _measured_wire_bytes(fill_rows: np.ndarray, rounds: int) -> float:
    """Per-participant measured bytes from fill vectors (one row a unit):
    8 B per sparse entry in the halving rounds, doubling at 8 B/entry
    sparse blending to 4 B/element dense by the switchover rate, plus
    the fold traffic."""
    total = 0.0
    for row in fill_rows:
        sw = float(row[FILL_SWITCH_SLOT])
        total += 8.0 * float(row[:rounds].sum())
        total += float(row[FILL_DOUBLING_BASE:FILL_DOUBLING_BASE
                           + rounds].sum()) * (8.0 - 4.0 * sw)
        total += 8.0 * float(row[FILL_PREFOLD_SLOT])
        total += 4.0 * float(row[FILL_POSTFOLD_SLOT])
    return total


def payload_bytes(grads_like: Any, config: GradReduceConfig, *,
                  ici_size: int = 1, rungs=None, hop_size: int = None,
                  fill=None) -> dict:
    """Per-participant, per-step payload accounting: the bytes each
    participant puts into the reduction it compresses (indices + values
    for topk, int8 codes + per-block f32 scales for int8) against the
    4 B/element dense payload of the same hop; the JAX package's report,
    key for key.  Hierarchical configs report the compressed dcn hop
    (units of ``ceil(n / ici_size)``) and the exact fast-axis bytes
    (``ici_bytes``) apart.  ``hop_size`` adds the ``wire`` section (the
    all-gather's ``(P-1) * 8k`` against rd's analytic best and worst);
    ``fill`` (the state's ``fill``: one rank's ``(units, 36)``, or
    participant-stacked and averaged) adds the measured bytes."""
    units = _transport_units(grads_like, config, rungs)
    hier = config.dcn_axis is not None
    if hier and ici_size > 1:
        hop_units = [(-(-n // ici_size), spec) for n, spec in units]
    else:
        hop_units = units
    dense = sum(4 * n for n, _ in hop_units)
    compressed = sum(_spec_payload(n, spec, config)
                     for n, spec in hop_units)
    report = {
        "mode": config.mode,
        "dense_bytes": int(dense),
        "compressed_bytes": int(compressed),
        "compression_ratio": (round(dense / compressed, 3)
                              if compressed else None),
        "total_wire_bytes": int(compressed),
    }
    if _bucketed(config):
        report["bucket_count"] = len(units)
    if hier:
        # reduce-scatter + all-gather of the full unit over the fast axis,
        # ring schedule: ~2 * 4n * (I-1)/I bytes a participant
        ici = int(sum(
            math.ceil(2 * 4 * n * (ici_size - 1) / max(ici_size, 1))
            for n, _ in units))
        report["ici_bytes"] = ici
        report["dcn_dense_bytes"] = int(dense)
        report["dcn_compressed_bytes"] = int(compressed)
        report["dcn_compression_ratio"] = report["compression_ratio"]
        report["total_wire_bytes"] = int(compressed) + ici
    report["wire_protocol"] = (
        "rd" if _rd_engaged(config) else "allgather")
    if hop_size is not None and hop_size > 1:
        tk = [(n, float(spec)) for n, spec in hop_units
              if not isinstance(spec, str)]
        if tk:
            p = int(hop_size)
            core, rounds, extras = rd_topology(p)
            allgather = sum(8.0 * _topk_k(n, d) * (p - 1) for n, d in tk)
            best = worst = 0.0
            for n, d in tk:
                b, w = _rd_wire_unit(n, _topk_k(n, d), p)
                best += b
                worst += w
            wire = {
                "hop_participants": p,
                "core": core,
                "rounds": rounds,
                "extras": extras,
                "topk_units": len(tk),
                "allgather_bytes": int(round(allgather)),
                "rd_bytes_best": int(round(best)),
                "rd_bytes_worst": int(round(worst)),
                "rd_bytes_measured": None,
                "fill_rounds_measured": None,
                "switch_rate_measured": None,
                "reduction_vs_allgather_best": (
                    round(allgather / best, 3) if best else None),
                "reduction_vs_allgather_measured": None,
            }
            if fill is not None:
                f = np.asarray(fill.detach().cpu() if isinstance(
                    fill, torch.Tensor) else fill, np.float32)
                if f.ndim == 3:          # participant-stacked
                    f = f.mean(axis=0)
                if f.ndim == 1:
                    f = f[None]
                measured = _measured_wire_bytes(f, rounds)
                wire["rd_bytes_measured"] = round(float(measured), 1)
                wire["fill_rounds_measured"] = [
                    round(float(v), 2) for v in f[:, :rounds].sum(axis=0)]
                wire["switch_rate_measured"] = round(
                    float(f[:, FILL_SWITCH_SLOT].mean()), 3)
                if measured:
                    wire["reduction_vs_allgather_measured"] = round(
                        allgather / measured, 3)
            report["wire"] = wire
    return report


def bucket_report(grads_like: Any, config: GradReduceConfig,
                  rungs=None) -> dict:
    """The analytic bucket plan (shape arithmetic only): bucket count,
    dense bytes a bucket, each bucket's resolved rung payload, each
    leaf's chosen density and the transfer schedule; the JAX package's
    report, key for key."""
    plan = plan_buckets(grads_like, config)
    units = _transport_units(grads_like, config, rungs)
    lad = effective_ladder(config) if config.adaptive else ()
    if config.adaptive:
        if rungs is None:
            leaf_rungs = [_initial_rung(config)] * len(plan.leaf_sizes)
        else:
            leaf_rungs = [int(r) for r in np.asarray(rungs).reshape(-1)]
        leaf_specs = [lad[r] for r in leaf_rungs]
    else:
        leaf_specs = [_mode_spec(config)] * len(plan.leaf_sizes)

    def spec_entry(spec):
        if spec == "exact":
            return {"mode": "exact", "density": 1.0}
        if spec == "int8":
            return {"mode": "int8", "density": None}
        return {"mode": "topk", "density": float(spec)}

    chained = (config.dcn_axis is not None and config.mode != "exact"
               and config.dcn_schedule == "earliest" and len(units) > 1)
    return {
        "bucket_count": len(units),
        "bucket_bytes": [4 * n for n, _ in units],
        "bucket_payload_bytes": [_spec_payload(n, spec, config)
                                 for n, spec in units],
        "per_leaf": [{"leaf": i, "elems": plan.leaf_sizes[i],
                      **spec_entry(leaf_specs[i])}
                     for i in range(len(plan.leaf_sizes))],
        "schedule": {
            "policy": (config.dcn_schedule
                       if config.dcn_axis is not None else None),
            "order": list(range(len(units))) if chained else None,
        },
    }
