"""Hot embedding-row cache: device-resident LRU row blocks.

A port of the JAX package's ``serving/embcache.py``.  Wide&Deep's stacked
tables are the one serving operand that does NOT amortize across tenants:
a ``(total_vocab, emb_dim)`` table per tenant at production vocab sizes
exhausts device memory long before the card runs out of compute.
Zipfian traffic is the way out — most lookups hit a small hot set — so
:class:`EmbeddingRowCache` keeps only the HOT row blocks on the device and
copies cold blocks in on demand:

- **Fixed device pools.**  One preallocated pool per table, shape
  ``(capacity_blocks, block_rows, *row_shape)``.  A miss writes its block
  into a pool slot (one slice assignment, a synchronous copy from the
  host table), and a batch lookup is one indexing gather
  ``pool[slots, locals]``.
- **LRU over blocks, not rows.**  The slot map (``block_id -> slot``) and
  recency order live on the host; eviction frees the least recently
  TOUCHED block's slot (touch = any lookup that read the block).  Rows
  inside a block ride together — the block is the transfer and residency
  granule, which is what makes the zipfian head cheap (hot ids cluster
  into few blocks).
- **Exactness.**  A cached gather returns bitwise the same rows as
  indexing the host table: blocks are exact copies and the gather is
  pure indexing.  ``CachedWideDeepServable`` feeds the gathered rows
  through the SAME row-tiled scoring the model's transform runs
  (``widedeep.py::scores_from_rows`` over ``forward_from_rows``), so
  served scores are bit-exact with ``model.transform``.

**Int8 row pools**: ``precision="int8"`` stores matrix-row tables as int8
CODES plus one f32 per-row scale, quantized ONCE from the host table at
construction (``rebind``'s fresh cache re-calibrates each generation).
The codes pool plus the scales pool cost ~(1 + 4/row_dim)/4 of the f32
pool at the same ``capacity_blocks``, so at a FIXED device byte budget an
int8 cache holds ~2x the resident rows.  A lookup gathers codes and
scales and dequantizes the gathered rows on the device (one exact cast +
one f32 multiply; the f32 table never materializes); the oversized-batch
bypass dequantizes the SAME codes on the host, so cached and bypassed
batches return identical bits.  Scalar-row (1-d) tables — Wide&Deep's
``wide_cat`` — stay f32: codes + a per-row scale would cost more than the
f32 they replace.

**Single-consumer contract**: ``lookup`` mutates the slot map and the
pools without a lock — exactly one thread may call it (the scheduler's
serve loop / an endpoint's serve thread).  Warm-up of a NEW servable
sharing a cache with a concurrently serving one is NOT supported: give
each generation its own cache, which ``rebind`` does.  Hit/miss/eviction
counters publish as gauges (``snapshot()`` is a ``MetricsTree``
provider).
"""

from __future__ import annotations

import itertools
import time

from collections import OrderedDict
from typing import Any, Dict

import numpy as np
import torch

from ..data.table import Table
from ..utils.device import resolve_device
from .executor import ServableModel, _tree_bytes

__all__ = ["EmbeddingRowCache", "CachedWideDeepServable"]


class EmbeddingRowCache:
    """LRU of device-resident row blocks over host-resident tables
    (module doc).  ``tables`` maps name -> host array sharing one leading
    (vocab) dim — Wide&Deep passes ``{"wide_cat": (V,), "emb": (V, E)}``.
    The pools live on ``device`` (default the card)."""

    def __init__(self, tables: Dict[str, Any], *, block_rows: int = 512,
                 capacity_blocks: int = 64, precision: str = "f32",
                 device: Any = "cuda"):
        if not tables:
            raise ValueError("tables must not be empty")
        if block_rows <= 0:
            raise ValueError("block_rows must be positive")
        if capacity_blocks <= 0:
            raise ValueError("capacity_blocks must be positive")
        if precision not in ("f32", "int8"):
            raise ValueError(f"unknown cache precision {precision!r}")
        self.precision = precision
        self.device = resolve_device(device)
        self._host = {name: np.asarray(t) for name, t in tables.items()}
        sizes = {name: t.shape[0] for name, t in self._host.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(
                f"tables must share one vocab dim, got {sizes}")
        self.vocab = next(iter(sizes.values()))
        if self.vocab == 0:
            raise ValueError("tables must carry at least one row")
        # int8: matrix-row tables become codes + per-row scales, ONCE,
        # from this generation's host table.  Scalar-row tables stay f32.
        self._host_scales: Dict[str, np.ndarray] = {}
        if precision == "int8":
            from ..kernels.quantize import quantize_rows

            for name, t in self._host.items():
                if t.ndim >= 2:
                    codes, scales = quantize_rows(t)
                    self._host[name] = codes
                    self._host_scales[name] = scales
        self.block_rows = block_rows
        self.n_blocks = -(-self.vocab // block_rows)
        #: a cache bigger than the table is just the table — cap it so
        #: the accounting (resident fraction, pool bytes) stays honest
        self.capacity_blocks = min(capacity_blocks, self.n_blocks)
        self._pools = {
            name: torch.zeros(
                (self.capacity_blocks, block_rows) + t.shape[1:],
                dtype=torch.from_numpy(t[:0]).dtype, device=self.device)
            for name, t in self._host.items()}
        self._scale_pools = {
            name: torch.zeros((self.capacity_blocks, block_rows),
                              dtype=torch.float32, device=self.device)
            for name in self._host_scales}
        self._slot_of: Dict[int, int] = {}
        self._lru: "OrderedDict[int, int]" = OrderedDict()
        self._free = list(range(self.capacity_blocks - 1, -1, -1))
        self.hits = 0            # per-id lookups served from a resident block
        self.misses = 0          # per-id lookups that had to fault a block in
        self.block_faults = 0    # blocks copied host -> device
        self.evictions = 0
        self.lookups = 0         # lookup() calls
        self.bypasses = 0        # batches served uncached (working set
        #                          bigger than the whole cache)
        self._fault_s = 0.0

    # -- core ----------------------------------------------------------------
    def _block(self, table: np.ndarray, block: int) -> torch.Tensor:
        """One block of a host table (the last one short)."""
        lo = block * self.block_rows
        return torch.from_numpy(
            np.ascontiguousarray(table[lo:lo + self.block_rows]))

    def _admit(self, block: int, pinned) -> int:
        """Fault one block in (single-consumer; see module doc).
        ``pinned`` blocks — the ones the CURRENT lookup touches — are
        exempt from eviction: they must all be resident simultaneously
        when the batch gather runs after the admit loop."""
        if self._free:
            slot = self._free.pop()
        else:
            for old_block in self._lru:
                if old_block not in pinned:
                    break
            else:  # unreachable: lookup() bypasses oversized batches
                raise RuntimeError("no evictable block")
            slot = self._lru.pop(old_block)
            del self._slot_of[old_block]
            self.evictions += 1
        t0 = time.perf_counter()
        # the tail of the table's last block keeps whatever the slot held
        # before: no id ever reaches a row past the vocab
        for name, pool in self._pools.items():
            rows = self._block(self._host[name], block)
            pool[slot, :rows.shape[0]] = rows
        for name, pool in self._scale_pools.items():
            rows = self._block(self._host_scales[name], block)
            pool[slot, :rows.shape[0]] = rows
        self._fault_s += time.perf_counter() - t0
        self.block_faults += 1
        self._slot_of[block] = slot
        self._lru[block] = slot
        return slot

    def lookup(self, ids: Any) -> Dict[str, torch.Tensor]:
        """Device rows for ``ids`` (any int shape), one entry per table:
        output shape is ``ids.shape + row_shape`` (int8 tables come back
        dequantized, f32).  Faults missing blocks in (LRU-evicting),
        touches resident ones."""
        ids = np.asarray(ids)
        if ids.size == 0:
            raise ValueError("lookup needs at least one id")
        if ids.min() < 0 or ids.max() >= self.vocab:
            raise ValueError(
                f"id out of range [0, {self.vocab}) — offset/validate "
                "ids before the cache (WideDeep's _validate_cat_ids)")
        self.lookups += 1
        blocks = ids // self.block_rows
        local = ids % self.block_rows
        unique, inverse, counts = np.unique(
            blocks, return_inverse=True, return_counts=True)
        if unique.shape[0] > self.capacity_blocks:
            # one batch's working set exceeds the whole cache: every admit
            # would evict a block THIS gather still needs.  Serve the batch
            # uncached (exact host gather — bitwise the same rows), leave
            # the resident set untouched, and account it: a rising bypass
            # counter says capacity_blocks is undersized for the traffic,
            # not that results degraded.
            self.bypasses += 1
            self.misses += int(ids.size)
            # int8 tables dequantize on the host from the SAME codes the
            # pools hold — one f32 cast + one f32 multiply, elementwise,
            # so bypassed batches are bitwise the cached batches
            return {
                name: torch.from_numpy(np.ascontiguousarray(
                    table[ids].astype(np.float32)
                    * self._host_scales[name][ids][..., None]
                    if name in self._host_scales else table[ids])
                ).to(self.device)
                for name, table in self._host.items()}
        pinned = {int(b) for b in unique}
        slots = np.empty((unique.shape[0],), np.int64)
        for i, block in enumerate(unique):
            block = int(block)
            slot = self._slot_of.get(block)
            if slot is None:
                slot = self._admit(block, pinned)
                self.misses += int(counts[i])
            else:
                self._lru.move_to_end(block)
                self.hits += int(counts[i])
            slots[i] = slot
        slot_ids = torch.from_numpy(
            slots[inverse.reshape(-1)].reshape(ids.shape)).to(self.device)
        local = torch.from_numpy(local.astype(np.int64)).to(self.device)
        out = {}
        for name, pool in self._pools.items():
            rows = pool[slot_ids, local]
            if name in self._scale_pools:
                rows = (rows.to(torch.float32)
                        * self._scale_pools[name][slot_ids, local][..., None])
            out[name] = rows
        return out

    # -- observability -------------------------------------------------------
    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else float("nan")

    @property
    def resident_blocks(self) -> int:
        return len(self._lru)

    @property
    def pool_bytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for p in itertools.chain(self._pools.values(),
                                            self._scale_pools.values()))

    def reset_counters(self) -> None:
        """Zero the hit/miss ledger (a measured window apart from
        warm-up); the resident set is untouched."""
        self.hits = self.misses = 0
        self.block_faults = self.evictions = self.lookups = 0
        self.bypasses = 0
        self._fault_s = 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate, 4)
            if self.hits + self.misses else None,
            "block_faults": self.block_faults,
            "evictions": self.evictions,
            "lookups": self.lookups,
            "bypasses": self.bypasses,
            "fault_ms": round(self._fault_s * 1e3, 3),
            "resident_blocks": self.resident_blocks,
            "capacity_blocks": self.capacity_blocks,
            "n_blocks": self.n_blocks,
            "block_rows": self.block_rows,
            "pool_bytes": self.pool_bytes,
            "precision": self.precision,
        }

    def publish(self, group) -> None:
        """Refresh gauges on ``group`` (a ``MetricGroup``): hit, miss and
        eviction visibility on the metrics tree."""
        snap = self.snapshot()
        for name in ("hits", "misses", "block_faults", "evictions",
                     "lookups", "bypasses", "resident_blocks",
                     "capacity_blocks", "pool_bytes"):
            group.gauge(name).set(snap[name])
        group.gauge("hit_rate").set(
            snap["hit_rate"] if snap["hit_rate"] is not None
            else float("nan"))


# ---------------------------------------------------------------------------
# the Wide&Deep adopter
# ---------------------------------------------------------------------------

class CachedWideDeepServable(ServableModel):
    """Wide&Deep serving through the embedding-row cache: only hot table
    blocks are device-resident; scores are bit-exact with
    ``model.transform`` (module doc).  ``rebind`` gets a FRESH cache over
    the new generation's tables — cached rows of the old generation must
    never serve the new one."""

    rebind_safe = True
    supported_precisions = ("f32", "int8")

    def __init__(self, model, example: Table, *,
                 cache_block_rows: int = 512,
                 cache_capacity_blocks: int = 64, **kwargs: Any):
        super().__init__(model, example, **kwargs)
        self._cache_block_rows = cache_block_rows
        self._cache_capacity_blocks = cache_capacity_blocks
        self._bind(model)

    def _bind(self, model) -> None:
        from ..api.chain import params_to_device

        model._require_model()
        params = model._params
        self._vocab_sizes = model._vocab_sizes
        dev = resolve_device(model.device)
        # int8 calibration point of the cached path: the cache quantizes
        # THIS generation's tables and the dense tower quantizes here;
        # rebind() re-binds the clone, so scales always come from the
        # params they serve
        self.cache = EmbeddingRowCache(
            {"wide_cat": params["wide_cat"], "emb": params["emb"]},
            block_rows=self._cache_block_rows,
            capacity_blocks=self._cache_capacity_blocks,
            precision=self.precision, device=dev)
        rest = {k: params[k] for k in ("wide_dense", "wide_b", "mlp")}
        if self.precision == "int8":
            from ..kernels.quantize import quantize_widedeep_rest

            rest = quantize_widedeep_rest(rest)
        self._rest = params_to_device(rest, dev)

    def rebind(self, model) -> "ServableModel":
        clone = super().rebind(model)
        clone._bind(model)
        return clone

    @property
    def param_bytes(self) -> int:
        """Bytes of the device-resident params: the dense tower plus the
        cache's pools."""
        return _tree_bytes(self._rest) + self.cache.pool_bytes

    def _run(self, table: Table) -> Table:
        from ..kernels.quantize import dequantize_widedeep_rest
        from ..models.recommendation.widedeep import (_validate_cat_ids,
                                                      scores_from_rows)
        from ..utils.padding import pad_rows_to_bucket

        model = self.model
        dense = np.asarray(table[model.DENSE_FEATURES_COL], np.float32)
        cat = np.asarray(table[model.CAT_FEATURES_COL], np.int32)
        gids = _validate_cat_ids(cat, self._vocab_sizes)
        # pad ids are 0 = the first stacked slot, always a valid row (the
        # transform stance); pad rows slice away below
        (dense_p, gids_p), n = pad_rows_to_bucket(
            (dense, gids), min_bucket=self.min_bucket)
        rows = self.cache.lookup(gids_p)
        rest = (dequantize_widedeep_rest(self._rest)
                if self.precision == "int8" else self._rest)
        with torch.no_grad():
            scores = scores_from_rows(
                rest, torch.from_numpy(dense_p).to(self.cache.device),
                rows["wide_cat"], rows["emb"])
        scores = scores[:n].cpu().numpy().astype(np.float64)
        out = table.with_column(model.get_raw_prediction_col(), scores)
        return out.with_column(model.get_prediction_col(),
                               (scores > 0.5).astype(np.int64))
