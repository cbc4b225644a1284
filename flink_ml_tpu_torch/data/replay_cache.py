"""RAM-resident replay of a decoded batch stream.

The reference's ``ReplayOperator`` makes bounded inputs cheap to iterate:
round 0 passes records through while writing them to a ``DataCacheWriter``;
every later round re-reads the cache instead of re-running the upstream
pipeline (``iteration/operator/ReplayOperator.java:62-311``).  In the
streamed fits the expensive upstream work is not the read — it is the host
*decode* that turns raw cached rows into device-ready arrays (pad + dtype
casts + the ELL layout and sample routing builds, ``ops/ell_scatter.py``).

:class:`DecodedReplayCache` is the analog one level higher than the
reference's, and serves two access patterns:

- **Positional (record/replay)** — epoch-stable streams: the *first*
  epoch tees each decoded batch (a tuple of fixed-shape numpy arrays)
  into host RAM up to a byte budget; later epochs replay the cached
  prefix directly into the transfer stage and only re-decode the tail
  that did not fit.  The streamed fits require fixed batch shapes, so
  every cached batch has identical nbytes and the budget maps 1:1 to a
  batch-count prefix.  ``offer`` + ``finish`` + ``replay``.
- **Block-keyed** — epoch-VARYING but block-addressable streams
  (``ShuffledCacheReader``): entries key by BLOCK id instead of stream
  position, ``get`` works without any ``finish`` phase, and every epoch
  serves cached blocks in that epoch's fresh permutation while
  decoding+offering the misses — reshuffling and decode-once compose.
  ``offer`` + ``get`` + ``set_anchor`` (the per-epoch contract-check
  digest).

Thread-safety: ``offer`` may be called from multiple decode workers in
any order (the prefetch pool reassembles source order downstream, but the
tee happens inside the transform).  ``finish`` computes the longest
contiguous prefix from batch 0 that landed under the budget and drops any
stragglers, so positional replay order is always exactly source order.

A copy of the JAX package's ``data/replay_cache.py`` (numpy only).
"""

from __future__ import annotations

import hashlib
import threading

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DecodedReplayCache", "batch_fingerprint", "default_ram_budget"]


def default_ram_budget(fraction: float = 0.25,
                       cap_bytes: int = 32 << 30) -> int:
    """Budget for the decoded cache when the caller does not pin one:
    ``fraction`` of *currently available* host RAM, capped.  Reads
    ``/proc/meminfo`` (Linux); where that is unavailable the budget
    falls back to a conservative 1 GiB — over-budgeting on an unknown
    host risks the OOM kill that out-of-core training exists to avoid."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                    return int(min(avail * fraction, cap_bytes))
    except OSError:
        pass
    return min(1 << 30, cap_bytes)


def _is_disk_backed(a) -> bool:
    """True when the array's ultimate base is an ``np.memmap`` — its
    bytes live in the page cache, not anonymous RAM."""
    while isinstance(a, np.ndarray):
        if isinstance(a, np.memmap):
            return True
        a = a.base
    return False


def _retained(a: np.ndarray) -> np.ndarray:
    """The array as the cache should hold it.  Disk-backed views are
    materialized (the budget must count real RAM and replay must not
    fault pages back in).  RAM views whose ultimate base is more than
    2x the view's bytes are COPIED: zero-copy retention would keep the
    whole base alive while the budget counts only the view.
    Exact-sized views and decode-fresh arrays stay zero-copy."""
    if _is_disk_backed(a):
        return np.array(a)
    a = np.asarray(a)
    # walk to the OUTERMOST ndarray in the base chain: for frombuffer
    # arrays the chain ends in a non-ndarray buffer (bytes, mmap), and
    # that outermost ndarray spans it — comparing its nbytes still
    # detects the small-view-of-big-buffer case
    base = a
    while isinstance(base.base, np.ndarray):
        base = base.base
    if base is not a and base.nbytes > 2 * a.nbytes:
        return np.array(a)
    return a


def batch_fingerprint(batch) -> bytes:
    """Order-stable digest of a raw host batch (a dict of arrays, or any
    sequence of arrays).  Used by the replay guard in
    ``sgd_fit_outofcore``: under ``cache_decoded="auto"`` the first raw
    batch of every replay epoch is re-read and compared against the
    recorded epoch's digest, so a reader that legitimately varies its
    stream per epoch (re-shuffled segment order, per-epoch sampling)
    drops the cache instead of silently training on frozen epoch-0
    data."""
    h = hashlib.blake2b(digest_size=16)
    items = (sorted(batch.items()) if isinstance(batch, dict)
             else list(enumerate(batch)))
    for key, value in items:
        a = np.ascontiguousarray(value)
        h.update(str(key).encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.digest()


class DecodedReplayCache:
    """Cache-what-fits store of decoded batches, addressed positionally
    (record/replay prefix) or by block id (see module doc)."""

    def __init__(self, ram_budget_bytes: int):
        if ram_budget_bytes < 0:
            raise ValueError(
                f"ram_budget_bytes must be >= 0, got {ram_budget_bytes}")
        self.budget = int(ram_budget_bytes)
        self._entries: Dict[int, Tuple[np.ndarray, ...]] = {}
        self._bytes = 0
        self._full = False          # budget hit: stop accepting
        self._lock = threading.Lock()
        self._prefix: Optional[int] = None   # set by finish()
        self.n_batches: Optional[int] = None
        # digest of the recording epoch's first RAW batch (pre-decode),
        # set by the recording caller; replay guards compare against it
        self.fingerprint: Optional[bytes] = None
        # additional raw digests at power-of-two stream indices (set by
        # the recording caller): replay guards on SEEKABLE readers probe
        # the largest recorded index <= n_batches-1 as a second,
        # mid-stream determinism check — a one-batch digest cannot catch
        # a reader that shuffles everything after its first batch
        # Distinct keys per writer; dict ops are atomic.
        self.probe_fingerprints: Dict[int, bytes] = {}
        # block-keyed mode: the first cached block's id — later epochs
        # re-digest that block's raw bytes to catch readers that violate
        # the per-block-determinism contract
        self.anchor_key: Optional[int] = None

    # ------------------------------------------------------------ record

    def offer(self, index: int, arrays: Sequence[np.ndarray]) -> None:
        """Tee decoded batch ``index``.  Drops (permanently disables
        further storing) once the cumulative size would exceed the
        budget — transient overshoot is bounded by the number of
        concurrent decode workers, never by the stream length.

        Decode-fresh arrays (and views of them) are retained zero-copy;
        disk-backed views (``np.memmap`` slices that passed through the
        decode uncopied — dense columns already in their target dtype)
        are materialized into RAM here, otherwise the budget would count
        pages that occupy no RAM and "replay" would still fault batches
        in from disk."""
        if self._full or self._prefix is not None:
            return
        stored = tuple(_retained(a) for a in arrays)
        size = sum(int(a.nbytes) for a in stored)
        with self._lock:
            if self._full:
                return
            if self._bytes + size > self.budget:
                self._full = True
                return
            self._bytes += size
            self._entries[index] = stored

    def finish(self, n_batches: int) -> None:
        """End of the recording epoch: keep the longest contiguous prefix
        from batch 0, free everything else."""
        with self._lock:
            prefix = 0
            while prefix in self._entries:
                prefix += 1
            for i in list(self._entries):
                if i >= prefix:
                    self._bytes -= sum(
                        int(a.nbytes) for a in self._entries[i])
                    del self._entries[i]
            self._prefix = prefix
            self.n_batches = int(n_batches)

    def set_anchor(self, key: int, fingerprint: bytes) -> None:
        """Record the contract-check anchor (first offered block) once;
        atomic so concurrent decode workers cannot pair one worker's key
        with another's digest."""
        with self._lock:
            if self.anchor_key is None:
                self.anchor_key = key
                self.fingerprint = fingerprint

    # ------------------------------------------------------ keyed lookup

    def get(self, key: int) -> Optional[Tuple[np.ndarray, ...]]:
        """Keyed access, usable WITHOUT :meth:`finish` — the block-keyed
        mode (``sgd_fit_outofcore`` over block-addressable shuffled
        readers) keys entries by BLOCK id rather than stream position:
        every epoch serves cached blocks and decodes+offers the rest, so
        there is no record/replay phase boundary and no prefix."""
        return self._entries.get(key)

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------ replay

    @property
    def ready(self) -> bool:
        return self._prefix is not None

    @property
    def prefix_batches(self) -> int:
        """Batches replayable from RAM (valid after :meth:`finish`)."""
        if self._prefix is None:
            raise RuntimeError("cache not finished; no prefix yet")
        return self._prefix

    @property
    def cached_bytes(self) -> int:
        return self._bytes

    def replay(self, start: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield cached batches ``start..prefix`` in source order."""
        if self._prefix is None:
            raise RuntimeError("cache not finished; cannot replay")
        for i in range(start, self._prefix):
            yield self._entries[i]
