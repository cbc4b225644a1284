"""Retrieval quality: the recall harness and sampled recall probes.

``recall_at_k`` is the offline harness (tests, ``chip_smoke.py``);
``RecallProbe`` is the online form: a deterministic sample of live
queries re-scored against an EXACT float64 scan of the index's stored
vectors.  A copy of the JAX package's ``retrieval/metrics.py`` (numpy
only).  :meth:`RecallProbe.publish` takes any object with an
``on_recall_probe`` method — an index tenant's ``ServingMetrics``, whose
``recall_probe`` gauge rides the scheduler's metrics tree."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["RecallProbe", "exact_neighbors", "recall_at_k"]


def recall_at_k(found: np.ndarray, expected: np.ndarray) -> float:
    """Mean per-query overlap |found ∩ expected| / |expected|.

    ``found`` (n, k) may carry ``-1`` for unfilled result slots (never
    counted); ``expected`` (n, k') is the exact reference set."""
    found = np.asarray(found, np.int64)
    expected = np.asarray(expected, np.int64)
    if found.ndim != 2 or expected.ndim != 2 or \
            found.shape[0] != expected.shape[0]:
        raise ValueError("found/expected must be (n, k)-shaped with "
                         "matching n")
    if expected.shape[0] == 0 or expected.shape[1] == 0:
        return 1.0
    hits = 0
    for row_found, row_exp in zip(found, expected):
        real = set(int(i) for i in row_found if i >= 0)
        hits += len(real.intersection(int(i) for i in row_exp))
    return hits / float(expected.size)


def exact_neighbors(queries: np.ndarray, vectors: np.ndarray,
                    ids: np.ndarray, k: int) -> np.ndarray:
    """Exact top-k ids by brute-force float64 squared L2 (first-index
    ties): the oracle every approximate path is scored against."""
    q = np.asarray(queries, np.float64)
    v = np.asarray(vectors, np.float64)
    ids = np.asarray(ids, np.int64)
    if v.shape[0] == 0:
        return np.full((q.shape[0], k), -1, np.int64)
    d2 = (np.sum(q * q, axis=1)[:, None] + np.sum(v * v, axis=1)[None, :]
          - 2.0 * q @ v.T)
    k_eff = min(k, v.shape[0])
    top = np.argsort(d2, axis=1, kind="stable")[:, :k_eff]
    out = np.full((q.shape[0], k), -1, np.int64)
    out[:, :k_eff] = ids[top]
    return out


class RecallProbe:
    """Sampled online recall: every ``observe`` keeps a deterministic
    Bernoulli sample of the batch, scores the index's answer against the
    exact scan of its stored vectors, and folds the result into a running
    mean; ``publish`` pushes that mean to a metrics sink."""

    def __init__(self, index, *, k: Optional[int] = None,
                 nprobe: Optional[int] = None, sample: float = 0.25,
                 seed: int = 0):
        if not 0.0 < sample <= 1.0:
            raise ValueError(f"sample={sample} must be in (0, 1]")
        self._index = index
        self._k = index.k if k is None else int(k)
        self._nprobe = nprobe
        self._sample = float(sample)
        self._rng = np.random.default_rng(seed)
        self._hits = 0.0
        self._total = 0

    def observe(self, queries: np.ndarray,
                neighbors: Optional[np.ndarray] = None) -> Optional[float]:
        """Score a (sampled) query batch; returns this batch's recall or
        ``None`` when the sample kept no rows.  Pass the ``neighbors`` the
        serve path already computed to probe exactly what was served;
        omitted, the probe searches the index itself."""
        queries = np.asarray(queries, np.float32)
        keep = self._rng.random(queries.shape[0]) < self._sample
        if not keep.any():
            return None
        sampled = queries[keep]
        if neighbors is None:
            found, _ = self._index.search(sampled, nprobe=self._nprobe,
                                          k=self._k)
        else:
            found = np.asarray(neighbors, np.int64)[keep, :self._k]
        ids, vectors = self._index.stored_vectors()
        exact = exact_neighbors(sampled, vectors, ids, self._k)
        batch = recall_at_k(found, exact)
        self._hits += batch * exact.size
        self._total += exact.size
        return batch

    @property
    def value(self) -> float:
        """Running mean recall (NaN until the first kept sample: the
        is-absent convention of gauges)."""
        return self._hits / self._total if self._total else float("nan")

    def publish(self, sink) -> float:
        """Push the running mean through ``sink.on_recall_probe``; returns
        the published value."""
        value = self.value
        sink.on_recall_probe(value)
        return value

    def reset(self) -> Tuple[float, int]:
        """Roll the window: returns (mean, sampled count) and zeroes the
        accumulators."""
        out = (self.value, self._total)
        self._hits, self._total = 0.0, 0
        return out
