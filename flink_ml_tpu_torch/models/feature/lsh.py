"""MinHashLSH — locality-sensitive hashing for Jaccard similarity.

Vectors are treated as binary sets (nonzero positions).  Each hash
function is the classic universal hash ``((1 + i) * a + b) mod P``
minimized over the active indices; the model carries ``numHashTables``
tables of ``numHashFunctionsPerTable`` functions.

The (d, m) hash-value table is built once a call on the host in int64,
and each row takes a masked int32 min over its active indices on the
device, in row chunks so the ``(rows, d, m)`` transient stays bounded.
Candidate bucketing for the approximate queries is host-side set
arithmetic over the tiny per-table signatures.

A port of the JAX package's ``models/feature/lsh.py``: the same seeded
coefficients, hash table and host queries; the signatures are exact
integer minima, equal to the JAX package's whatever the chunking.  Every
stage runs on ``device`` (default ``"cuda"``; raises without a card
unless ``"cpu"`` is asked for).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.stage import Estimator, Model
from ...data.table import Table
from ...linalg import stack_vectors
from ...params.param import IntParam, ParamValidators
from ...params.shared import HasSeed
from ...utils import persist
from ...utils.device import resolve_device
from .transforms import _InOutParams, _OnDevice

__all__ = ["MinHashLSH", "MinHashLSHModel"]

_MINHASH_PRIME = 2038074743

#: elements of the (rows, d, m) int32 transient a chunk (256 MB)
_MINHASH_CHUNK_ELEMS = 1 << 26


class MinHashLSHParams(_InOutParams, HasSeed):
    NUM_HASH_TABLES = IntParam(
        "numHashTables", "Number of hash tables (OR-amplification).",
        default=1, validator=ParamValidators.gt(0))
    NUM_HASH_FUNCTIONS_PER_TABLE = IntParam(
        "numHashFunctionsPerTable",
        "Hash functions per table (AND-amplification).",
        default=1, validator=ParamValidators.gt(0))

    def get_num_hash_tables(self) -> int:
        return self.get(MinHashLSHParams.NUM_HASH_TABLES)

    def set_num_hash_tables(self, value: int):
        return self.set(MinHashLSHParams.NUM_HASH_TABLES, value)

    def get_num_hash_functions_per_table(self) -> int:
        return self.get(MinHashLSHParams.NUM_HASH_FUNCTIONS_PER_TABLE)

    def set_num_hash_functions_per_table(self, value: int):
        return self.set(
            MinHashLSHParams.NUM_HASH_FUNCTIONS_PER_TABLE, value)


def _minhash_batch(active: torch.Tensor, hash_values: torch.Tensor
                   ) -> torch.Tensor:
    """(n, d) bool batch x (d, m) int32 hash table -> (n, m) int32
    signatures: min of each hash column over the row's active indices, in
    row chunks of at most ``_MINHASH_CHUNK_ELEMS / (d m)`` rows.  Integer
    math — hash values reach ~2^31 and must compare exactly (f32 would
    merge distinct buckets at 24-bit mantissa resolution)."""
    n, d = active.shape
    m = hash_values.shape[1]
    rows = max(1, _MINHASH_CHUNK_ELEMS // max(d * m, 1))
    none = torch.tensor(_MINHASH_PRIME + 1, dtype=torch.int32,
                        device=active.device)
    out = torch.empty((n, m), dtype=torch.int32, device=active.device)
    for start in range(0, n, rows):
        a = active[start:start + rows]
        out[start:start + rows] = torch.amin(
            torch.where(a[:, :, None], hash_values[None, :, :], none), dim=1)
    return out


def _jaccard_distance(a: np.ndarray, B: np.ndarray) -> np.ndarray:
    """1 - |A ∩ B| / |A ∪ B| between one binary row and a batch."""
    a = a > 0
    B = B > 0
    inter = (a[None, :] & B).sum(axis=1)
    union = (a[None, :] | B).sum(axis=1)
    return 1.0 - inter / np.maximum(union, 1)


class MinHashLSHModel(_OnDevice, MinHashLSHParams, Model):
    def __init__(self, device="cuda"):
        super().__init__(device=device)
        self._coeff: Optional[np.ndarray] = None     # (m, 2) [a, b]

    def set_model_data(self, *inputs) -> "MinHashLSHModel":
        (t,) = inputs
        self._coeff = np.asarray(t["coefficients"], np.int64)
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"coefficients": self._coeff})]

    def _require_model(self) -> None:
        if self._coeff is None:
            raise RuntimeError("MinHashLSHModel has no model data")

    # -- hashing ------------------------------------------------------------
    def hash_table(self, d: int) -> np.ndarray:
        """The (d, m) int32 hash values of indices ``1..d`` (host int64)."""
        self._require_model()
        idx = np.arange(1, d + 1, dtype=np.int64)[:, None]   # 1-based
        a, b = self._coeff[:, 0][None, :], self._coeff[:, 1][None, :]
        return ((idx * a + b) % _MINHASH_PRIME).astype(np.int32)

    def _signatures(self, X: np.ndarray) -> np.ndarray:
        """(n, tables, fns) float64 signatures."""
        self._require_model()
        active = X > 0
        if np.any(active.sum(axis=1) == 0):
            raise ValueError("MinHashLSH requires at least one nonzero "
                             "entry per vector")
        dev = resolve_device(self.device)
        sig = _minhash_batch(
            torch.from_numpy(np.ascontiguousarray(active)).to(dev),
            torch.from_numpy(self.hash_table(X.shape[1])).to(dev))
        return sig.cpu().numpy().astype(np.float64).reshape(
            X.shape[0], self.get_num_hash_tables(),
            self.get_num_hash_functions_per_table())

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        X = stack_vectors(table[self.get_features_col()])
        return [table.with_column(self.get_output_col(),
                                  self._signatures(X))]

    # -- approximate queries -------------------------------------------------
    def _bucket_sets(self, sig: np.ndarray) -> List[set]:
        """Per-row set of hashable per-table bucket ids."""
        return [{(t, tuple(sig[i, t])) for t in range(sig.shape[1])}
                for i in range(sig.shape[0])]

    def approx_nearest_neighbors(self, dataset: Table, key: np.ndarray,
                                 k: int, features_col: Optional[str] = None
                                 ) -> Table:
        """Rows of ``dataset`` sharing >= 1 hash bucket with ``key``,
        ranked by true Jaccard distance, top-k; appends a ``distCol``
        column (falls back to a full scan when no bucket collides, like
        the Flink ML implementation's single-probe behavior does not —
        documented deviation for usability)."""
        col = features_col or self.get_features_col()
        X = stack_vectors(dataset[col])
        key = np.asarray(key, np.float64).ravel()
        sig = self._signatures(X)
        key_sig = self._signatures(key[None, :])
        key_buckets = self._bucket_sets(key_sig)[0]
        rows = self._bucket_sets(sig)
        cand = np.asarray([bool(r & key_buckets) for r in rows])
        if not cand.any():
            cand = np.ones(len(rows), bool)
        idx = np.flatnonzero(cand)
        dist = _jaccard_distance(key, X[idx])
        order = np.argsort(dist, kind="stable")[:k]
        out = dataset.select_rows(idx[order])
        return out.with_column("distCol", dist[order])

    def approx_similarity_join(self, table_a: Table, table_b: Table,
                               threshold: float, id_col: str) -> Table:
        """(idA, idB, distCol) for cross pairs sharing >= 1 bucket with
        Jaccard distance < threshold."""
        Xa = stack_vectors(table_a[self.get_features_col()])
        Xb = stack_vectors(table_b[self.get_features_col()])
        buckets_a = self._bucket_sets(self._signatures(Xa))
        buckets_b = self._bucket_sets(self._signatures(Xb))
        by_bucket: dict = {}
        for j, bs in enumerate(buckets_b):
            for bucket in bs:
                by_bucket.setdefault(bucket, []).append(j)
        ids_a, ids_b, dists = [], [], []
        for i, bs in enumerate(buckets_a):
            cand = sorted({j for bucket in bs
                           for j in by_bucket.get(bucket, [])})
            if not cand:
                continue
            dist = _jaccard_distance(Xa[i], Xb[np.asarray(cand)])
            for j, dj in zip(cand, dist):
                if dj < threshold:
                    ids_a.append(table_a[id_col][i])
                    ids_b.append(table_b[id_col][j])
                    dists.append(dj)
        return Table({"idA": np.asarray(ids_a), "idB": np.asarray(ids_b),
                      "distCol": np.asarray(dists, np.float64)})

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model",
                                  {"coefficients": self._coeff})

    @classmethod
    def load(cls, path: str, device="cuda") -> "MinHashLSHModel":
        model = super().load(path, device=device)
        model._coeff = persist.load_model_arrays(
            path, "model")["coefficients"].astype(np.int64)
        return model


class MinHashLSH(_OnDevice, MinHashLSHParams, Estimator[MinHashLSHModel]):
    """Draws the (a, b) coefficient pairs uniformly from [1, P) x [0, P)
    under ``seed`` — the model is data-independent (fit ignores row
    values, as in the Flink ML MinHashLSH)."""

    def fit(self, *inputs) -> MinHashLSHModel:
        rng = np.random.default_rng(self.get_seed())
        m = (self.get_num_hash_tables()
             * self.get_num_hash_functions_per_table())
        coeff = np.column_stack([
            rng.integers(1, _MINHASH_PRIME, size=m),
            rng.integers(0, _MINHASH_PRIME, size=m),
        ]).astype(np.int64)
        model = self._model_of(MinHashLSHModel)
        model._coeff = coeff
        return model
