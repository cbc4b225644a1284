"""Text/hashing feature stages: HashingTF, IDF, FeatureHasher, and
IndexToString (the StringIndexer inverse).

Members of the Flink ML 2.x feature surface.  Hashing uses a deterministic
FNV-1a over the value's string form (stable across runs and machines — a
requirement the reference family inherits from save/load).  The TF/IDF
scoring itself is device work: one elementwise scale of the
document-term matrix.

A port of the JAX package's ``models/feature/text.py``.  HashingTF,
FeatureHasher and IndexToString are host work and take no ``device``;
IDF and its model run on ``device`` (default ``"cuda"``; raises without a
card unless ``"cpu"`` is asked for).  ``IDFModel.transform`` rounds tf
and idf to f32, multiplies once and widens to f64, as the JAX package
does: one f32 multiply rounds the same on every device, so the output
equals the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...api.stage import Estimator, Model, Transformer
from ...data.table import Table
from ...params.param import BoolParam, IntParam, ParamValidators
from ...params.shared import (
    HasFeaturesCol,
    HasInputCols,
    HasOutputCol,
)
from ...utils import native_text, persist
from ...utils.device import resolve_device
from .transforms import _OnDevice

__all__ = ["HashingTF", "IDF", "IDFModel", "FeatureHasher", "IndexToString"]

_FNV_OFFSET = 14695981039346656037
_FNV_PRIME = 1099511628211
_FNV_MASK = (1 << 64) - 1


def _fnv1a(value) -> int:
    # Python-int arithmetic masked to 64 bits: identical wrap-around values
    # to uint64 hardware arithmetic, without numpy overflow warnings.
    h = _FNV_OFFSET
    for b in str(value).encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _FNV_MASK
    return h


class HashingTF(HasOutputCol, HasFeaturesCol, Transformer):
    """Token sequences -> fixed-size term-frequency vectors by hashing.
    Input column: one list/array of tokens per row."""

    NUM_FEATURES = IntParam("numFeatures", "Hash-space size.", default=256,
                            validator=ParamValidators.gt(0))
    BINARY = BoolParam("binary", "1/0 presence instead of counts.",
                       default=False)

    def get_num_features(self) -> int:
        return self.get(HashingTF.NUM_FEATURES)

    def set_num_features(self, value: int):
        return self.set(HashingTF.NUM_FEATURES, value)

    def set_binary(self, value: bool):
        return self.set(HashingTF.BINARY, value)

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        docs = table[self.get_features_col()]
        m = self.get_num_features()
        binary = self.get(HashingTF.BINARY)
        # native batch fill (bit-identical hashes); per-byte Python loop
        # only as the no-toolchain fallback
        out = native_text.hashing_tf(docs, m, binary)
        if out is None:
            out = np.zeros((len(docs), m), np.float64)
            for i, doc in enumerate(docs):
                for token in np.ravel(np.asarray(doc, dtype=object)):
                    out[i, _fnv1a(token) % m] += 1.0
            if binary:
                out = (out > 0).astype(np.float64)
        return [table.with_column(self.get_output_col(), out)]

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)

    @classmethod
    def load(cls, path: str) -> "HashingTF":
        return persist.load_stage_param(path)


def _idf_scale(tf: np.ndarray, idf: np.ndarray, device="cuda") -> np.ndarray:
    """``f64(f32(tf) * f32(idf)[None, :])`` with the product on
    ``device``."""
    dev = resolve_device(device)
    tf_t = torch.as_tensor(np.asarray(tf, np.float32), device=dev)
    idf_t = torch.as_tensor(np.asarray(idf, np.float32), device=dev)
    return (tf_t * idf_t[None, :]).cpu().numpy().astype(np.float64)


class IDFModel(_OnDevice, HasOutputCol, HasFeaturesCol, Model):
    def __init__(self, device="cuda"):
        super().__init__(device)
        self._idf: Optional[np.ndarray] = None

    def set_model_data(self, *inputs) -> "IDFModel":
        (t,) = inputs
        self._idf = np.asarray(t["idf"][0], np.float64)
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"idf": self._idf[None]})]

    def _require_model(self) -> None:
        if self._idf is None:
            raise RuntimeError("IDFModel has no model data; call "
                               "set_model_data() or fit an IDF first")

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        out = _idf_scale(table[self.get_features_col()], self._idf,
                         self.device)
        return [table.with_column(self.get_output_col(), out)]

    def save(self, path: str) -> None:
        self._require_model()
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {"idf": self._idf})

    @classmethod
    def load(cls, path: str, device="cuda") -> "IDFModel":
        model = super().load(path, device)
        model._idf = persist.load_model_arrays(
            path, "model")["idf"].astype(np.float64)
        return model


class IDF(_OnDevice, HasOutputCol, HasFeaturesCol, Estimator[IDFModel]):
    """Learns ``log((n_docs + 1) / (df + 1))`` per term column (on the
    host in float64, as the JAX package does); the model it returns
    scales on this stage's ``device``."""

    MIN_DOC_FREQ = IntParam("minDocFreq",
                            "Terms below this document frequency get idf 0.",
                            default=0, validator=ParamValidators.gt_eq(0))

    def set_min_doc_freq(self, value: int):
        return self.set(IDF.MIN_DOC_FREQ, value)

    def fit(self, *inputs) -> IDFModel:
        (table,) = inputs
        tf = np.asarray(table[self.get_features_col()], np.float64)
        df = (tf > 0).sum(axis=0)
        idf = np.log((len(tf) + 1.0) / (df + 1.0))
        idf[df < self.get(IDF.MIN_DOC_FREQ)] = 0.0
        model = self._model_of(IDFModel)
        model._idf = idf
        return model


class FeatureHasher(HasOutputCol, HasInputCols, Transformer):
    """Hash arbitrary columns into one fixed-size vector: numeric columns
    add their value at ``hash(colName)``, categorical/string columns add 1
    at ``hash(colName=value)`` (the classic hashing trick).

    With ``set_sparse_output(True)`` the transform never densifies: it emits
    the hashed PAIR columns ``{outputCol}_indices (n, n_cols) int32`` and
    ``{outputCol}_values (n, n_cols) float32`` — one active slot per input
    column — which the linear family scores directly against a dense weight
    (``models/common/linear.py::resolve_features``).  This is what makes
    2^20+ hash spaces (the Criteo shape) usable: the dense form would be an
    ``(n, 2^20)`` matrix.  Within-row slot collisions stay as separate pair
    entries; gather/scatter sums them, matching the dense semantics."""

    NUM_FEATURES = IntParam("numFeatures", "Hash-space size.", default=256,
                            validator=ParamValidators.gt(0))
    SPARSE_OUTPUT = BoolParam(
        "sparseOutput",
        "Emit {outputCol}_indices/{outputCol}_values pair columns instead "
        "of a dense matrix.", default=False)

    def get_num_features(self) -> int:
        return self.get(FeatureHasher.NUM_FEATURES)

    def set_num_features(self, value: int):
        return self.set(FeatureHasher.NUM_FEATURES, value)

    def set_sparse_output(self, value: bool):
        return self.set(FeatureHasher.SPARSE_OUTPUT, value)

    def _hash_columns(self, table: Table, in_cols, m: int):
        """Per input column: (slot indices (n,), float64 values (n,)).
        Categorical columns hash each distinct value once (np.unique +
        inverse) instead of per row.  Values stay float64 here; only the
        device-facing sparse pair output downcasts to f32."""
        n = table.num_rows
        idx_cols, val_cols = [], []
        for col in in_cols:
            values = np.asarray(table[col])
            if np.issubdtype(values.dtype, np.number):
                idx_cols.append(np.full((n,), _fnv1a(col) % m, np.int32))
                val_cols.append(values.astype(np.float64))
            else:
                uniq, inverse = np.unique(values, return_inverse=True)
                keys = [f"{col}={u}" for u in uniq]
                hashes = native_text.fnv1a_batch(keys)
                if hashes is None:
                    hashes = np.asarray([_fnv1a(k) for k in keys], np.uint64)
                slots = (hashes % np.uint64(m)).astype(np.int32)
                idx_cols.append(slots[inverse])
                val_cols.append(np.ones((n,), np.float64))
        return idx_cols, val_cols

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        in_cols = self.get_input_cols()
        if not in_cols:
            raise ValueError("FeatureHasher requires inputCols")
        m = self.get_num_features()
        idx_cols, val_cols = self._hash_columns(table, in_cols, m)
        out_col = self.get_output_col()
        if self.get(FeatureHasher.SPARSE_OUTPUT):
            return [table
                    .with_column(f"{out_col}_indices",
                                 np.stack(idx_cols, axis=1))
                    .with_column(f"{out_col}_values",
                                 np.stack(val_cols, axis=1)
                                 .astype(np.float32))]
        out = np.zeros((table.num_rows, m), np.float64)
        rows = np.arange(table.num_rows)
        for idx, vals in zip(idx_cols, val_cols):
            np.add.at(out, (rows, idx), vals)
        return [table.with_column(out_col, out)]

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)

    @classmethod
    def load(cls, path: str) -> "FeatureHasher":
        return persist.load_stage_param(path)


class IndexToString(HasOutputCol, HasFeaturesCol, Transformer):
    """Inverse of StringIndexer: dense ids -> original label values, using
    the labels array set via ``set_labels`` (or taken from a fitted
    StringIndexerModel's vocabulary)."""

    def __init__(self):
        super().__init__()
        self._labels: Optional[np.ndarray] = None

    def set_labels(self, labels) -> "IndexToString":
        self._labels = np.asarray(labels)
        return self

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        if self._labels is None:
            raise RuntimeError("IndexToString needs set_labels(...) first")
        idx = np.asarray(table[self.get_features_col()], np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self._labels)):
            raise ValueError(f"index out of range for {len(self._labels)} "
                             "labels")
        return [table.with_column(self.get_output_col(), self._labels[idx])]

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model", {"labels": self._labels
                                                  if self._labels is not None
                                                  else np.zeros(0)})

    @classmethod
    def load(cls, path: str) -> "IndexToString":
        stage = persist.load_stage_param(path)
        labels = persist.load_model_arrays(path, "model")["labels"]
        stage._labels = labels if len(labels) else None
        return stage
