"""Categorical encoders + column assembly: StringIndexer, OneHotEncoder,
VectorAssembler — the feature-prep stages that feed the linear family and
Wide&Deep (string -> index -> one-hot / stacked cat ids).

Vocabularies are fitted and the standalone transforms run on the host
(string columns never reach the device); inside a fused segment
(``api/chain.py``) the numeric lookups, the one-hot expansion and the
assembly run on ``device`` (default ``"cuda"``).

A port of the JAX package's ``models/feature/encoders.py``.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List

import numpy as np
import torch

from ...api.chain import StageKernel, numeric_entry
from ...api.stage import Estimator, Model, Transformer
from ...data.table import Table
from ...params.param import BoolParam, StringParam
from ...params.shared import HasFeaturesCol, HasInputCols, HasOutputCols
from ...utils import persist
from .transforms import _OnDevice

__all__ = ["StringIndexer", "StringIndexerModel", "OneHotEncoder",
           "OneHotEncoderModel", "VectorAssembler"]


class _ColsParams(HasInputCols, HasOutputCols):
    """Both-columns mixin shared by the multi-column feature stages."""


def _check_cols(stage) -> tuple:
    in_cols, out_cols = stage.get_input_cols(), stage.get_output_cols()
    if not in_cols:
        raise ValueError(f"{type(stage).__name__} requires inputCols")
    out_cols = out_cols or tuple(f"{c}_out" for c in in_cols)
    if len(out_cols) != len(in_cols):
        raise ValueError("inputCols and outputCols lengths differ")
    return in_cols, out_cols


class StringIndexerModel(_OnDevice, _ColsParams, Model):
    """Maps string/any values to dense int ids by fitted vocabulary;
    unseen values -> len(vocab) (the "keep" policy) or error."""

    HANDLE_INVALID = StringParam(
        "handleInvalid", "Unseen-value policy.", default="keep",
        validator=lambda v: v in ("keep", "error"))

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._vocab: Dict[str, List] = {}

    def set_model_data(self, *inputs) -> "StringIndexerModel":
        (t,) = inputs
        self._vocab = {name: list(t[name]) for name in t.column_names}
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({k: np.asarray(v) for k, v in self._vocab.items()})]

    def vocab_sizes(self) -> List[int]:
        in_cols, _ = _check_cols(self)
        return [len(self._vocab[c]) for c in in_cols]

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        in_cols, out_cols = _check_cols(self)
        policy = self.get(StringIndexerModel.HANDLE_INVALID)
        out = table
        for ic, oc in zip(in_cols, out_cols):
            vocab_arr = np.asarray(self._vocab[ic])
            column = np.asarray(table[ic])
            # promote BOTH sides to the wider dtype — casting the column to
            # the vocab's fixed-width string dtype would silently truncate
            # longer unseen values onto vocab prefixes
            joint = np.promote_types(vocab_arr.dtype, column.dtype)
            vocab_arr = vocab_arr.astype(joint, copy=False)
            column = column.astype(joint, copy=False)
            # vectorized lookup: searchsorted over the sorted vocab, mapped
            # back to fitted (frequency-ordered) ids
            order = np.argsort(vocab_arr, kind="stable")
            sorted_vocab = vocab_arr[order]
            pos = np.searchsorted(sorted_vocab, column)
            pos_clipped = np.minimum(pos, len(vocab_arr) - 1)
            found = sorted_vocab[pos_clipped] == column
            if policy == "error" and not found.all():
                missing = column[~found][0]
                raise ValueError(f"Unseen value {missing!r} in column {ic!r}")
            ids = np.where(found, order[pos_clipped], len(vocab_arr)
                           ).astype(np.int64)
            out = out.with_column(oc, ids)
        return [out]

    def transform_kernel(self, schema):
        """Chain kernel for NUMERIC vocabularies (the post-discretization
        re-indexing case): the sorted-vocab searchsorted lookup runs
        in-device with the fitted-order id mapping precomputed at chain
        build.  String/object domains and the ``error`` policy stay
        stagewise (string columns cannot live on device; the raise is
        host control flow).  f64 columns decline (``exact_compare``):
        the lookup is a vocabulary-equality decision, and segment-entry
        rounding could land an unseen f64 value exactly on a vocab entry
        the host-f64 compare rejects."""
        if self.get(StringIndexerModel.HANDLE_INVALID) != "keep":
            return None
        in_cols, out_cols = _check_cols(self)
        vals_list, fid_list, exact_list, unseen = [], [], [], []
        for ic in in_cols:
            entry = numeric_entry(schema, ic, exact_compare=True)
            if entry is None or entry[0]:
                return None          # non-numeric/f64 or non-scalar column
            vocab = np.asarray(self._vocab[ic])
            if vocab.dtype.kind not in "fiub":
                return None          # string-domain vocabulary
            vocab = vocab.astype(np.float64)
            order = np.argsort(vocab, kind="stable")
            sorted_vals = vocab[order]
            v32 = sorted_vals.astype(np.float32)
            if len(v32) > 1 and np.any(np.diff(v32) <= 0):
                return None          # f32 collision: ambiguous lookup
            vals_list.append(v32)
            fid_list.append(order.astype(np.int32))
            exact_list.append(
                (v32.astype(np.float64) == sorted_vals).astype(np.float32))
            unseen.append(np.int32(len(vocab)))
        return StageKernel(
            fn=_string_indexer_kernel,
            static=(tuple(zip(in_cols, out_cols)),),
            params={"vals": vals_list, "fid": fid_list,
                    "exact": exact_list, "unseen": unseen},
            consumes=tuple(in_cols), produces=tuple(out_cols),
            device=self.device)

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)
        persist.save_model_arrays(
            path, "model", {k: np.asarray(v) for k, v in self._vocab.items()})

    @classmethod
    def load(cls, path: str, device="cuda") -> "StringIndexerModel":
        model = super().load(path, device)
        data = persist.load_model_arrays(path, "model")
        model._vocab = {k: list(v) for k, v in data.items()}
        return model


def _string_indexer_kernel(static, params, cols):
    (pairs,) = static
    out = {}
    for i, (ic, oc) in enumerate(pairs):
        x = cols[ic].to(torch.float32)
        vals, fid = params["vals"][i], params["fid"][i]
        pos = torch.sum(x[:, None] >= vals[None, :], dim=-1) - 1
        pos_c = torch.clamp(pos, 0, vals.shape[0] - 1)
        hit = (vals[pos_c] == x) & (params["exact"][i][pos_c] > 0)
        out[oc] = torch.where(hit, fid[pos_c], params["unseen"][i]
                              ).to(torch.int32)
    return out


class StringIndexer(_OnDevice, _ColsParams, Estimator[StringIndexerModel]):
    """Vocabulary ordering follows ``stringOrderType`` (the Flink ML
    StringIndexer param): frequencyDesc (default; ties by value
    ascending), frequencyAsc, alphabetAsc, alphabetDesc."""

    STRING_ORDER_TYPE = StringParam(
        "stringOrderType",
        "frequencyDesc | frequencyAsc | alphabetAsc | alphabetDesc.",
        default="frequencyDesc",
        validator=lambda v: v in ("frequencyDesc", "frequencyAsc",
                                  "alphabetAsc", "alphabetDesc"))

    def get_string_order_type(self) -> str:
        return self.get(StringIndexer.STRING_ORDER_TYPE)

    def set_string_order_type(self, value: str):
        return self.set(StringIndexer.STRING_ORDER_TYPE, value)

    def fit(self, *inputs) -> StringIndexerModel:
        (table,) = inputs
        in_cols, _ = _check_cols(self)
        order_type = self.get_string_order_type()
        model = self._model_of(StringIndexerModel)
        for col in in_cols:
            # np.unique returns values already ascending-sorted, so the
            # alphabet orders are identity / reverse
            values, counts = np.unique(table[col], return_counts=True)
            if order_type == "frequencyDesc":
                order = np.lexsort((values, -counts))
            elif order_type == "frequencyAsc":
                order = np.lexsort((values, counts))
            elif order_type == "alphabetAsc":
                order = np.arange(len(values))
            else:                                   # alphabetDesc
                order = np.arange(len(values))[::-1]
            model._vocab[col] = [values[i].item() if hasattr(values[i], "item")
                                 else values[i] for i in order]
        return model


class OneHotEncoderParams(_ColsParams):
    DROP_LAST = BoolParam("dropLast", "Drop the last category column.",
                          default=True)
    HANDLE_INVALID = StringParam(
        "handleInvalid", "Out-of-range id policy: 'error' raises, 'keep' "
        "emits an all-zeros row (matches StringIndexer's unseen->len(vocab) "
        "ids).", default="error",
        validator=lambda v: v in ("keep", "error"))


class OneHotEncoderModel(_OnDevice, OneHotEncoderParams, Model):
    def __init__(self, device="cuda"):
        super().__init__(device)
        self._sizes: Dict[str, int] = {}

    def set_model_data(self, *inputs) -> "OneHotEncoderModel":
        (t,) = inputs
        self._sizes = {name: int(t[name][0]) for name in t.column_names}
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({k: np.asarray([v]) for k, v in self._sizes.items()})]

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        in_cols, out_cols = _check_cols(self)
        drop = self.get(OneHotEncoderParams.DROP_LAST)
        out = table
        keep = self.get(OneHotEncoderParams.HANDLE_INVALID) == "keep"
        for ic, oc in zip(in_cols, out_cols):
            size = self._sizes[ic]
            ids = np.asarray(table[ic], np.int64)
            if np.any(ids < 0) or (not keep and np.any(ids >= size)):
                raise ValueError(f"id out of range [0, {size}) in {ic!r}")
            width = size - 1 if drop else size
            hot = np.zeros((len(ids), width), np.float64)
            in_range = ids < width  # dropped-last and invalid ids -> zeros
            hot[np.nonzero(in_range)[0], ids[in_range]] = 1.0
            out = out.with_column(oc, hot)
        return [out]

    def transform_kernel(self, schema):
        """Chainable under ``handleInvalid="keep"``: too-LARGE ids one-hot
        to all-zero rows in-device, exactly the stagewise keep semantics.
        Negative ids raise on host even under keep, so a ``pre`` hook
        carries that check into the segment (the ``error`` policy's
        any-out-of-range raise stays host control flow — non-chainable)."""
        if self.get(OneHotEncoderParams.HANDLE_INVALID) != "keep":
            return None
        in_cols, out_cols = _check_cols(self)
        drop = self.get(OneHotEncoderParams.DROP_LAST)
        specs = []
        for ic, oc in zip(in_cols, out_cols):
            entry = schema.get(ic)
            if entry is None or entry[1].kind not in "iub" or entry[0]:
                return None          # ids must be scalar integer columns
            size = self._sizes[ic]
            specs.append((ic, oc, size - 1 if drop else size))
        sizes = tuple((ic, self._sizes[ic]) for ic in in_cols)
        return StageKernel(
            fn=_onehot_kernel, static=(tuple(specs),), params={},
            consumes=tuple(in_cols), produces=tuple(out_cols),
            pre=partial(_onehot_pre, sizes), pre_cols=tuple(in_cols),
            device=self.device)

    def save(self, path: str) -> None:
        persist.save_metadata(self, path, {"sizes": self._sizes})

    @classmethod
    def load(cls, path: str, device="cuda") -> "OneHotEncoderModel":
        model = super().load(path, device)
        meta = persist.load_metadata(path)
        model._sizes = {k: int(v) for k, v in meta["sizes"].items()}
        return model


def _onehot_pre(col_sizes, host):
    """Host entry validation: the stagewise keep path still raises on a
    NEGATIVE id (only too-large ids zero out) — the fused path must too,
    not silently emit a zero row."""
    for ic, size in col_sizes:
        ids = host[ic]
        if ids.size and int(ids.min()) < 0:
            raise ValueError(f"id out of range [0, {size}) in {ic!r}")


def _onehot_kernel(static, params, cols):
    (specs,) = static
    out = {}
    for ic, oc, width in specs:
        ids = cols[ic]
        out[oc] = (ids[:, None] == torch.arange(width, device=ids.device)
                   [None, :]).to(torch.float32)
    return out


def _assembler_kernel(static, params, cols):
    in_cols, ocol = static
    parts = []
    for name in in_cols:
        arr = cols[name].to(torch.float32)
        parts.append(arr[:, None] if arr.ndim == 1 else arr)
    return {ocol: torch.cat(parts, dim=1)}


class OneHotEncoder(_OnDevice, OneHotEncoderParams,
                    Estimator[OneHotEncoderModel]):
    """Category count per column = max id + 1 over the fit data."""

    def fit(self, *inputs) -> OneHotEncoderModel:
        (table,) = inputs
        in_cols, _ = _check_cols(self)
        model = self._model_of(OneHotEncoderModel)
        for col in in_cols:
            ids = np.asarray(table[col], np.int64)
            if ids.min() < 0:
                raise ValueError(f"negative ids in column {col!r}")
            model._sizes[col] = int(ids.max()) + 1
        return model


class VectorAssembler(_OnDevice, _ColsParams, HasFeaturesCol, Transformer):
    """Concatenate scalar/vector columns into one dense feature matrix
    (output column = featuresCol)."""

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        in_cols = self.get_input_cols()
        if not in_cols:
            raise ValueError("VectorAssembler requires inputCols")
        parts = []
        for col in in_cols:
            arr = np.asarray(table[col], np.float64)
            parts.append(arr[:, None] if arr.ndim == 1 else arr)
        stacked = np.concatenate(parts, axis=1)
        return [table.with_column(self.get_features_col(), stacked)]

    def transform_kernel(self, schema):
        """Chain kernel: concatenation is value-exact at f32 for every
        f32-exact input, so the fused path matches stagewise bit-exactly."""
        in_cols = self.get_input_cols()
        if not in_cols:
            return None      # stagewise raises the diagnostic error
        for name in in_cols:
            if numeric_entry(schema, name) is None:
                return None
        return StageKernel(
            fn=_assembler_kernel,
            static=(tuple(in_cols), self.get_features_col()),
            params={},
            consumes=tuple(in_cols),
            produces=(self.get_features_col(),), device=self.device)
