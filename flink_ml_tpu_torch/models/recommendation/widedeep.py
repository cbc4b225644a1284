"""Wide&Deep two-tower recommender, trained with Adam on binary cross-entropy.

A wide linear tower over categorical ids and dense features, and a deep
tower of embeddings and an MLP.  One stacked embedding table
``(total_vocab, emb_dim)`` (per-field vocabularies offset into it) and one
``(total_vocab,)`` wide table; parameters and optimizer state stay on the
device between epochs, and the epoch loop (:func:`..iteration.iterate`)
never waits for it.

The in-memory dense-Adam ``fit`` routes the table gradients statically
(``ops/emb_grad.py``): the epoch tensor is replayed every epoch, so the
per-step slot -> row sort is built once per fit on the host, and each step
differentiates through the gathered rows (``torch.autograd.grad`` with the
rows as leaves), then folds and places the per-slot gradients itself. The
fold is the CUDA kernel of ``kernels/csrc/emb_grad.cu`` on the card whenever
``fold_passes >= 1``.  ``routedEmbeddingGrad='off'`` keeps autograd's
scatter-add; ``lazyEmbeddingOptimizer`` runs LazyAdam on the tables.  The
optimizers are written out in ``models/common/adam.py``.

A port of the JAX package's ``models/recommendation/widedeep.py``, single
device.  Not ported, each raising ``NotImplementedError`` naming its ROADMAP
queue: ``fit_outofcore`` (A3), ``build_sharded_train_step`` (A10) and the
chain terminal ``transform_kernel`` (A7).  Every stage runs on ``device``
(default ``"cuda"``; raises without a card unless ``"cpu"`` is asked for).
Matrix products run in full f32: the port never turns on
``torch.backends.cuda.matmul.allow_tf32`` (off by default), whose ~3
decimal digits would break the agreement with the JAX package.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...api.stage import Estimator, Model
from ...data.table import Table
from ...iteration import IterationBodyResult, IterationConfig, iterate
from ...ops.emb_grad import emb_grad_route
from ...params.param import (
    BoolParam,
    FloatParam,
    IntArrayParam,
    IntParam,
    ParamValidators,
    StringParam,
)
from ...params.shared import (
    HasGlobalBatchSize,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasRawPredictionCol,
    HasSeed,
)
from ...utils import persist
from ...utils.device import resolve_device
from ..common.adam import (
    adam_init,
    adam_update,
    lazy_adam_rows,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from ..common.losses import logistic_loss
from ..common.sgd import (
    DEFAULT_GLOBAL_BATCH,
    plan_epoch_layout,
    prepare_epoch_tensor,
)

__all__ = ["WideDeep", "WideDeepModel", "WideDeepParams", "init_params",
           "params_to_device", "forward_from_rows", "forward", "bce_loss",
           "build_reference_train_step", "build_sharded_train_step"]


def _not_ported(what: str, queue: str):
    return NotImplementedError(
        f"{what} is not ported to flink_ml_tpu_torch yet (ROADMAP queue "
        f"{queue})")


class WideDeepParams(HasLabelCol, HasPredictionCol, HasRawPredictionCol,
                     HasMaxIter, HasGlobalBatchSize, HasSeed):
    DENSE_FEATURES_COL = StringParam(
        "denseFeaturesCol", "Dense feature matrix column.",
        default="denseFeatures")
    CAT_FEATURES_COL = StringParam(
        "catFeaturesCol", "Categorical id matrix column (int).",
        default="catFeatures")
    VOCAB_SIZES = IntArrayParam(
        "vocabSizes", "Vocabulary size per categorical field.",
        default=None, validator=lambda v: v is None or (len(v) > 0 and
                                                        all(s > 0 for s in v)))
    EMBEDDING_DIM = IntParam("embeddingDim", "Embedding width per field.",
                             default=8, validator=ParamValidators.gt(0))
    HIDDEN_UNITS = IntArrayParam("hiddenUnits", "Deep-tower MLP widths.",
                                 default=(64, 32))
    LEARNING_RATE = FloatParam("learningRate", "Adam learning rate.",
                               default=1e-2, validator=ParamValidators.gt(0))
    LAZY_EMB_OPT = BoolParam(
        "lazyEmbeddingOptimizer",
        "LazyAdam for the embedding/wide-cat tables: Adam state and "
        "parameters update only at the rows each batch touches; untouched "
        "rows keep param AND optimizer state exactly (no momentum tail) — "
        "the standard LazyAdam semantic deviation from dense Adam.",
        default=False)
    ROUTED_EMB_GRAD = StringParam(
        "routedEmbeddingGrad",
        "Statically-routed table gradients (ops/emb_grad.py) for the "
        "dense-Adam fit: the per-step slot->row sort is computed once on "
        "the host and every step's table scatter becomes a permutation "
        "gather, a segmented fold and a placement gather.  Results equal "
        "the scatter-add up to f32 summation order.  'auto' (default) = on "
        "for the in-memory dense-Adam fit(), off under "
        "lazyEmbeddingOptimizer; 'on' forces it (error if lazy); 'off' "
        "keeps autograd's scatter-add.",
        default="auto",
        validator=ParamValidators.in_array(("auto", "on", "off")))

    def get_vocab_sizes(self):
        return self.get(WideDeepParams.VOCAB_SIZES)

    def set_vocab_sizes(self, v):
        return self.set(WideDeepParams.VOCAB_SIZES, v)


def _field_offsets(vocab_sizes) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32)


def init_params(rng: np.random.Generator, d_dense: int, vocab_sizes,
                emb_dim: int, hidden) -> Dict[str, Any]:
    """Host numpy parameters: the JAX package's draws, in its order, from
    the same generator."""
    total_vocab = int(np.sum(vocab_sizes))
    n_fields = len(vocab_sizes)
    deep_in = d_dense + n_fields * emb_dim
    layers = []
    fan_in = deep_in
    for h in list(hidden) + [1]:
        scale = np.sqrt(2.0 / fan_in)
        layers.append({
            "w": (rng.normal(size=(fan_in, h)) * scale).astype(np.float32),
            "b": np.zeros((h,), np.float32),
        })
        fan_in = h
    return {
        "wide_cat": np.zeros((total_vocab,), np.float32),
        "wide_dense": np.zeros((d_dense,), np.float32),
        "wide_b": np.zeros((), np.float32),
        "emb": (rng.normal(size=(total_vocab, emb_dim)) * 0.05
                ).astype(np.float32),
        "mlp": layers,
    }


def params_to_device(params, device) -> Dict[str, Any]:
    """A parameter tree of numpy arrays as f32 tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        device), params)


def _params_to_host(params) -> Dict[str, Any]:
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def forward_from_rows(params: Dict[str, Any], dense: torch.Tensor,
                      wide_rows: torch.Tensor, emb_rows: torch.Tensor
                      ) -> torch.Tensor:
    """Logits from already-gathered table rows (``wide_rows (b, fields)``,
    ``emb_rows (b, fields, emb)``); ``params`` needs only the non-table
    leaves.  The routed step differentiates through the rows."""
    wide = (dense @ params["wide_dense"] + torch.sum(wide_rows, dim=1)
            + params["wide_b"])
    deep = torch.cat([dense, emb_rows.reshape(emb_rows.shape[0], -1)], dim=1)
    n = len(params["mlp"])
    for i, layer in enumerate(params["mlp"]):
        deep = deep @ layer["w"] + layer["b"]
        if i + 1 < n:
            deep = torch.relu(deep)
    return wide + deep[:, 0]


def _rows(table: torch.Tensor, cat_ids: torch.Tensor) -> torch.Tensor:
    """``table[cat_ids]`` for ``cat_ids (b, fields)``."""
    got = torch.index_select(table, 0, cat_ids.reshape(-1))
    return got.reshape(*cat_ids.shape, *table.shape[1:])


def forward(params: Dict[str, Any], dense: torch.Tensor,
            cat_ids: torch.Tensor) -> torch.Tensor:
    """Logits for a batch; ``cat_ids`` are already offset into the stacked
    vocab (``(batch, n_fields)``)."""
    return forward_from_rows(params, dense, _rows(params["wide_cat"], cat_ids),
                             _rows(params["emb"], cat_ids))


def bce_loss(params, dense, cat_ids, labels, mask):
    """The linear family's masked binary log-loss of :func:`forward`."""
    return logistic_loss(forward(params, dense, cat_ids), labels, mask)


def _validate_cat_ids(cat: np.ndarray, vocab_sizes) -> np.ndarray:
    """Range-check raw per-field ids, then offset into the stacked vocab
    (both ``fit`` and ``transform``)."""
    if cat.shape[1] != len(vocab_sizes):
        raise ValueError(
            f"catFeatures has {cat.shape[1]} fields, vocabSizes has "
            f"{len(vocab_sizes)}")
    if np.any(cat < 0) or np.any(cat >= np.asarray(vocab_sizes)[None, :]):
        raise ValueError("categorical id out of vocab range")
    return cat + _field_offsets(vocab_sizes)[None, :]


def _value_and_grad(fn, *trees):
    """``(fn(*trees), grads)`` with one gradient tree per input tree."""
    with torch.enable_grad():
        leaves = [tree_map(lambda t: t.detach().requires_grad_(True), tr)
                  for tr in trees]
        value = fn(*leaves)
        flat = [x for tr in leaves for x in tree_leaves(tr)]
        grads = torch.autograd.grad(value, flat)
    out, i = [], 0
    for tr in leaves:
        n = len(tree_leaves(tr))
        out.append(tree_unflatten(tr, grads[i:i + n]))
        i += n
    return value.detach(), out


# embedding-shaped tables whose per-step gradient support is the batch's
# id set — the lazy optimizer updates only those rows
_LAZY_TABLE_KEYS = ("emb", "wide_cat")


def _split(tree):
    tables = {k: tree[k] for k in _LAZY_TABLE_KEYS}
    rest = {k: v for k, v in tree.items() if k not in _LAZY_TABLE_KEYS}
    return tables, rest


def _make_train_ops(params, lr: float, lazy: bool, route=None,
                    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                    plain: bool = False):
    """``(batch_step, opt_state0)`` for the Wide&Deep training loop;
    ``batch_step(params, opt_state, dense, cat_ids, labels, mask,
    *route_arrays) -> (params, opt_state, loss)``.

    ``lazy=False``: dense Adam over every parameter.  With ``route`` (an
    :class:`~flink_ml_tpu_torch.ops.emb_grad.EmbGradRoute` on the params'
    device, dense Adam only) the step takes one step's route tensors and
    forms the table gradients by the routed fold and placement instead of
    autograd's scatter-add; all other gradients and the Adam update are
    the same.  ``plain`` folds with the plain version (for comparisons on
    the card).

    ``lazy=True``: LazyAdam on the tables (``lazy_adam_rows``, at the rows
    of the batch's unmasked samples; one host read per step to drop the
    masked ones), dense Adam on the rest, with its own step count.  Rows
    a batch does not touch keep param AND optimizer state exactly."""
    if route is not None:
        if lazy:
            raise ValueError(
                "routed table gradients are a dense-Adam path; disable "
                "lazyEmbeddingOptimizer or set routedEmbeddingGrad='off'")

        def batch_step(params, opt_state, dense, cat_ids, labels, mask,
                       *route_arrays):
            _, rest = _split(params)
            emb_rows = _rows(params["emb"], cat_ids)
            wide_rows = _rows(params["wide_cat"], cat_ids)

            def loss_rows(rest, emb_rows, wide_rows):
                return logistic_loss(
                    forward_from_rows(rest, dense, wide_rows, emb_rows),
                    labels, mask)

            loss, (g_rest, g_emb, g_wide) = _value_and_grad(
                loss_rows, rest, emb_rows, wide_rows)
            emb_dim = emb_rows.shape[-1]
            grads = {
                **g_rest,
                "emb": route.apply(g_emb.reshape(-1, emb_dim), *route_arrays,
                                   plain=plain),
                "wide_cat": route.apply(g_wide.reshape(-1), *route_arrays,
                                        plain=plain),
            }
            params, opt_state = adam_update(grads, opt_state, params, lr,
                                            b1, b2, eps)
            return params, opt_state, loss

        return batch_step, adam_init(params)
    if not lazy:
        def batch_step(params, opt_state, dense, cat_ids, labels, mask):
            loss, (grads,) = _value_and_grad(
                lambda p: bce_loss(p, dense, cat_ids, labels, mask), params)
            params, opt_state = adam_update(grads, opt_state, params, lr,
                                            b1, b2, eps)
            return params, opt_state, loss

        return batch_step, adam_init(params)

    tables0, rest0 = _split(params)
    opt_state0 = {
        "rest": adam_init(rest0),
        "m": tree_map(torch.zeros_like, tables0),
        "v": tree_map(torch.zeros_like, tables0),
        "t": 0,
    }

    def batch_step(params, opt_state, dense, cat_ids, labels, mask):
        loss, (grads,) = _value_and_grad(
            lambda p: bce_loss(p, dense, cat_ids, labels, mask), params)
        tables, rest = _split(params)
        g_tab, g_rest = _split(grads)
        rest, rest_state = adam_update(g_rest, opt_state["rest"], rest, lr,
                                       b1, b2, eps)
        t = opt_state["t"] + 1
        # weight-0 rows (epoch padding) must not count as touched: their
        # ids are dropped before the update (the JAX step sends them out of
        # range so its scatters drop them)
        ids = cat_ids[mask > 0].reshape(-1).long()
        for k in _LAZY_TABLE_KEYS:
            lazy_adam_rows(tables[k], opt_state["m"][k], opt_state["v"][k],
                           g_tab[k], ids, t, lr, b1, b2, eps)
        new_state = {"rest": rest_state, "m": opt_state["m"],
                     "v": opt_state["v"], "t": t}
        return {**rest, **tables}, new_state, loss

    return batch_step, opt_state0


def build_reference_train_step(d_dense: int, vocab_sizes, emb_dim: int,
                               hidden, lr: float = 1e-2,
                               lazy_embeddings: bool = False, route=None,
                               device="cuda"):
    """The single-device step of ``WideDeep.fit`` from the JAX package's
    reference init (numpy seed 0): ``(train_step, params, opt_state)``.
    ``route`` (on ``device``) swaps in the routed table gradients; the step
    then takes one step's route tensors."""
    dev = resolve_device(device)
    params = params_to_device(
        init_params(np.random.default_rng(0), d_dense, vocab_sizes, emb_dim,
                    hidden), dev)
    batch_step, opt_state = _make_train_ops(params, lr, lazy_embeddings,
                                            route=route)
    return batch_step, params, opt_state


def build_sharded_train_step(*args, **kwargs):
    raise _not_ported("the sharded Wide&Deep step (and its compressed "
                      "gradient reduction)", "A10")


class WideDeep(WideDeepParams, Estimator["WideDeepModel"]):
    """fit(table with denseFeatures (n,d) float, catFeatures (n,f) int,
    label (n,) {0,1}).  After a routed fit, ``route_info`` holds the
    route's placement, ``fold_passes``, steps, slots per step and host
    build seconds (None for an unrouted fit)."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self.route_info: Optional[dict] = None

    def fit(self, *inputs, plain: bool = False) -> "WideDeepModel":
        """``plain`` folds the routed gradients with the plain version
        instead of the kernel (for comparisons on the card)."""
        (table,) = inputs
        vocab_sizes = self.get_vocab_sizes()
        if vocab_sizes is None:
            raise ValueError("WideDeep requires vocabSizes to be set")
        dev = resolve_device(self.device)
        self.route_info = None

        dense = np.asarray(table[self.DENSE_FEATURES_COL], np.float32)
        cat = np.asarray(table[self.CAT_FEATURES_COL], np.int32)
        labels = np.asarray(table[self.get_label_col()], np.float32)
        cat = _validate_cat_ids(cat, vocab_sizes)

        n = dense.shape[0]
        steps, batch, perm = plan_epoch_layout(
            n, self.get_global_batch_size() or DEFAULT_GLOBAL_BATCH, 1,
            self.get_seed())

        def layout(arr):
            return prepare_epoch_tensor(arr, perm, steps, batch)

        def put(arr):
            return torch.from_numpy(arr).to(dev)

        mask = layout(np.ones((n,), np.float32))
        C = layout(cat)
        data = (put(layout(dense)), put(C), put(layout(labels)), put(mask))

        lazy = bool(self.LAZY_EMB_OPT)
        routed_mode = self.get(WideDeepParams.ROUTED_EMB_GRAD)
        route = None
        if routed_mode == "on" or (routed_mode == "auto" and not lazy):
            # the epoch tensor C is replayed every epoch, so the slot->row
            # sort is static: built once here on the host ("auto": gather
            # until the inverse map outgrows its budget, then scatter)
            t0 = time.perf_counter()
            route = emb_grad_route(C, int(np.sum(vocab_sizes)),
                                   placement="auto")
            build_s = time.perf_counter() - t0
            route = route.to(dev)
            self.route_info = {
                "placement": route.placement,
                "fold_passes": route.fold_passes, "steps": steps,
                "slots_per_step": int(route.order.shape[1]),
                "build_s": build_s}
            data += route.stacked_arrays()

        rng = np.random.default_rng(self.get_seed() + 1)  # init-draw stream
        params = params_to_device(
            init_params(rng, dense.shape[1], vocab_sizes,
                        self.EMBEDDING_DIM, self.HIDDEN_UNITS), dev)
        step_fn, opt_state = _make_train_ops(
            params, self.LEARNING_RATE, lazy, route=route, plain=plain)

        def epoch_body(state, epoch, data):
            Xd, Cd, yd, md = data[:4]
            rt = data[4:]
            params, opt_state, loss_log = state
            losses = []
            for i in range(steps):
                params, opt_state, loss = step_fn(
                    params, opt_state, Xd[i], Cd[i], yd[i], md[i],
                    *(a[i] for a in rt))
                losses.append(loss)
            # stays on the device: the loop never waits for it
            loss_log[epoch] = torch.stack(losses).mean()
            return IterationBodyResult((params, opt_state, loss_log))

        max_epochs = self.get_max_iter()
        init_state = (params, opt_state,
                      torch.full((max_epochs,), float("nan"), device=dev))
        result = iterate(epoch_body, init_state, data, max_epochs=max_epochs,
                         config=IterationConfig(mode="fused"))
        fitted, _, loss_buf = result.state

        model = WideDeepModel(device=self.device)
        model.copy_params_from(self)
        model._params = _params_to_host(fitted)
        model._vocab_sizes = tuple(int(v) for v in vocab_sizes)
        model._loss_log = list(loss_buf.cpu().numpy())
        return model

    def fit_outofcore(self, make_reader, **kwargs) -> "WideDeepModel":
        raise _not_ported("the out-of-core Wide&Deep fit", "A3")

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "WideDeep":
        stage = persist.load_stage_param(path)
        stage.device = device
        return stage


class WideDeepModel(WideDeepParams, Model):
    """Scores: ``sigmoid(forward)`` as the raw prediction (float64) and
    ``score > 0.5`` as the prediction (int64)."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self._params: Optional[Dict[str, Any]] = None
        self._vocab_sizes: Optional[Tuple[int, ...]] = None
        self._loss_log: List[float] = []

    @property
    def loss_log(self) -> List[float]:
        """Per-epoch mean training loss."""
        return list(self._loss_log)

    def _require_model(self):
        if self._params is None:
            raise RuntimeError("WideDeepModel has no model data")

    def transform_kernel(self, schema):
        raise _not_ported("the chain-fused Wide&Deep transform", "A7")

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        self._require_model()
        dev = resolve_device(self.device)
        dense = np.asarray(table[self.DENSE_FEATURES_COL], np.float32)
        cat = np.asarray(table[self.CAT_FEATURES_COL], np.int32)
        cat = _validate_cat_ids(cat, self._vocab_sizes)
        params = params_to_device(self._params, dev)
        with torch.no_grad():
            scores = torch.sigmoid(forward(
                params, torch.from_numpy(np.ascontiguousarray(dense)).to(dev),
                torch.from_numpy(np.ascontiguousarray(cat)).to(dev)))
        scores = scores.cpu().numpy().astype(np.float64)
        out = table.with_column(self.get_raw_prediction_col(), scores)
        out = out.with_column(self.get_prediction_col(),
                              (scores > 0.5).astype(np.int64))
        return [out]

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """The JAX package's layout: a saved model loads in either."""
        self._require_model()
        persist.save_metadata(
            self, path, {"vocabSizes": list(self._vocab_sizes)})
        flat = {"wide_cat": self._params["wide_cat"],
                "wide_dense": self._params["wide_dense"],
                "wide_b": self._params["wide_b"],
                "emb": self._params["emb"]}
        for i, layer in enumerate(self._params["mlp"]):
            flat[f"mlp_{i}_w"] = layer["w"]
            flat[f"mlp_{i}_b"] = layer["b"]
        persist.save_model_arrays(path, "model", flat)

    @classmethod
    def load(cls, path: str, device="cuda") -> "WideDeepModel":
        """Load a model saved by this package or by the JAX package."""
        model = persist.load_stage_param(path)
        if not isinstance(model, cls):
            raise IOError(f"Stage at {path} is a {type(model).__name__}, "
                          f"not a {cls.__name__}")
        model.device = device
        meta = persist.load_metadata(path)
        data = persist.load_model_arrays(path, "model")
        n_layers = sum(1 for k in data if k.endswith("_w"))
        model._params = {
            "wide_cat": data["wide_cat"],
            "wide_dense": data["wide_dense"],
            "wide_b": data["wide_b"],
            "emb": data["emb"],
            "mlp": [{"w": data[f"mlp_{i}_w"], "b": data[f"mlp_{i}_b"]}
                    for i in range(n_layers)],
        }
        model._vocab_sizes = tuple(meta["vocabSizes"])
        return model
