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
``fold_passes >= 1``.  ``routedEmbeddingGrad='off'`` takes the table
gradients from autograd's scatter-add; ``lazyEmbeddingOptimizer`` runs
LazyAdam on the tables.  The optimizers are written out in
``models/common/adam.py``.

Every fit without the route (``'off'``, lazy, and the streamed
``fit_outofcore``) gathers the table rows through
:class:`_FixedOrderRows`, whose backward sums each row's gradient in one
fixed order on the card too (``sgd._scatter_add_``): autograd's own
``index_select`` backward adds with atomics in no fixed order there, and a
fit promises the same bits run after run (the streamed fit also for any
``steps_per_dispatch`` and after a resume).

Over ranks (one process a device, ``parallel/``): ``fit`` on a process
group's mesh is data parallel (:func:`_make_group_train_ops`: the global
step's slot gradient rows gathered in rank order and folded by B7 on every
rank); ``fit_outofcore(mesh=)`` streams each rank's shard, and
``fit_outofcore(membership=)`` trains an elastic fleet's shares of the
global batch; :func:`build_sharded_train_step` is the JAX package's dp x tp
step on a ``("data", "model")`` mesh (Megatron's pairs of differentiable
collectives, ``parallel/collectives.py``), exact or with a compressed
dense-tower reduction.

A port of the JAX package's ``models/recommendation/widedeep.py``.
``WideDeepModel.transform`` and the chain terminal (``transform_kernel``,
``api/chain.py``) run one function on one padded shape.  Every stage runs
on ``device`` (default ``"cuda"``; raises without a card unless ``"cpu"``
is asked for).
Matrix products run in full f32: the port never turns on
``torch.backends.cuda.matmul.allow_tf32`` (off by default), whose ~3
decimal digits would break the agreement with the JAX package.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...api.chain import (StageKernel, apply_kernel_or_none, numeric_entry,
                          run_normalized)
from ...api.stage import Estimator, Model
from ...data.table import Table
from ...iteration import IterationBodyResult, IterationConfig, iterate
from ...obs.trace import null_span, tracer
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
from ...utils.padding import FixedRowBatcher
from ...utils.row_tiles import in_row_tiles
from ..common.adam import (
    AdamState,
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
    _reader_for_epoch,
    _scatter_add_,
    _seek_or_skip,
    plan_epoch_layout,
    prepare_epoch_tensor,
)

__all__ = ["WideDeep", "WideDeepModel", "WideDeepParams", "init_params",
           "params_to_device", "forward_from_rows", "scores_from_rows",
           "forward", "bce_loss",
           "build_reference_train_step", "build_sharded_train_step",
           "assert_sharded_matches_reference", "param_spec", "shard_params",
           "gather_sharded_params"]


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


def scores_from_rows(params: Dict[str, Any], dense: torch.Tensor,
                     wide_rows: torch.Tensor, emb_rows: torch.Tensor
                     ) -> torch.Tensor:
    """``sigmoid(forward_from_rows)``, the scores of ``transform``, the
    chain terminal and serving, in row tiles of one shape
    (``utils/row_tiles.py``): at the bench width cuBLAS gives a row other
    bits in a batch of 8 rows than in one of 64
    (``scripts/serving_bucket_bits.py``), and a served request must equal
    the offline transform of its rows."""
    return in_row_tiles(
        lambda d, w, e: torch.sigmoid(forward_from_rows(params, d, w, e)),
        dense, wide_rows, emb_rows)


class _FixedOrderRows(torch.autograd.Function):
    """``table[ids]`` whose backward sums the gradient rows of repeated
    ids in one fixed order (``sgd._scatter_add_``, the
    sort-based accumulation on the card; ``index_add_`` on the CPU, the
    same serial loop as autograd's own backward there)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return torch.index_select(table, 0, ids)

    @staticmethod
    def backward(ctx, grad_rows):
        (ids,) = ctx.saved_tensors
        grad = grad_rows.new_zeros(ctx.table_shape)
        return _scatter_add_(grad, ids, grad_rows.contiguous()), None


def _rows(table: torch.Tensor, cat_ids: torch.Tensor) -> torch.Tensor:
    """``table[cat_ids]`` for ``cat_ids (b, fields)``, gathered through
    :class:`_FixedOrderRows`."""
    got = _FixedOrderRows.apply(table, cat_ids.reshape(-1))
    return got.reshape(*cat_ids.shape, *table.shape[1:])


def forward(params: Dict[str, Any], dense: torch.Tensor,
            cat_ids: torch.Tensor) -> torch.Tensor:
    """Logits for a batch; ``cat_ids`` are already offset into the stacked
    vocab (``(batch, n_fields)``)."""
    return forward_from_rows(params, dense,
                             _rows(params["wide_cat"], cat_ids),
                             _rows(params["emb"], cat_ids))


def bce_loss(params, dense, cat_ids, labels, mask):
    """The linear family's masked binary log-loss of :func:`forward`."""
    return logistic_loss(forward(params, dense, cat_ids),
                         labels, mask)


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
                    plain: bool = False, span=null_span):
    """``(batch_step, opt_state0)`` for the Wide&Deep training loop;
    ``batch_step(params, opt_state, dense, cat_ids, labels, mask,
    *route_arrays) -> (params, opt_state, loss)``.  ``span`` (a
    :meth:`~flink_ml_tpu_torch.obs.trace.SpanTracer.recorder`) spans a
    step's parts, each timed on the params' device: ``wd_step.rows`` (the
    routed step's row reads), ``wd_step.grad``, ``wd_step.fold`` (the
    routed placement) and ``wd_step.adam``.

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
    a batch does not touch keep param AND optimizer state exactly.

    Without ``route`` the table gradients come through
    :class:`_FixedOrderRows`: the same bits run after run on the card."""
    dev = None if span is null_span else tree_leaves(params)[0].device
    if route is not None:
        if lazy:
            raise ValueError(
                "routed table gradients are a dense-Adam path; disable "
                "lazyEmbeddingOptimizer or set routedEmbeddingGrad='off'")

        def batch_step(params, opt_state, dense, cat_ids, labels, mask,
                       *route_arrays):
            _, rest = _split(params)
            with span("wd_step.rows", cat="train", device=dev):
                emb_rows = _rows(params["emb"], cat_ids)
                wide_rows = _rows(params["wide_cat"], cat_ids)

            def loss_rows(rest, emb_rows, wide_rows):
                return logistic_loss(
                    forward_from_rows(rest, dense, wide_rows, emb_rows),
                    labels, mask)

            with span("wd_step.grad", cat="train", device=dev):
                loss, (g_rest, g_emb, g_wide) = _value_and_grad(
                    loss_rows, rest, emb_rows, wide_rows)
            emb_dim = emb_rows.shape[-1]
            with span("wd_step.fold", cat="train", device=dev):
                grads = {
                    **g_rest,
                    "emb": route.apply(g_emb.reshape(-1, emb_dim),
                                       *route_arrays, plain=plain),
                    "wide_cat": route.apply(g_wide.reshape(-1),
                                            *route_arrays, plain=plain),
                }
            with span("wd_step.adam", cat="train", device=dev):
                params, opt_state = adam_update(grads, opt_state, params,
                                                lr, b1, b2, eps)
            return params, opt_state, loss

        return batch_step, adam_init(params)
    if not lazy:
        def batch_step(params, opt_state, dense, cat_ids, labels, mask):
            with span("wd_step.grad", cat="train", device=dev):
                loss, (grads,) = _value_and_grad(
                    lambda p: bce_loss(p, dense, cat_ids, labels, mask),
                    params)
            with span("wd_step.adam", cat="train", device=dev):
                params, opt_state = adam_update(grads, opt_state, params,
                                                lr, b1, b2, eps)
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
        with span("wd_step.grad", cat="train", device=dev):
            loss, (grads,) = _value_and_grad(
                lambda p: bce_loss(p, dense, cat_ids, labels, mask), params)
        tables, rest = _split(params)
        g_tab, g_rest = _split(grads)
        t = opt_state["t"] + 1
        with span("wd_step.adam", cat="train", device=dev):
            rest, rest_state = adam_update(g_rest, opt_state["rest"], rest,
                                           lr, b1, b2, eps)
            # weight-0 rows (epoch padding) must not count as touched:
            # their ids are dropped before the update (the JAX step sends
            # them out of range so its scatters drop them)
            ids = cat_ids[mask > 0].reshape(-1).long()
            for k in _LAZY_TABLE_KEYS:
                lazy_adam_rows(tables[k], opt_state["m"][k],
                               opt_state["v"][k], g_tab[k], ids, t, lr, b1,
                               b2, eps)
        new_state = {"rest": rest_state, "m": opt_state["m"],
                     "v": opt_state["v"], "t": t}
        return {**rest, **tables}, new_state, loss

    return batch_step, opt_state0


def _psum_loss_and_grads(value, g_rest, axes, mesh):
    """The loss part and the dense-tower gradients summed over ``axes`` in
    rank order, packed into one ``psum_ordered``."""
    from ...parallel.collectives import psum_ordered

    leaves = tree_leaves(g_rest)
    flat = psum_ordered(torch.cat(
        [value.reshape(1)] + [g.reshape(-1) for g in leaves]), axes,
        mesh=mesh)
    out, at = [], 1
    for g in leaves:
        out.append(flat[at:at + g.numel()].reshape(g.shape))
        at += g.numel()
    return flat[0], tree_unflatten(g_rest, out)


def _gather_slot_rows(g_emb, g_wide, axes, mesh):
    """Every rank's slot gradient rows of both tables, gathered in rank
    order by one all-gather of the ``(S, emb + 1)`` rows: the global
    step's slot order (every rank holds the same row count)."""
    from ...parallel.collectives import all_gather

    width = g_emb.shape[-1]
    rows = all_gather(torch.cat([g_emb.reshape(-1, width),
                                 g_wide.reshape(-1, 1)], dim=1), axes,
                      mesh=mesh)
    return rows[:, :width].contiguous(), rows[:, width].contiguous()


def _placed_rows(tables, ids, rows_emb, rows_wide):
    """The table gradients: the gathered rows summed into zero tables at
    the gathered ids in their order (``sgd._scatter_add_``), the same
    bits on every rank."""
    return {"emb": _scatter_add_(torch.zeros_like(tables["emb"]), ids,
                                 rows_emb),
            "wide_cat": _scatter_add_(torch.zeros_like(tables["wide_cat"]),
                                      ids, rows_wide)}


def _make_group_train_ops(params, lr: float, lazy: bool, mesh, route=None,
                          b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8, plain: bool = False):
    """:func:`_make_train_ops` for one rank of a data-parallel ``mesh``
    (parameters and optimizer state replicated; each step's arguments
    are this rank's rows, the same count on every rank): the JAX
    package's in-memory fit over ``default_mesh()``, whose global step is
    the ranks' rows in rank order.

    Each step differentiates through the gathered table rows of its own
    rows, the loss over the global mask sum (one rank-order sum of the
    denominator first), so every row's gradient is the one-process
    step's.  The dense-tower gradients and the loss sum over every axis
    of the mesh in rank order (one packed ``psum_ordered``); the slot
    gradient rows are gathered in rank order (one all-gather of the
    ``(S, emb + 1)`` rows), the global step's slot order.  With
    ``route`` (the route of the global epoch tensor, the same on every
    rank) every rank folds and places them through ``route.apply``, the
    fold kernel (B7) on the card; without, the gathered ids place them by
    the fixed-order scatter (``sgd._scatter_add_``), and the lazy update
    touches the global step's unmasked ids.  Every rank computes the same
    bits."""
    from ...parallel.collectives import all_gather, psum_ordered

    if route is not None and lazy:
        raise ValueError(
            "routed table gradients are a dense-Adam path; disable "
            "lazyEmbeddingOptimizer or set routedEmbeddingGrad='off'")
    axes = tuple(mesh.axis_names)

    def grads_of(params, dense, cat_ids, labels, mask):
        denom = torch.clamp(psum_ordered(torch.sum(mask).reshape(1), axes,
                                         mesh=mesh)[0], min=1e-12)
        tables, rest = _split(params)
        emb_rows = _rows(tables["emb"], cat_ids)
        wide_rows = _rows(tables["wide_cat"], cat_ids)

        def loss_rows(rest, emb_rows, wide_rows):
            return _global_logistic(
                forward_from_rows(rest, dense, wide_rows, emb_rows),
                labels, mask, denom)

        value, (g_rest, g_emb, g_wide) = _value_and_grad(
            loss_rows, rest, emb_rows, wide_rows)
        return (*_psum_loss_and_grads(value, g_rest, axes, mesh),
                *_gather_slot_rows(g_emb, g_wide, axes, mesh))

    if not lazy:
        def batch_step(params, opt_state, dense, cat_ids, labels, mask,
                       *route_arrays):
            loss, g_rest, rows_emb, rows_wide = grads_of(
                params, dense, cat_ids, labels, mask)
            if route is not None:
                g_tab = {"emb": route.apply(rows_emb, *route_arrays,
                                            plain=plain),
                         "wide_cat": route.apply(rows_wide, *route_arrays,
                                                 plain=plain)}
            else:
                ids = all_gather(cat_ids.reshape(-1), axes, mesh=mesh)
                g_tab = _placed_rows(params, ids, rows_emb, rows_wide)
            params, opt_state = adam_update({**g_rest, **g_tab}, opt_state,
                                            params, lr, b1, b2, eps)
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
        loss, g_rest, rows_emb, rows_wide = grads_of(
            params, dense, cat_ids, labels, mask)
        tables, rest = _split(params)
        all_ids = all_gather(cat_ids, axes, mesh=mesh)
        g_tab = _placed_rows(tables, all_ids.reshape(-1), rows_emb,
                             rows_wide)
        rest, rest_state = adam_update(g_rest, opt_state["rest"], rest, lr,
                                       b1, b2, eps)
        t = opt_state["t"] + 1
        # the global step's unmasked ids (masked rows are epoch padding)
        all_mask = all_gather(mask, axes, mesh=mesh)
        ids = all_ids[all_mask > 0].reshape(-1).long()
        for k in _LAZY_TABLE_KEYS:
            lazy_adam_rows(tables[k], opt_state["m"][k], opt_state["v"][k],
                           g_tab[k], ids, t, lr, b1, b2, eps)
        new_state = {"rest": rest_state, "m": opt_state["m"],
                     "v": opt_state["v"], "t": t}
        return {**rest, **tables}, new_state, loss

    return batch_step, opt_state0


def _opt_state_tree(opt_state) -> Dict[str, Any]:
    """The optimizer state as a checkpoint tree of dicts: dense Adam as
    ``{"count", "mu", "nu"}`` (``optax.ScaleByAdamState``'s fields), the
    lazy state as ``{"rest": <dense Adam>, "m", "v", "t"}`` (the JAX
    package's keys)."""
    if isinstance(opt_state, AdamState):
        return {"count": opt_state.count, "mu": opt_state.mu,
                "nu": opt_state.nu}
    return {**opt_state, "rest": _opt_state_tree(opt_state["rest"])}


def _opt_state_from_tree(tree, device) -> Any:
    """:func:`_opt_state_tree` read back, its tensors on ``device``."""
    if "count" in tree:
        return AdamState(count=int(tree["count"]),
                         mu=params_to_device(tree["mu"], device),
                         nu=params_to_device(tree["nu"], device))
    return {"rest": _opt_state_from_tree(tree["rest"], device),
            "m": params_to_device(tree["m"], device),
            "v": params_to_device(tree["v"], device), "t": int(tree["t"])}


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


def assert_sharded_matches_reference(sharded_params, sharded_loss,
                                     ref_params, ref_loss, *,
                                     mesh=None) -> None:
    """Allclose on the loss and every parameter leaf (f32 tolerances: the
    sharded step sums in another order than the one-device step).  With
    ``mesh`` the rank's shards of ``sharded_params`` are gathered over
    ``"model"`` first (:func:`gather_sharded_params`; every rank of the
    mesh must call it)."""
    if mesh is not None:
        sharded_params = gather_sharded_params(sharded_params, mesh)
    np.testing.assert_allclose(float(sharded_loss), float(ref_loss),
                               rtol=1e-5, atol=1e-6)
    host = tree_map(lambda t: np.asarray(t.detach().cpu() if isinstance(
        t, torch.Tensor) else t), ref_params)
    got = tree_map(lambda t: np.asarray(t.detach().cpu() if isinstance(
        t, torch.Tensor) else t), sharded_params)
    for a, b in zip(tree_leaves(got), tree_leaves(host)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# -- dp x tp: the sharded step --------------------------------------------

MODEL_AXIS = "model"


def param_spec(params) -> Dict[str, Any]:
    """The JAX package's placement of each leaf over ``"model"``, as the
    dimension it splits (None: replicated): the ``wide_*`` leaves
    replicated, ``emb`` by columns, the MLP in Megatron pairs (an even
    layer that is not the last column-parallel, ``w`` and ``b`` split; an
    odd layer row-parallel, ``w`` split by rows, ``b`` replicated; a final
    even layer replicated)."""
    n = len(params["mlp"])
    mlp = []
    for i in range(n):
        if i % 2 == 0 and i + 1 < n:
            mlp.append({"w": 1, "b": 0})
        elif i % 2 == 1:
            mlp.append({"w": 0, "b": None})
        else:
            mlp.append({"w": None, "b": None})
    return {"wide_cat": None, "wide_dense": None, "wide_b": None,
            "emb": 1, "mlp": mlp}


def _spec_leaves(params) -> list:
    """:func:`param_spec` in :func:`tree_leaves` order (a split dim may be
    0, which a tree walk would not tell from a leaf)."""
    def walk(p, s):
        if isinstance(p, dict):
            return [x for k in sorted(p) for x in walk(p[k], s[k])]
        if isinstance(p, (list, tuple)):
            return [x for a, b in zip(p, s) for x in walk(a, b)]
        return [s]

    return walk(params, param_spec(params))


def shard_params(params, index: int, size: int) -> Dict[str, Any]:
    """Model rank ``index``'s shard (of ``size``) of a full parameter tree
    (numpy arrays or tensors) under :func:`param_spec`."""
    def one(x, dim):
        if dim is None or size == 1:
            return x
        n = x.shape[dim]
        if n % size:
            raise ValueError(
                f"a leaf of shape {tuple(x.shape)} does not split over "
                f"{size} model ranks on dim {dim}")
        w = n // size
        sl = [slice(None)] * len(x.shape)
        sl[dim] = slice(index * w, (index + 1) * w)
        return x[tuple(sl)]

    return tree_unflatten(params, [one(x, d) for x, d in zip(
        tree_leaves(params), _spec_leaves(params))])


def gather_sharded_params(params, mesh) -> Dict[str, Any]:
    """A rank's shard tree gathered over ``"model"`` into the full host
    tree (numpy): every rank of the mesh must call it (one all-gather a
    split leaf)."""
    from ...parallel.collectives import gather_axis

    def one(x, dim):
        if dim is not None:
            x = gather_axis(x.detach(), MODEL_AXIS, dim=dim, mesh=mesh)
        return x.detach().cpu().numpy()

    return tree_unflatten(params, [one(x, d) for x, d in zip(
        tree_leaves(params), _spec_leaves(params))])


def _global_logistic(margin, labels, mask, denom):
    """This rank's part of the global masked log-loss: the sum over its
    rows divided by the global mask sum ``denom``, so each row's gradient
    is the one-process fit's (:func:`..common.losses.logistic_loss` with
    the global denominator)."""
    y = labels * 2.0 - 1.0
    z = -y * margin
    return torch.sum(torch.logaddexp(torch.zeros_like(z), z) * mask) / denom


def _sharded_forward(rest, dense, wide_rows, emb_rows, mlp_spec, mesh):
    """Logits of a rank's rows with the MLP sharded over ``"model"``:
    ``emb_rows (b, fields, emb/M)`` are this rank's embedding columns,
    gathered into the deep input (backward: the reduce-scatter into a
    column-parallel first layer); a column-parallel layer takes its
    replicated input through :func:`copy_to_axis`, a row-parallel layer's
    partial products meet in :func:`sum_over_axis`."""
    from ...parallel.collectives import (copy_to_axis, gather_axis,
                                         sum_over_axis)

    wide = (dense @ rest["wide_dense"] + torch.sum(wide_rows, dim=1)
            + rest["wide_b"])
    emb = gather_axis(emb_rows, MODEL_AXIS, dim=2,
                      reduce_grad=mlp_spec[0]["w"] == 1, mesh=mesh)
    deep = torch.cat([dense, emb.reshape(emb.shape[0], -1)], dim=1)
    n = len(rest["mlp"])
    for i, (layer, sp) in enumerate(zip(rest["mlp"], mlp_spec)):
        if sp["w"] == 1:
            if i > 0:
                deep = copy_to_axis(deep, MODEL_AXIS, mesh=mesh)
            deep = deep @ layer["w"] + layer["b"]
        elif sp["w"] == 0:
            deep = sum_over_axis(deep @ layer["w"], MODEL_AXIS,
                                 mesh=mesh) + layer["b"]
        else:
            deep = deep @ layer["w"] + layer["b"]
        if i + 1 < n:
            deep = torch.relu(deep)
    return wide + deep[:, 0]


def build_sharded_train_step(mesh, d_dense: int, vocab_sizes, emb_dim: int,
                             hidden, lr: float = 1e-2, grad_reduce=None):
    """The dp x tp training step of the JAX package on a ``("data",
    "model")`` mesh of ranks: the embedding columns and the MLP hidden
    dims sharded over ``"model"`` (:func:`param_spec`), the batch over
    ``"data"`` (the ranks of one model group pass the same rows).  The
    JAX package's seed-0 init, each rank keeping its shard.  Returns
    ``(train_step, params, opt, opt_state, shard_batch_fn)``:
    ``train_step(params, opt_state, dense, cat_ids, labels, mask) ->
    (params, opt_state, loss)`` on this rank's shards and rows,
    ``opt`` the :class:`~..common.adam.Adam` it steps with and
    ``shard_batch_fn(dense, cat_ids, labels, mask)`` this rank's rows of
    a global host batch (ids offset) as tensors on its device.
    :func:`gather_sharded_params` gathers the shards back.

    Per step: the loss divides by the global mask sum (one rank-order sum
    over ``"data"``); the MLP runs Megatron's pairs
    (:func:`_sharded_forward`); the dense-tower gradients sum over
    ``"data"`` in rank order (one packed ``psum_ordered``); the table
    gradients are every data rank's slot rows and ids gathered and
    summed in the global slot order (:func:`_placed_rows`: ~27 MB a
    rank at the bench width where a dense sum of a rank's ``(1048554,
    32)`` embedding shard would move 134 MB), so every rank holds the
    same bits.

    ``grad_reduce`` (a compressed
    :class:`~flink_ml_tpu_torch.parallel.grad_reduce.GradReduceConfig`):
    the dense-tower gradients (``wide_dense``, ``wide_b``, ``mlp``) are
    gathered over ``"model"`` into whole leaves, reduced over the
    config's axes (``GR.mesh_layout``) by ``reduce_gradients`` (with
    ``overlap``, ``pipelined_reduce``: one step stale) and each rank keeps
    its slice, so top-k picks the entries of the JAX package's whole-leaf
    selection and the model peers hold the same EF and ``pending``
    state; the table gradients stay exact.  The step then takes and
    returns the reducer state and the call returns a 6-tuple,
    ``(train_step, params, opt, opt_state, shard_batch_fn, gr_state0)``,
    with ``train_step(params, opt_state, gr_state, dense, cat_ids,
    labels, mask) -> (params, opt_state, gr_state, loss)``; ``gr_state0``
    is this rank's state, its data participant's slice of the JAX
    package's stacked state."""
    from ...parallel import grad_reduce as GR
    from ...parallel.collectives import (all_gather, axis_index, gather_axis,
                                         psum_ordered)
    from ...parallel.mesh import Mesh
    from ..common.adam import Adam

    if not isinstance(mesh, Mesh):
        raise TypeError("build_sharded_train_step takes a flink_ml_tpu_torch"
                        ".parallel.mesh.Mesh (a process group's axes), got "
                        f"{type(mesh).__name__}")
    for axis in ("data", MODEL_AXIS):
        if axis not in mesh.shape:
            raise ValueError(f"build_sharded_train_step needs a ('data', "
                             f"'model') mesh, got axes {list(mesh.shape)}")
    dev = mesh.device if mesh.device is not None else resolve_device("cuda")
    size = int(mesh.shape[MODEL_AXIS])
    mrank = axis_index(MODEL_AXIS, mesh=mesh)
    n_data = int(mesh.shape["data"])
    drank = axis_index("data", mesh=mesh)
    host = init_params(np.random.default_rng(0), d_dense, vocab_sizes,
                       emb_dim, hidden)
    spec = param_spec(host)
    params = params_to_device(shard_params(host, mrank, size), dev)
    opt = Adam(lr)
    opt_state = opt.init(params)
    compressed = grad_reduce is not None and grad_reduce.mode != "exact"
    axes = (GR.mesh_layout(grad_reduce, mesh)[0] if compressed
            else ("data",))
    if MODEL_AXIS in axes:
        raise ValueError("grad_reduce must reduce over the data axes; the "
                         "'model' axis holds the shards")

    def local_grads(params, dense, cat_ids, labels, mask):
        """(local loss part, dense-tower grads, table grads) of this
        rank's rows, the loss over the global denominator."""
        denom = torch.clamp(psum_ordered(torch.sum(mask).reshape(1), axes,
                                         mesh=mesh)[0], min=1e-12)
        tables, rest = _split(params)
        emb_rows = _rows(tables["emb"], cat_ids)
        wide_rows = _rows(tables["wide_cat"], cat_ids)

        def loss_rows(rest, emb_rows, wide_rows):
            return _global_logistic(
                _sharded_forward(rest, dense, wide_rows, emb_rows,
                                 spec["mlp"], mesh), labels, mask, denom)

        value, (g_rest, g_emb, g_wide) = _value_and_grad(
            loss_rows, rest, emb_rows, wide_rows)
        ids = all_gather(cat_ids.reshape(-1), axes, mesh=mesh)
        return value, g_rest, _placed_rows(
            tables, ids, *_gather_slot_rows(g_emb, g_wide, axes, mesh))

    def shard_batch_fn(dense, cat_ids, labels, mask):
        n = np.asarray(labels).shape[0]
        if n % n_data:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{n_data} data ranks")
        b = n // n_data
        rows = slice(drank * b, (drank + 1) * b)
        return tuple(torch.from_numpy(np.ascontiguousarray(
            np.asarray(a)[rows])).to(dev) for a in (
                np.asarray(dense, np.float32), np.asarray(cat_ids, np.int32),
                np.asarray(labels, np.float32), np.asarray(mask, np.float32)))

    if not compressed:
        def train_step(params, opt_state, dense, cat_ids, labels, mask):
            value, g_rest, g_tab = local_grads(params, dense, cat_ids,
                                               labels, mask)
            loss, g_rest = _psum_loss_and_grads(value, g_rest, axes, mesh)
            params, opt_state = opt.update({**g_rest, **g_tab}, opt_state,
                                           params)
            return params, opt_state, loss

        return train_step, params, opt, opt_state, shard_batch_fn

    gr = grad_reduce
    overlap = GR.wants_overlap(gr)
    rest_spec = _spec_leaves(_split(host)[1])
    gr_state0 = GR.init_state(gr, params_to_device(_split(host)[1], dev),
                              mesh)

    def whole(leaves):
        return [x if d is None else gather_axis(x, MODEL_AXIS, dim=d,
                                                mesh=mesh)
                for x, d in zip(leaves, rest_spec)]

    def mine(leaves):
        return [x if d is None else x.chunk(size, dim=d)[mrank].contiguous()
                for x, d in zip(leaves, rest_spec)]

    def train_step(params, opt_state, gr_state, dense, cat_ids, labels,
                   mask):
        value, g_rest, g_tab = local_grads(params, dense, cat_ids, labels,
                                           mask)
        loss = psum_ordered(value.reshape(1), axes, mesh=mesh)[0]
        full = tree_unflatten(g_rest, whole(tree_leaves(g_rest)))
        if overlap:
            red, gr_state = GR.pipelined_reduce(full, gr_state, gr,
                                                mesh=mesh)
        else:
            red, gr_state = GR.reduce_gradients(full, gr_state, gr,
                                                mesh=mesh)
        grads = {**tree_unflatten(g_rest, mine(tree_leaves(red))), **g_tab}
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, gr_state, loss

    return (train_step, params, opt, opt_state, shard_batch_fn, gr_state0)


class WideDeep(WideDeepParams, Estimator["WideDeepModel"]):
    """fit(table with denseFeatures (n,d) float, catFeatures (n,f) int,
    label (n,) {0,1}).  After a routed fit, ``route_info`` holds the
    route's placement, ``fold_passes``, steps, slots per step and host
    build seconds (None for an unrouted fit)."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device
        self.route_info: Optional[dict] = None

    def fit(self, *inputs, plain: bool = False,
            mesh=None) -> "WideDeepModel":
        """``plain`` folds the routed gradients with the plain version
        instead of the kernel (for comparisons on the card).

        Inside a process group the fit runs on ``mesh`` (default the
        default mesh; the JAX package's fit over ``default_mesh()``), each
        rank passing its own rows (``KMeans.fit``'s rule): each rank lays
        out its rows (``sgd._plan_epoch_layout_for_mesh``: one allgather
        checks the ranks planned alike), the global step being the ranks'
        local batches in rank order; the parameters are the same draw on
        every rank; each step runs :func:`_make_group_train_ops`, whose
        route is built from the rank-order gather of the ranks' epoch
        tensors, the same on every rank, so B7 folds the global step's
        gathered gradient rows on every rank.  Every rank returns the
        same model.  A group of one rank is the one-process fit."""
        from ..common.sgd import _mesh_ranks, _plan_epoch_layout_for_mesh

        (table,) = inputs
        vocab_sizes = self.get_vocab_sizes()
        if vocab_sizes is None:
            raise ValueError("WideDeep requires vocabSizes to be set")
        dev = resolve_device(self.device)
        self.route_info = None
        if mesh is None:
            from ...parallel.mesh import default_mesh

            mesh = default_mesh()
        grouped = _mesh_ranks(mesh) > 1
        # read once a fit: every span below, the steps' too, closes over it
        span = tracer.recorder()
        with span("widedeep.fit", cat="train", device=dev):
            with span("widedeep.validate", cat="train"):
                dense = np.asarray(table[self.DENSE_FEATURES_COL],
                                   np.float32)
                cat = np.asarray(table[self.CAT_FEATURES_COL], np.int32)
                labels = np.asarray(table[self.get_label_col()], np.float32)
                cat = _validate_cat_ids(cat, vocab_sizes)

            n = dense.shape[0]
            gbs = self.get_global_batch_size() or DEFAULT_GLOBAL_BATCH
            with span("widedeep.layout", cat="train"):
                if grouped:
                    steps, batch, perm = _plan_epoch_layout_for_mesh(
                        n, gbs, mesh, self.get_seed())
                else:
                    steps, batch, perm = plan_epoch_layout(n, gbs, 1,
                                                           self.get_seed())

                def layout(arr):
                    return prepare_epoch_tensor(arr, perm, steps, batch)

                C = layout(cat)
                host = [layout(dense), C, layout(labels),
                        layout(np.ones((n,), np.float32))]
            with span("widedeep.copy_in", cat="train", device=dev):
                data = tuple(torch.from_numpy(a).to(dev) for a in host)
                del host

            lazy = bool(self.LAZY_EMB_OPT)
            routed_mode = self.get(WideDeepParams.ROUTED_EMB_GRAD)
            route = None
            if routed_mode == "on" or (routed_mode == "auto" and not lazy):
                # the epoch tensor C is replayed every epoch, so the
                # slot->row sort is static: built once here on the host
                # ("auto": gather until the inverse map outgrows its
                # budget, then scatter)
                with span("widedeep.route", cat="train", device=dev):
                    t0 = time.perf_counter()
                    C_route = C
                    if grouped:
                        # the global epoch tensor: the ranks' local
                        # batches of each step in rank order, the same on
                        # every rank
                        from ...parallel.distributed import process_allgather

                        C_route = np.concatenate(list(process_allgather(
                            C, mesh=mesh)), axis=1)
                    route = emb_grad_route(C_route, int(np.sum(vocab_sizes)),
                                           placement="auto")
                    build_s = time.perf_counter() - t0
                    route = route.to(dev)
                    self.route_info = {
                        "placement": route.placement,
                        "fold_passes": route.fold_passes, "steps": steps,
                        "slots_per_step": int(route.order.shape[1]),
                        "build_s": build_s}
                    data += route.stacked_arrays()

            with span("widedeep.init", cat="train"):
                rng = np.random.default_rng(self.get_seed() + 1)  # init draws
                host_params = init_params(rng, dense.shape[1], vocab_sizes,
                                          self.EMBEDDING_DIM,
                                          self.HIDDEN_UNITS)
            with span("widedeep.params_to_device", cat="train", device=dev):
                params = params_to_device(host_params, dev)
                if grouped:
                    step_fn, opt_state = _make_group_train_ops(
                        params, self.LEARNING_RATE, lazy, mesh, route=route,
                        plain=plain)
                else:
                    step_fn, opt_state = _make_train_ops(
                        params, self.LEARNING_RATE, lazy, route=route,
                        plain=plain, span=span)

            def epoch_body(state, epoch, data):
                Xd, Cd, yd, md = data[:4]
                rt = data[4:]
                params, opt_state, loss_log = state
                losses = []
                for i in range(steps):
                    with span("wd_step", cat="train", device=dev,
                              step=epoch * steps + i):
                        params, opt_state, loss = step_fn(
                            params, opt_state, Xd[i], Cd[i], yd[i], md[i],
                            *(a[i] for a in rt))
                    losses.append(loss)
                # stays on the device: the loop never waits for it
                loss_log[epoch] = torch.stack(losses).mean()
                return IterationBodyResult((params, opt_state, loss_log))

            max_epochs = self.get_max_iter()
            with span("widedeep.epochs", cat="train", device=dev):
                init_state = (params, opt_state,
                              torch.full((max_epochs,), float("nan"),
                                         device=dev))
                result = iterate(epoch_body, init_state, data,
                                 max_epochs=max_epochs,
                                 config=IterationConfig(mode="fused"))
            fitted, _, loss_buf = result.state

            with span("widedeep.copy_out", cat="train", device=dev):
                model = WideDeepModel(device=self.device)
                model.copy_params_from(self)
                model._params = _params_to_host(fitted)
                model._vocab_sizes = tuple(int(v) for v in vocab_sizes)
                model._loss_log = list(loss_buf.cpu().numpy())
        return model

    def fit_outofcore(self, make_reader, *, mesh=None,
                      prefetch_depth: int = 2, prefetch_workers: int = 1,
                      prefetch_put_workers: int = 1,
                      prefetch_stats=None,
                      steps_per_dispatch: int = 8,
                      checkpoint=None,
                      checkpoint_every_steps: int = 0,
                      resume: bool = False,
                      membership=None) -> "WideDeepModel":
        """Out-of-core ``fit``: epochs stream from ``make_reader()`` (the
        ``sgd_fit_outofcore`` reader protocol: a fresh per-epoch iterator
        of host batch dicts with this estimator's column names;
        epoch-aware factories receive ``epoch=``) instead of holding the
        ``(rows, fields)`` epoch tensors on the device.  Batches pad to the
        first batch's row count (padding rows carry mask 0 and cat id 0,
        inert in both optimizers: the loss is mask-weighted and the lazy
        table update drops masked rows' ids), move to the device through
        :func:`~flink_ml_tpu_torch.data.prefetch.prefetch_to_device`
        overlapping the Adam steps, and the parameters and optimizer state
        never leave the device between epochs.  Parameters are drawn at
        the first batch (``d_dense`` comes from the stream) from the same
        generator as ``fit``'s.

        **Chunked dispatch** (``steps_per_dispatch=W``, default 8): ``W``
        consecutive batches move as one staged chunk and the consumer runs
        their ``W`` Adam steps
        (:func:`~flink_ml_tpu_torch.data.prefetch.masked_chunk_scan`); the
        padded steps of the final short chunk are skipped, which freezes
        the parameters AND the optimizer state, so any two ``W`` agree bit
        for bit.

        **Determinism**: the table gradients sum in one fixed order
        (:class:`_FixedOrderRows`), so on the card too any ``W``, a
        resumed fit and a rerun give the same bits.

        **Checkpoints** (``checkpoint=``, ``checkpoint_every_steps=``,
        ``resume=``; the ``sgd_fit_outofcore`` protocol): cuts land at the
        chunk boundaries that cross a multiple of
        ``checkpoint_every_steps`` batches and at every epoch end,
        carrying the parameters, the Adam state and the loss
        accumulators; ``resume=True`` restores the newest valid cut,
        re-seeks the reader and continues bit for bit.

        ``routedEmbeddingGrad='on'`` raises: a stream's batches are not
        replayed, so no static route exists.

        **Several ranks** (``mesh=``, a
        :class:`~flink_ml_tpu_torch.parallel.mesh.Mesh` of a process
        group; the JAX package's process-spanning meshes): call from every
        rank with a reader over that rank's own shard, every rank
        delivering the same number of equal batches an epoch; the global
        batch is the ranks' batches in rank order and each step is
        :func:`_make_group_train_ops`'s (the table gradients placed by the
        fixed-order scatter of the gathered rows).  A mesh of several
        ranks runs one batch a dispatch (``W = 1``).  Rank 0 of the mesh
        writes the cuts and a barrier makes each visible; every cut
        records its fleet (``mesh_shape_meta``).  Every rank returns the
        same model.  A mesh of one rank is the one-process fit.

        **Elastic membership** (``membership=``, an
        :class:`~flink_ml_tpu_torch.parallel.elastic.ElasticCoordinator`,
        with ``mesh=`` its fleet's :meth:`~.ElasticCoordinator.mesh`; a
        checkpoint manager is required): each rank of the fleet reads the
        global batch and trains its ``1 / ranks`` share of its rows (the
        batch pads to a multiple of the fleet's ranks), so a resize
        changes the shard count, not the data; ``W`` is kept.  Once per
        chunk boundary the fit cuts where due, then polls
        ``membership.poll(global_step)``; when the fleet moved it cuts (if
        it has not) and raises
        :class:`~flink_ml_tpu_torch.parallel.elastic.ResizeRequested` for
        ``resilient_fit(elastic=)`` to restore onto the new fleet.  The
        parameters and the Adam state are replicated, so a resize is
        placement only."""
        from ...data.prefetch import (chunk_consumer_plan,
                                      masked_chunk_scan, prefetch_to_device)
        from ...iteration.checkpoint import (THIS_RANK, CheckpointConfig,
                                             CheckpointManager,
                                             mesh_shape_meta)
        from ...parallel.collectives import axis_index
        from ...parallel.mesh import Mesh, local_mesh
        from ..common.sgd import _mesh_ranks

        vocab_sizes = self.get_vocab_sizes()
        if vocab_sizes is None:
            raise ValueError("WideDeep requires vocabSizes to be set")
        if self.get(WideDeepParams.ROUTED_EMB_GRAD) == "on":
            raise ValueError(
                "routedEmbeddingGrad='on' cannot apply to the streaming "
                "fit: its batches are not replayed, so no static route "
                "exists — use 'auto' (streams on the fixed-order "
                "scatter-add) or the in-memory fit()")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh= takes a flink_ml_tpu_torch.parallel.mesh.Mesh (a "
                f"process group's axes), got {type(mesh).__name__}")
        if membership is not None and mesh is None:
            raise ValueError("elastic membership needs its fleet's mesh: "
                             "pass mesh=membership.mesh()")
        ranks = _mesh_ranks(mesh)
        multi = ranks > 1
        dev = resolve_device(self.device)
        manager = None
        if isinstance(checkpoint, CheckpointManager):
            manager = checkpoint
        elif isinstance(checkpoint, CheckpointConfig):
            manager = CheckpointManager(checkpoint)
        if membership is not None and manager is None:
            raise ValueError(
                "elastic membership requires a checkpoint manager: a "
                "resize IS a restore onto the new mesh")
        if membership is not None and mesh.size > 1 and mesh.group is None:
            raise ValueError(
                "an elastic fleet of several ranks needs a process group: "
                "run the fit on the fleet's ranks of an initialized world "
                "(resilient_fit(elastic=) on every rank)")

        # an elastic fleet shards each (global) batch over its ranks: rows
        # pad to a multiple of the fleet, and this rank keeps its share
        share = ranks if membership is not None else 1
        me = axis_index(tuple(mesh.axis_names), mesh=mesh) if multi else 0
        batcher = FixedRowBatcher(share)
        dense_col, cat_col = self.DENSE_FEATURES_COL, self.CAT_FEATURES_COL
        label_col = self.get_label_col()
        lr, lazy = self.LEARNING_RATE, bool(self.LAZY_EMB_OPT)
        rng = np.random.default_rng(self.get_seed() + 1)  # fit()'s stream

        def to_host_batch(b):
            dense = np.asarray(b[dense_col], np.float32)
            cat = _validate_cat_ids(np.asarray(b[cat_col], np.int32),
                                    vocab_sizes)
            y = np.asarray(b[label_col], np.float32)
            mask = np.ones((y.shape[0],), np.float32)
            # padding rows: mask 0 + cat id 0, inert in both optimizers
            padded = batcher.pad((dense, cat, y, mask), have=y.shape[0])
            if share > 1:
                rows = batcher.rows // share
                padded = tuple(a[me * rows:(me + 1) * rows] for a in padded)
            return padded

        W = max(1, int(steps_per_dispatch))
        if multi and membership is None:
            W = 1
        _, chunk_depth = chunk_consumer_plan(None, None, W, prefetch_depth)

        def train_ops(params):
            if multi:
                return _make_group_train_ops(params, lr, lazy, mesh)
            return _make_train_ops(params, lr, lazy)

        def chunk_step(raw_step):
            def step(state, *batch):
                params, opt_state = state
                params, opt_state, loss = raw_step(params, opt_state, *batch)
                return (params, opt_state), loss

            return step

        params = opt_state = step = None   # built at the first batch
        epoch_sums: List = []   # per epoch: (device loss sum, n_batches)
        global_step = 0         # checkpoint tick: batches over all epochs
        start_epoch = 0
        skip_steps = 0          # batches already consumed in start_epoch
        resume_loss_sum = None
        resume_n_batches = 0
        group = mesh.group if multi else THIS_RANK
        if manager is not None and resume:
            restored = manager.restore_latest(group=group)
            if restored is not None:
                global_step, saved, meta = restored
                params = params_to_device(saved["params"], dev)
                opt_state = _opt_state_from_tree(saved["opt_state"], dev)
                raw_step, _ = train_ops(params)
                step = chunk_step(raw_step)
                start_epoch = int(meta["train_epoch"])
                skip_steps = int(meta["step_in_epoch"])
                resume_n_batches = int(meta["n_batches"])
                if resume_n_batches:
                    resume_loss_sum = torch.as_tensor(
                        np.asarray(saved["loss_sum"], np.float32)).to(dev)
                epoch_sums = [
                    (torch.as_tensor(np.asarray(s, np.float32)).to(dev),
                     int(n)) for s, n in saved["epoch_sums"]]

        fleet_meta = mesh_shape_meta(mesh or local_mesh(),
                                     participant_count=ranks)

        def save(epoch, step_in_epoch, loss_sum, n_batches):
            manager.save(global_step, {
                "params": params, "opt_state": _opt_state_tree(opt_state),
                "loss_sum": (loss_sum if loss_sum is not None
                             else torch.zeros((), dtype=torch.float32)),
                "epoch_sums": [(s, int(n)) for s, n in epoch_sums],
            }, {"train_epoch": epoch, "step_in_epoch": step_in_epoch,
                "n_batches": n_batches, **fleet_meta}, group=group)

        for epoch in range(start_epoch, self.get_max_iter()):
            reader = _reader_for_epoch(make_reader, epoch)
            if epoch == start_epoch and skip_steps:
                reader = _seek_or_skip(reader, skip_steps)
            loss_sum = resume_loss_sum
            n_batches = resume_n_batches
            step_in_epoch = skip_steps
            resume_loss_sum, resume_n_batches, skip_steps = None, 0, 0
            # closed on every exit: a supervised restart must not race a
            # live reader thread for the shared source
            pipeline = prefetch_to_device(
                reader, depth=chunk_depth, device=dev,
                transform=to_host_batch, workers=prefetch_workers,
                put_workers=prefetch_put_workers, stats=prefetch_stats,
                chunks=W)
            try:
                for chunk, cmask, n_valid in pipeline:
                    if step is None:
                        params = params_to_device(init_params(
                            rng, int(chunk[0].shape[2]), vocab_sizes,
                            self.EMBEDDING_DIM, self.HIDDEN_UNITS), dev)
                        raw_step, opt_state = train_ops(params)
                        step = chunk_step(raw_step)
                    if loss_sum is None:
                        loss_sum = torch.zeros((), dtype=torch.float32,
                                               device=dev)
                    (params, opt_state), loss_sum = masked_chunk_scan(
                        step, (params, opt_state), loss_sum, chunk, cmask,
                        n_valid=n_valid)
                    n_batches += n_valid
                    step_in_epoch += n_valid
                    global_step += n_valid
                    cut_done = False
                    if (manager is not None and checkpoint_every_steps > 0
                            and step_in_epoch // checkpoint_every_steps
                            > (step_in_epoch - n_valid)
                            // checkpoint_every_steps):
                        save(epoch, step_in_epoch, loss_sum, n_batches)
                        cut_done = True
                    # elastic membership: one poll per chunk boundary; a
                    # moved fleet cuts here and hands the resize to the
                    # supervisor
                    if membership is not None \
                            and membership.poll(global_step):
                        if not cut_done:
                            save(epoch, step_in_epoch, loss_sum, n_batches)
                        from ...parallel.elastic import ResizeRequested

                        raise ResizeRequested(
                            step=global_step,
                            fleet_size=membership.fleet_size,
                            membership_epoch=membership.membership_epoch)
            finally:
                pipeline.close()
            if loss_sum is None:
                raise ValueError("make_reader() returned an empty epoch")
            epoch_sums.append((loss_sum, n_batches))
            if manager is not None:
                save(epoch + 1, 0, None, 0)   # epoch-boundary cut
        if params is None:
            raise ValueError("WideDeep.fit_outofcore needs maxIter >= 1")
        model = WideDeepModel(device=self.device)
        model.copy_params_from(self)
        model._params = _params_to_host(params)
        model._vocab_sizes = tuple(int(v) for v in vocab_sizes)
        model._loss_log = [float(s.item()) / n for s, n in epoch_sums]
        return model

    def save(self, path: str) -> None:
        persist.save_metadata(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "WideDeep":
        stage = persist.load_stage_param(path)
        stage.device = device
        return stage


def _widedeep_chain_kernel(static, params, cols):
    """Chain-terminal scores ``sigmoid(forward)`` in row tiles
    (:func:`scores_from_rows`); the raw per-field ids offset into the
    stacked vocab in-device (an exact int add; the range check runs
    host-side as the kernel's ``pre``)."""
    (dcol, ccol, scol) = static
    net = params["net"]
    dense = cols[dcol].to(torch.float32)
    cat = cols[ccol] + params["offsets"][None, :]
    return {scol: scores_from_rows(net, dense, _rows(net["wide_cat"], cat),
                                   _rows(net["emb"], cat))}


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
        """Chain TERMINAL: ``sigmoid(forward)`` over the segment's device
        columns.  The categorical id range check (host control flow) runs
        as the kernel's ``pre`` on the segment's entry columns, so the
        stage only chains while catFeatures passes through from the
        segment input untouched."""
        self._require_model()
        dcol, ccol = self.DENSE_FEATURES_COL, self.CAT_FEATURES_COL
        cat_entry = schema.get(ccol)
        if numeric_entry(schema, dcol) is None \
                or cat_entry is None or cat_entry[1].kind not in "iu" \
                or len(cat_entry[0]) != 1 \
                or cat_entry[0][0] != len(self._vocab_sizes):
            return None
        raw_col = self.get_raw_prediction_col()
        pred_col = self.get_prediction_col()
        score_col = f"__chain_scores__{pred_col}"
        vocab_sizes = self._vocab_sizes

        def pre(host):
            _validate_cat_ids(np.asarray(host[ccol]), vocab_sizes)

        def post(host):
            scores = host[score_col].astype(np.float64)
            return {raw_col: scores,
                    pred_col: (scores > 0.5).astype(np.int64)}

        return StageKernel(
            fn=_widedeep_chain_kernel, static=(dcol, ccol, score_col),
            params={"net": self._params,
                    "offsets": _field_offsets(vocab_sizes)},
            consumes=(dcol, ccol), produces=(score_col,),
            post=post, pre=pre, pre_cols=(ccol,), device=self.device)

    def transform(self, *inputs) -> List[Table]:
        """The chain terminal as a one-stage segment (rows padded to the
        shared bucket; zero pad rows hold id 0, a valid slot of every
        field).  Off its schema, or with ids past +-2^24, the columns are
        range-checked and cast to f32 and int32 first."""
        (table,) = inputs
        self._require_model()
        cols = apply_kernel_or_none(self.transform_kernel(table.schema()),
                                    table)
        if cols is None:
            dcol, ccol = self.DENSE_FEATURES_COL, self.CAT_FEATURES_COL
            cat = np.asarray(table[ccol], np.int32)
            _validate_cat_ids(cat, self._vocab_sizes)
            host = {dcol: np.asarray(table[dcol], np.float32), ccol: cat}
            cols = run_normalized(self.transform_kernel(Table(host).schema()),
                                  host)
        out = table
        for name in (self.get_raw_prediction_col(),
                     self.get_prediction_col()):
            out = out.with_column(name, cols[name])
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


# ---------------------------------------------------------------------------
# kernel-registry entry: op ``widedeep_scores`` (stage convention), one
# PyTorch implementation on both devices (no hand kernel)
# ---------------------------------------------------------------------------

def _register_widedeep_kernels() -> None:
    from ...kernels.registry import register_kernel

    register_kernel("widedeep_scores", "torch", _widedeep_chain_kernel,
                    convention="stage")


_register_widedeep_kernels()
