"""The port's boosted trees (``flink_ml_tpu_torch.models.common.gbt``,
``gbt_stage``, ``GBTClassifier``, ``GBTRegressor``) against the JAX
package's on the same seeded numpy inputs, both on the CPU.

Tolerances: each piece of a level (the two histogram forms, the splits,
the routing, the leaf values, device binning, the tree walk) is exact for
integers and within ``rtol 1e-6`` for floats; whole fits have equal
``feature`` and ``threshold`` and ``value`` / predictions within ``rtol
1e-5, atol 1e-6`` (f32 sums in another order).  The streamed fit's W 1/3/8
and repeated fits are held bit for bit, as ``tests/test_chunked_dispatch.py``
holds the JAX package's."""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flink_ml_tpu as J
import flink_ml_tpu.models.common.gbt as JG
import flink_ml_tpu_torch as T
import flink_ml_tpu_torch.models.common.gbt as TG
from flink_ml_tpu.models.classification import GBTClassifier as JGBTC
from flink_ml_tpu.models.classification import GBTClassifierModel as JGBTCM
from flink_ml_tpu.models.regression import GBTRegressor as JGBTR
from flink_ml_tpu_torch.models.classification import (GBTClassifier,
                                                      GBTClassifierModel)
from flink_ml_tpu_torch.models.regression import (GBTRegressor,
                                                  GBTRegressorModel)
from flink_ml_tpu_torch.serving import ModelRegistry, ServingEndpoint
from flink_ml_tpu_torch.utils import persist as TP
from flink_ml_tpu_torch.utils.convert import (model_data_from_jax,
                                              pipeline_model_from_jax)

PIECE = dict(rtol=1e-6, atol=1e-6)
FIT = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.tensor(np.asarray(a))


def _logistic(yv, pred):
    p = 1.0 / (1.0 + np.exp(-pred))
    return p - yv, np.maximum(p * (1.0 - p), 1e-12)


def _squared(yv, pred):
    return pred - yv, np.ones_like(pred)


def _level_inputs(seed, n_nodes, n=512, d=5, bins=16):
    """Binned rows, level-local ids with dead rows (-1) and, from two
    nodes up, an empty node; logistic-shaped g and positive h."""
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, bins, size=(n, d)).astype(np.int32)
    ids = np.where(rng.random(n) < 0.2, -1,
                   rng.integers(0, n_nodes, size=n)).astype(np.int32)
    if n_nodes > 1:
        ids[ids == n_nodes - 1] = 0
    p = rng.random(n)
    y = (rng.random(n) < 0.4).astype(np.float64)
    g = (p - y).astype(np.float32)
    h = np.maximum(p * (1 - p), 1e-12).astype(np.float32)
    return binned, ids, g, h, d, bins


# ------------------------------------------------------------ level pieces


@pytest.mark.parametrize("impl", ["segsum", "mxu"])
@pytest.mark.parametrize("n_nodes", [1, 4, 8])
def test_level_histograms_match_jax(impl, n_nodes):
    binned, ids, g, h, d, bins = _level_inputs(21 + n_nodes, n_nodes)
    jfn = {"segsum": JG._level_histograms_segsum,
           "mxu": JG._level_histograms_mxu}[impl]
    jg, jh = jfn(jnp.asarray(binned), jnp.asarray(ids), jnp.asarray(g),
                 jnp.asarray(h), n_nodes, d, bins)
    tg, th = TG._HIST_IMPLS[impl](_t(binned), _t(ids), _t(g), _t(h),
                                  n_nodes, d, bins)
    assert tuple(tg.shape) == (n_nodes, d, bins) == tuple(th.shape)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **PIECE)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **PIECE)
    # dead rows add nothing: the histograms sum to the live rows' totals
    live = ids >= 0
    np.testing.assert_allclose(tg.numpy().sum(), g[live].sum() * d,
                               rtol=1e-4, atol=1e-4)


def test_histogram_forms_agree_and_repeat():
    binned, ids, g, h, d, bins = _level_inputs(5, 4)
    args = (_t(binned), _t(ids), _t(g), _t(h), 4, d, bins)
    seg = TG._level_histograms_segsum(*args)
    mxu = TG._level_histograms_mxu(*args)
    for a, b in zip(seg, mxu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **PIECE)
    for a, b in zip(seg, TG._level_histograms_segsum(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("reg_lambda,mcw", [(1.0, 1e-3), (0.1, 0.5)])
@pytest.mark.parametrize("n_nodes", [1, 4])
def test_level_splits_apply_split_and_leaf_values_match_jax(reg_lambda, mcw,
                                                            n_nodes):
    binned, ids, g, h, d, bins = _level_inputs(40 + n_nodes, n_nodes)
    jg, jh = JG._level_histograms_segsum(
        jnp.asarray(binned), jnp.asarray(ids), jnp.asarray(g),
        jnp.asarray(h), n_nodes, d, bins)
    jf, jb, jgain = JG._level_splits(jg, jh, reg_lambda, mcw)
    tf, tb, tgain = TG._level_splits(_t(np.asarray(jg)), _t(np.asarray(jh)),
                                     reg_lambda, mcw)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tgain.numpy(), np.asarray(jgain), **PIECE)
    assert tf.dtype == tb.dtype == torch.int32

    # routing through the same splits: exact
    jids = JG._apply_split(jnp.asarray(binned), jnp.asarray(ids), jf, jb,
                           jgain)
    tids = TG._apply_split(_t(binned), _t(ids), _t(np.asarray(jf)),
                           _t(np.asarray(jb)), _t(np.asarray(jgain)))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))

    # leaf values of the level's ids and of the routed ids
    for lvl_ids, nodes in ((ids, n_nodes), (np.asarray(jids), 2 * n_nodes)):
        jv = JG._leaf_values(jnp.asarray(lvl_ids), jnp.asarray(g),
                             jnp.asarray(h), nodes, reg_lambda)
        tv = TG._leaf_values(_t(lvl_ids), _t(g), _t(h), nodes, reg_lambda)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **PIECE)


def test_build_level_matches_jax():
    binned, ids, g, h, d, bins = _level_inputs(7, 2)
    want = JG._build_level(jnp.asarray(binned), jnp.asarray(ids),
                           jnp.asarray(g), jnp.asarray(h), 2, d, bins, 1.0,
                           1e-3, hist_impl="segsum")
    for impl in ("segsum", "mxu"):
        got = TG._build_level(_t(binned), _t(ids), _t(g), _t(h), 2, d, bins,
                              1.0, 1e-3, hist_impl=impl)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   **PIECE)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_device_binning_matches_host_and_jax():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(500, 4))
    X[:, 2] = np.round(X[:, 2])          # ties on edges
    _, edges = TG.bin_features(X, 16)
    np.testing.assert_array_equal(edges, JG.bin_features(X, 16)[1])
    host = TG.apply_bins(X.astype(np.float32), edges)
    got = TG.apply_bins_device(_t(X.astype(np.float32)),
                               _t(edges.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JG.apply_bins_device(jnp.asarray(X, jnp.float32),
                             jnp.asarray(edges, jnp.float32))))


def test_device_binning_nan_matches_host():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(200, 3))
    edges = TG.quantile_edges(X, 8)
    X[5, 0] = np.nan
    X[17, 2] = np.nan
    host = TG.apply_bins(X, edges)
    np.testing.assert_array_equal(host, JG.apply_bins(X, edges))
    got = TG.apply_bins_device(_t(X.astype(np.float32)),
                               _t(edges.astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), host)
    assert got[5, 0] == edges.shape[1] and got[17, 2] == edges.shape[1]


def _bin_data(n=3000, d=6, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = ((X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.1 * rng.normal(size=n))
         > 0.4).astype(np.float64)
    return X, y


def _friedman(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 5))
    y = (10 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 20 * (X[:, 2] - 0.5) ** 2
         + 10 * X[:, 3] + 5 * X[:, 4])
    return X, y


@pytest.fixture(scope="module")
def jax_forest():
    X, y = _bin_data()
    cfg = JG.GBTConfig(num_trees=5, max_depth=3, max_bins=32)
    return X, y, JG.train_forest(X, y, _logistic, 0.0, cfg)


def test_tree_walk_and_routing_match_jax(jax_forest):
    X, _, forest = jax_forest
    binned = JG.apply_bins(X, forest.bin_edges)
    depth = 3
    for t in range(forest.feature.shape[0]):
        f, thr, v = (forest.feature[t], forest.threshold[t],
                     forest.value[t])
        want = np.asarray(JG._predict_tree_jit(
            jnp.asarray(binned), jnp.asarray(f), jnp.asarray(thr),
            jnp.asarray(v), depth))
        got = TG._predict_tree_device(_t(binned), _t(f), _t(thr), _t(v),
                                      depth)
        np.testing.assert_array_equal(got.numpy(), want)
        for level in range(depth + 1):
            np.testing.assert_array_equal(
                TG._route_to_level(_t(binned), _t(f), _t(thr),
                                   level).numpy(),
                np.asarray(JG._route_to_level(
                    jnp.asarray(binned), jnp.asarray(f), jnp.asarray(thr),
                    level)))
    np.testing.assert_array_equal(
        TG._predict_tree(binned, forest.feature[0], forest.threshold[0],
                         forest.value[0], depth, device="cpu"),
        np.asarray(JG._predict_tree(binned, forest.feature[0],
                                    forest.threshold[0], forest.value[0],
                                    depth)))


# -------------------------------------------------------------- whole fits


def _tree_grads(forest, index, X, y, grad_hess, base_score):
    """The f32 (g, h) tree ``index`` of ``forest`` was grown on, replayed
    in float64 margins from the forest's earlier trees: ``index`` is ``t``
    for a binary or regression forest (``grad_hess``, ``base_score``), and
    ``(t, k)`` for a softmax forest (``y`` the class ids)."""
    binned = JG.apply_bins(X, forest.bin_edges)
    depth = int(np.log2(forest.feature.shape[-1] + 1)) - 1

    def tree_out(*ix):
        return np.asarray(JG._predict_tree(
            binned, forest.feature[ix], forest.threshold[ix],
            forest.value[ix], depth), np.float64)

    lr = forest.learning_rate
    if forest.feature.ndim == 2:
        margins = np.full(len(X), base_score)
        for s in range(index):
            margins = margins + lr * tree_out(s)
        g, h = grad_hess(y, margins)
    else:
        t, k = index
        margins = np.tile(forest.base_scores, (len(X), 1))
        for s in range(t):
            for c in range(forest.n_classes):
                margins[:, c] += lr * tree_out(s, c)
        p = JG._softmax_rows(margins)[:, k]
        g = p - (y == k)
        h = np.maximum(p * (1.0 - p), 1e-12)
    return binned, (np.asarray(a, np.float32).astype(np.float64)
                    for a in (g, h))


def _node_gains(binned, bins, feature_row, threshold_row, node, g, h,
                reg_lambda, min_child_weight):
    """Every candidate's gain at ``node`` of one tree, in float64:
    ``(d, bins)``."""
    level = int(np.log2(node + 1))
    ids = np.asarray(JG._route_to_level(
        jnp.asarray(binned), jnp.asarray(feature_row),
        jnp.asarray(threshold_row), level))
    rows = ids == node - (2 ** level - 1)
    d = binned.shape[1]
    G, H = np.zeros((d, bins)), np.zeros((d, bins))
    for f in range(d):
        np.add.at(G[f], binned[rows, f], g[rows])
        np.add.at(H[f], binned[rows, f], h[rows])
    GL, HL = G.cumsum(1), H.cumsum(1)
    Gt, Ht = G[0].sum(), H[0].sum()
    gain = (GL ** 2 / (HL + reg_lambda) + (Gt - GL) ** 2
            / (Ht - HL + reg_lambda) - Gt ** 2 / (Ht + reg_lambda))
    gain[(HL < min_child_weight) | (Ht - HL < min_child_weight)] = -np.inf
    gain[:, -1] = -np.inf
    return gain


def _same_forest(got, want, tol=FIT, replay=None):
    """Equal ``feature`` and ``threshold``; ``value`` within ``tol``.  With
    ``replay = (X, y, grad_hess, base_score, reg_lambda,
    min_child_weight)``, a threshold may differ only at a node that splits
    in neither forest (its threshold takes part in no routing and no
    prediction) and only where the two thresholds' best gains are a near
    tie: within 1e-6 relative of the node's best gain in float64, all of
    them <= 0 (ROADMAP C3's rule: show the tie, do not loosen)."""
    np.testing.assert_array_equal(got.feature, want.feature)
    for at in np.argwhere(got.threshold != want.threshold):
        at = tuple(int(i) for i in at)
        assert replay is not None, at
        assert got.feature[at] == want.feature[at] == -1, at
        X, y, grad_hess, base_score, reg_lambda, mcw = replay
        tree, node = at[:-1], at[-1]
        binned, (g, h) = _tree_grads(want, tree if len(tree) > 1
                                     else tree[0], X, y, grad_hess,
                                     base_score)
        gain = _node_gains(binned, want.bin_edges.shape[1] + 1,
                           want.feature[tree], want.threshold[tree], node,
                           g, h, reg_lambda, mcw)
        best = gain.max()
        assert best <= 0.0, (at, best)
        for thr in (got.threshold[at], want.threshold[at]):
            assert best - gain[:, thr].max() <= 1e-6 * abs(best), \
                (at, best, gain[:, thr].max())
    split = got.feature >= 0
    np.testing.assert_array_equal(got.threshold[split],
                                  want.threshold[split])
    np.testing.assert_allclose(got.value, want.value, **tol)
    np.testing.assert_array_equal(got.bin_edges, want.bin_edges)


@pytest.mark.parametrize("impl", ["segsum", "mxu"])
def test_train_forest_logistic_matches_jax(jax_forest, impl, monkeypatch):
    X, y, want = jax_forest
    monkeypatch.setattr(TG, "HIST_IMPL", impl)
    got = TG.train_forest(X, y, _logistic, 0.0,
                          TG.GBTConfig(num_trees=5, max_depth=3,
                                       max_bins=32), device="cpu")
    _same_forest(got, want)
    assert got.base_score == want.base_score
    assert got.learning_rate == want.learning_rate
    np.testing.assert_allclose(TG.predict_forest(X, got, device="cpu"),
                               JG.predict_forest(X, want), **FIT)


def test_train_forest_squared_matches_jax():
    X, y = _friedman()
    jcfg = JG.GBTConfig(num_trees=8, max_depth=4, learning_rate=0.2)
    want = JG.train_forest(X, y, _squared, float(y.mean()), jcfg)
    got = TG.train_forest(X, y, _squared, float(y.mean()),
                          TG.GBTConfig(num_trees=8, max_depth=4,
                                       learning_rate=0.2), device="cpu")
    _same_forest(got, want)
    np.testing.assert_allclose(TG.predict_forest(X, got, device="cpu"),
                               JG.predict_forest(X, want), **FIT)


def test_train_forest_softmax_matches_jax():
    X, _ = _bin_data(n=900, d=4, seed=5)
    y3 = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.3).astype(int)
    want = JG.train_forest_softmax(
        X, y3, 3, JG.GBTConfig(num_trees=4, max_depth=3, max_bins=16))
    got = TG.train_forest_softmax(
        X, y3, 3, TG.GBTConfig(num_trees=4, max_depth=3, max_bins=16),
        device="cpu")
    assert got.n_classes == 3
    _same_forest(got, want)
    np.testing.assert_array_equal(got.base_scores, want.base_scores)
    m_got = TG.predict_forest_softmax(X[:37], got, device="cpu")
    np.testing.assert_allclose(m_got, JG.predict_forest_softmax(X[:37],
                                                                want),
                               **FIT)
    probs = TG._softmax_rows(m_got)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-9)


def _reader(X, y, batch):
    def make_reader():
        def gen():
            for s in range(0, len(X), batch):
                yield {"features": X[s:s + batch], "label": y[s:s + batch]}
        return gen()
    return make_reader


def test_train_forest_outofcore_matches_jax(tmp_path):
    X, y = _bin_data()
    make_reader = _reader(X, y, 700)
    want = JG.train_forest_outofcore(
        make_reader, _logistic, 0.0,
        JG.GBTConfig(num_trees=5, max_depth=3, max_bins=32),
        work_dir=str(tmp_path / "j"), sample_rows=2048,
        batch_device_rows=512)
    got = TG.train_forest_outofcore(
        make_reader, _logistic, 0.0,
        TG.GBTConfig(num_trees=5, max_depth=3, max_bins=32),
        work_dir=str(tmp_path / "t"), sample_rows=2048,
        batch_device_rows=512, device="cpu")
    _same_forest(got, want)
    np.testing.assert_allclose(TG.predict_forest(X, got, device="cpu"),
                               JG.predict_forest(X, want), **FIT)


@pytest.mark.parametrize("impl", ["segsum", "mxu"])
def test_outofcore_chunked_matches_w1(tmp_path, impl, monkeypatch):
    """``tests/test_chunked_dispatch.py::test_gbt_outofcore_chunked_matches_w1``
    on the port: 12 batches of 256 rows, so W 8 runs 2 chunks (the second
    ragged and padded) and W 3 runs 4; bit for bit against W 1."""
    monkeypatch.setattr(TG, "HIST_IMPL", impl)
    rng = np.random.default_rng(3)
    n, d = 3000, 6
    X = rng.normal(size=(n, d))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    forests = {}
    for W in (1, 3, 8):
        cfg = TG.GBTConfig(num_trees=3, max_depth=3, max_bins=16,
                           steps_per_dispatch=W)
        forests[W] = TG.train_forest_outofcore(
            _reader(X, y, 640), _logistic, 0.0, cfg,
            work_dir=str(tmp_path / f"gbt{W}"), batch_device_rows=256,
            device="cpu")
    for W in (3, 8):
        np.testing.assert_array_equal(forests[W].feature,
                                      forests[1].feature)
        np.testing.assert_array_equal(forests[W].threshold,
                                      forests[1].threshold)
        np.testing.assert_array_equal(forests[W].value, forests[1].value)


def test_outofcore_matches_incore(tmp_path):
    """``tests/test_gbt.py::TestOutOfCore::test_matches_incore_forest`` on
    the port: the same tree structure, values and predictions within the
    reference's tolerance."""
    X, y = _bin_data()
    cfg = TG.GBTConfig(num_trees=5, max_depth=3, max_bins=32)
    incore = TG.train_forest(X, y, _logistic, 0.0, cfg, device="cpu")
    ooc = TG.train_forest_outofcore(
        _reader(X, y, 700), _logistic, 0.0, cfg,
        work_dir=str(tmp_path / "w"), sample_rows=len(X), device="cpu")
    np.testing.assert_array_equal(ooc.feature, incore.feature)
    np.testing.assert_array_equal(ooc.threshold, incore.threshold)
    np.testing.assert_allclose(ooc.value, incore.value, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(TG.predict_forest(X, ooc, device="cpu"),
                               TG.predict_forest(X, incore, device="cpu"),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", ["segsum", "mxu"])
def test_repeated_fits_same_bits(tmp_path, impl, monkeypatch):
    monkeypatch.setattr(TG, "HIST_IMPL", impl)
    X, y = _bin_data(n=1200, d=4, seed=8)
    cfg = TG.GBTConfig(num_trees=3, max_depth=3, max_bins=16)
    a, b = (TG.train_forest(X, y, _logistic, 0.0, cfg, device="cpu")
            for _ in range(2))
    for k in ("feature", "threshold", "value"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    c, e = (TG.train_forest_outofcore(
        _reader(X, y, 500), _logistic, 0.0, cfg,
        work_dir=str(tmp_path / "w"), device="cpu") for _ in range(2))
    for k in ("feature", "threshold", "value"):
        np.testing.assert_array_equal(getattr(c, k), getattr(e, k))


def test_outofcore_workdir_reusable_and_cleaned(tmp_path):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(300, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    wd = str(tmp_path / "work")
    cfg = TG.GBTConfig(num_trees=2, max_depth=2, max_bins=8)
    for _ in range(2):   # same work_dir twice must not collide
        TG.train_forest_outofcore(lambda: iter([{"features": X,
                                                 "label": y}]),
                                  _logistic, 0.0, cfg, work_dir=wd,
                                  device="cpu")
    assert os.listdir(wd) == []   # run dirs removed on return
    with pytest.raises(ValueError, match="empty stream"):
        TG.train_forest_outofcore(lambda: iter([]), _logistic, 0.0, cfg,
                                  work_dir=wd, device="cpu")


def test_hist_impl_resolution(monkeypatch):
    assert TG.resolve_hist_impl() == "segsum"
    assert TG.resolve_hist_impl("auto") == "segsum"
    assert TG.resolve_hist_impl("mxu") == "mxu"
    assert TG.resolve_hist_impl("segsum") == "segsum"
    binned, ids, g, h, d, bins = _level_inputs(1, 2)
    monkeypatch.setattr(TG, "HIST_IMPL", "typo")
    with pytest.raises(KeyError):
        TG._level_histograms(_t(binned), _t(ids), _t(g), _t(h), 2, d, bins)


def test_entry_points_default_to_the_card():
    X, y = _bin_data(n=64, d=2)
    assert GBTClassifier().device == GBTRegressor().device == "cuda"
    assert GBTClassifierModel().device == "cuda"
    if torch.cuda.is_available():
        return
    table = T.Table({"features": X, "label": y})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GBTClassifier().set_max_iter(1).fit(table)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.train_forest(X, y, _logistic, 0.0, TG.GBTConfig(num_trees=1))


# -------------------------------------------------------------- estimators


def _xor(n=400, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 2))
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.int64)
    return X, y


def _out(model, table):
    return model.transform(table)[0]


def test_classifier_binary_matches_jax():
    X, y = _xor()
    labels = np.where(y == 1, "yes", "no")
    jm = JGBTC().set_max_iter(10).set_max_depth(3).set_learning_rate(
        0.3).fit(J.Table({"features": X, "label": labels}))
    tm = GBTClassifier(device="cpu").set_max_iter(10).set_max_depth(
        3).set_learning_rate(0.3).fit(T.Table({"features": X,
                                               "label": labels}))
    assert tm._soft is None and tm.device == "cpu"
    # the XOR quadrants are pure at depth 2: every candidate there splits
    # off the same rows, so the (unused) thresholds of those non-splitting
    # nodes are exact ties in float64
    je = JGBTC()
    y01 = (labels == "yes").astype(np.float64)
    _same_forest(tm._forest, jm._forest, replay=(
        X, y01, je._grad_hess, je._base_score(y01), 1.0, 1e-3))
    jo, to = (_out(jm, J.Table({"features": X})),
              _out(tm, T.Table({"features": X})))
    np.testing.assert_array_equal(to["prediction"], jo["prediction"])
    np.testing.assert_allclose(to["rawPrediction"], jo["rawPrediction"],
                               **FIT)
    assert (to["prediction"] == labels).mean() > 0.9


def test_classifier_multiclass_matches_jax():
    rng = np.random.default_rng(42)
    n = 60
    centers = np.asarray([[0.0, 0.0], [6.0, 0.0], [0.0, 6.0]])
    X = np.concatenate([rng.normal(size=(n, 2)) * 0.5 + c for c in centers])
    y = np.repeat(["alpha", "beta", "gamma"], n)
    jm = JGBTC().set_max_iter(4).set_max_depth(3).set_learning_rate(
        0.3).fit(J.Table({"features": X, "label": y}))
    tm = GBTClassifier(device="cpu").set_max_iter(4).set_max_depth(
        3).set_learning_rate(0.3).fit(T.Table({"features": X, "label": y}))
    assert tm._soft is not None and tm._soft.n_classes == 3
    # separated blobs: the depth-2 nodes are pure, their (unused)
    # thresholds ties, as in the binary case
    _same_forest(tm._soft, jm._soft, replay=(
        X, np.unique(y, return_inverse=True)[1], None, None, 1.0, 1e-3))
    jo, to = _out(jm, J.Table({"features": X})), _out(tm, T.Table(
        {"features": X}))
    np.testing.assert_array_equal(to["prediction"], jo["prediction"])
    np.testing.assert_allclose(to["rawPrediction"], jo["rawPrediction"],
                               **FIT)
    np.testing.assert_allclose(to["rawPrediction"].sum(axis=1), 1.0,
                               atol=1e-9)
    assert (to["prediction"] == y).mean() > 0.98


def test_regressor_matches_jax():
    X, y = _friedman(n=800, seed=1)
    jm = JGBTR().set_max_iter(6).set_max_depth(3).set_learning_rate(
        0.3).fit(J.Table({"features": X, "label": y}))
    tm = GBTRegressor(device="cpu").set_max_iter(6).set_max_depth(
        3).set_learning_rate(0.3).fit(T.Table({"features": X, "label": y}))
    _same_forest(tm._forest, jm._forest)
    np.testing.assert_allclose(
        _out(tm, T.Table({"features": X}))["prediction"],
        _out(jm, J.Table({"features": X}))["prediction"], **FIT)


def test_estimator_fit_outofcore_matches_jax(tmp_path):
    X, y = _bin_data(n=2000)
    est_args = dict(iters=5, depth=3, bins=32)

    def est(cls, **kw):
        return (cls(**kw).set_max_iter(est_args["iters"])
                .set_max_depth(est_args["depth"])
                .set_max_bins(est_args["bins"]))

    make_reader = _reader(X, y, 500)
    jm = est(JGBTC).fit_outofcore(make_reader, work_dir=str(tmp_path / "j"))
    tm = est(GBTClassifier, device="cpu").fit_outofcore(
        make_reader, work_dir=str(tmp_path / "t"))
    _same_forest(tm._forest, jm._forest)
    np.testing.assert_array_equal(tm._labels, [0.0, 1.0])
    pred = _out(tm, T.Table({"features": X}))["prediction"]
    np.testing.assert_array_equal(
        pred, _out(jm, J.Table({"features": X}))["prediction"])
    # the streamed fit's predictions equal the in-core fit's
    m_in = est(GBTClassifier, device="cpu").fit(T.Table({"features": X,
                                                         "label": y}))
    np.testing.assert_array_equal(
        pred, _out(m_in, T.Table({"features": X}))["prediction"])


def test_streaming_rejects_arbitrary_labels(tmp_path):
    X, _ = _bin_data(n=100)
    y = np.where(X[:, 0] > 0, 3.0, 7.0)
    with pytest.raises(ValueError, match="0/1 labels"):
        GBTClassifier(device="cpu").fit_outofcore(
            lambda: iter([{"features": X, "label": y}]),
            work_dir=str(tmp_path / "w"))


def test_empty_fit_and_missing_model_rejected():
    with pytest.raises(ValueError):
        GBTRegressor(device="cpu").fit(T.Table({"features": np.zeros((0, 2)),
                                                "label": np.zeros(0)}))
    with pytest.raises(RuntimeError, match="no model data"):
        GBTRegressorModel(device="cpu").transform(
            T.Table({"features": np.zeros((2, 2))}))


def test_set_model_data_replaces_representation():
    rng = np.random.default_rng(42)
    X = rng.normal(size=(90, 2))
    t3 = T.Table({"features": X, "label": (X[:, 0] > 0).astype(int)
                  + (X[:, 1] > 0).astype(int)})
    t2 = T.Table({"features": X, "label": (X[:, 0] > 0).astype(int)})
    m3 = GBTClassifier(device="cpu").set_max_iter(3).fit(t3)
    m2 = GBTClassifier(device="cpu").set_max_iter(3).fit(t2)
    m3.set_model_data(*m2.get_model_data())
    assert m3._soft is None
    np.testing.assert_array_equal(_out(m3, t2)["prediction"],
                                  _out(m2, t2)["prediction"])
    m2.set_model_data(*GBTClassifier(device="cpu").set_max_iter(3).fit(
        t3).get_model_data())
    assert m2._soft is not None and m2._forest is None


# ---------------------------------------------- persistence and conversion


def _fitted_pairs():
    """(name, JAX model, port model, table columns): binary, 3-class and
    regression fits of the same rows in both packages."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(240, 3))
    cases = {
        "binary": (JGBTC, GBTClassifier, (X[:, 0] > 0).astype(int)),
        "multiclass": (JGBTC, GBTClassifier, (X[:, 0] > 0).astype(int)
                       + (X[:, 1] > 0).astype(int)),
        "regressor": (JGBTR, GBTRegressor, X[:, 0] + X[:, 1] * X[:, 2]),
    }
    out = []
    for name, (jcls, tcls, y) in cases.items():
        cols = {"features": X, "label": y}
        jm = jcls().set_max_iter(3).set_max_depth(3).fit(J.Table(cols))
        tm = tcls(device="cpu").set_max_iter(3).set_max_depth(3).fit(
            T.Table(cols))
        out.append((name, jm, tm, {"features": X}))
    return out


def _prediction_cols(model):
    cols = [model.get_prediction_col()]
    if isinstance(model, (GBTClassifierModel, JGBTCM)):
        cols.append("rawPrediction")
    return cols


def _check_outputs(got, want, cols, exact=False):
    for c in cols:
        if exact or got[c].dtype.kind not in "fc":
            np.testing.assert_array_equal(got[c], want[c])
        else:
            np.testing.assert_allclose(got[c], want[c], **FIT)


def test_save_load_both_ways(tmp_path):
    for name, jm, tm, cols in _fitted_pairs():
        cols_ = _prediction_cols(tm)
        jt, tt = J.Table(cols), T.Table(cols)
        # JAX-saved loads in the port
        jm.save(str(tmp_path / f"{name}_jax"))
        loaded = TP.load_stage(str(tmp_path / f"{name}_jax"), device="cpu")
        assert type(loaded).__name__ == type(jm).__name__
        assert loaded.device == "cpu"
        _check_outputs(_out(loaded, tt), _out(jm, jt), cols_)
        # port-saved loads in the port bit for bit, and in the JAX package
        tm.save(str(tmp_path / f"{name}_port"))
        again = type(tm).load(str(tmp_path / f"{name}_port"), device="cpu")
        _check_outputs(_out(again, tt), _out(tm, tt), cols_, exact=True)
        meta_path = tmp_path / f"{name}_port" / "metadata"
        meta = json.loads(meta_path.read_text())
        assert meta["className"].startswith("flink_ml_tpu_torch.")
        shutil.copytree(tmp_path / f"{name}_port", tmp_path / f"{name}_j2")
        meta["className"] = "flink_ml_tpu." + \
            meta["className"][len("flink_ml_tpu_torch."):]
        (tmp_path / f"{name}_j2" / "metadata").write_text(json.dumps(meta))
        back = type(jm).load(str(tmp_path / f"{name}_j2"))
        _check_outputs(_out(back, jt), _out(tm, tt), cols_)


def test_estimator_save_load(tmp_path):
    est = GBTClassifier(device="cpu").set_max_iter(7).set_max_depth(2)
    est.save(str(tmp_path / "e"))
    back = GBTClassifier.load(str(tmp_path / "e"), device="cpu")
    assert back.get_max_iter() == 7 and back.get_max_depth() == 2
    assert back.device == "cpu"
    JGBTR().set_max_iter(4).set_reg_lambda(0.5).save(str(tmp_path / "j"))
    jback = GBTRegressor.load(str(tmp_path / "j"), device="cpu")
    assert isinstance(jback, GBTRegressor)
    assert jback.get_max_iter() == 4 and jback.get_reg_lambda() == 0.5


def test_model_data_from_jax_and_pipelines():
    for name, jm, tm, cols in _fitted_pairs():
        conv = model_data_from_jax(jm, device="cpu")
        assert type(conv) is type(tm) and conv.device == "cpu"
        cols_ = _prediction_cols(tm)
        _check_outputs(_out(conv, T.Table(cols)), _out(jm, J.Table(cols)),
                       cols_)
    with pytest.raises(TypeError):
        model_data_from_jax(object(), device="cpu")
    # a JAX pipeline StandardScaler -> GBTClassifier carried across
    from flink_ml_tpu.models.feature import StandardScaler as JScaler

    rng = np.random.default_rng(2)
    X = rng.normal(size=(300, 3)) * 4 + 1
    cols = {"raw": X, "label": (X[:, 0] + X[:, 1] > 2).astype(int)}
    jpm = J.Pipeline([
        JScaler().set_features_col("raw").set_output_col("features"),
        JGBTC().set_max_iter(4).set_max_depth(3)]).fit(J.Table(cols))
    tpm = pipeline_model_from_jax(jpm, device="cpu")
    assert [type(s).__name__ for s in tpm.stages] == [
        "StandardScalerModel", "GBTClassifierModel"]
    got = tpm.transform(T.Table({"raw": X}))[0]
    want = jpm.transform(J.Table({"raw": X}))[0]
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               **FIT)


# ----------------------------------------------------------------- serving


def test_served_gbt_equals_transform(tmp_path):
    X, y = _xor(n=300, seed=4)
    model = GBTClassifier(device="cpu").set_max_iter(5).set_max_depth(
        3).fit(T.Table({"features": X, "label": y}))
    path = str(tmp_path / "gbt")
    model.save(path)
    registry = ModelRegistry(device="cpu")
    feats = T.Table({"features": X})
    registry.deploy("gbt", path, feats.take(1), max_batch_rows=64)
    endpoint = ServingEndpoint(registry, "gbt", max_wait_ms=0.5).start()
    try:
        for n in (1, 3, 8, 17, 64):
            req = T.Table({"features": X[n:2 * n]})
            served = endpoint.predict(req, timeout=60)
            offline = model.transform(req)[0]
            for col in ("prediction", "rawPrediction"):
                np.testing.assert_array_equal(served[col], offline[col])
    finally:
        endpoint.close()


PORTED_MODULES = (
    "flink_ml_tpu_torch.models.common.gbt",
    "flink_ml_tpu_torch.models.common.gbt_stage",
    "flink_ml_tpu_torch.models.classification.gbtclassifier",
    "flink_ml_tpu_torch.models.regression.gbtregressor",
    "flink_ml_tpu_torch.models.classification.naivebayes",
    "flink_ml_tpu_torch.models.classification.knn",
    "flink_ml_tpu_torch.models.classification.onevsrest")


def test_ported_modules_import_without_jax():
    """The boosted trees and the instance classifiers load neither JAX
    nor the JAX package."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, " + ", ".join(PORTED_MODULES) + "; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         timeout=300).stdout.split()
    assert set(PORTED_MODULES) <= set(out)
    assert [m for m in out
            if m.split(".")[0] in ("jax", "jaxlib", "flink_ml_tpu")] == []
