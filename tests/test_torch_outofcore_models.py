"""The port's streamed KMeans and Wide&Deep fits against the JAX package's,
on the CPU, over the same ``DataCacheReader`` caches.

Tolerances:

- ``kmeans_fit_outofcore``: the centroids within ``rtol=1e-5, atol=1e-6``
  of the JAX fit (the f32 window sums add in another order), and within
  ``atol=1e-5`` of the port's in-memory Lloyd's from the same init on the
  concatenated rows (``tests/test_kmeans.py:257-310``'s tolerance).
- ``WideDeep.fit_outofcore``: ``tests/test_torch_widedeep.py``'s one-epoch
  tolerances against the JAX streamed fit (loss ``rtol=2e-5, atol=1e-6``,
  table parameters ``rtol=1e-3, atol=1e-3``); within the port, W in
  (1, 3, 8) and a killed-and-resumed fit are bit for bit (tolerance 0),
  dense and lazy (``tests/test_chunked_dispatch.py:181-206``).

The JAX fits run on a one-device mesh: the port is single-device.
"""

import jax
import numpy as np
import pytest
import torch

import flink_ml_tpu_torch as T
from flink_ml_tpu.data import datacache as JD
from flink_ml_tpu.models.clustering import kmeans as JKM
from flink_ml_tpu.models.recommendation import widedeep as JWD
from flink_ml_tpu.parallel.mesh import device_mesh
from flink_ml_tpu_torch.data import datacache as TD
from flink_ml_tpu_torch.distance import DistanceMeasure
from flink_ml_tpu_torch.iteration import CheckpointConfig
from flink_ml_tpu_torch.models.clustering import kmeans as TKM
from flink_ml_tpu_torch.models.recommendation import widedeep as TWD
from flink_ml_tpu_torch.robustness import (
    FaultPlan,
    RecoveryReport,
    RetryPolicy,
    resilient_fit,
)

KM_RTOL, KM_ATOL = 1e-5, 1e-6
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-3, atol=1e-3)
TABLE_KEYS = ("emb", "wide_cat", "wide_dense", "wide_b")


def _mesh1():
    return device_mesh({"data": 1}, devices=jax.devices()[:1])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _assert_bits(a, b):
    for x, y in zip(_leaves(a._params), _leaves(b._params), strict=True):
        np.testing.assert_array_equal(x, y)
    assert a.loss_log == b.loss_log


# ----------------------------------------------------------------- KMeans

def _km_cache(tmp_path, n, d, seed=0, segment_rows=4096):
    pts = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    cache = str(tmp_path / "km")
    w = TD.DataCacheWriter(cache, segment_rows=segment_rows)
    w.append({"features": pts})
    w.finish()
    return cache, pts


@pytest.mark.parametrize("n,d,k,batch,iters,impl", [
    (1000, 6, 5, 256, 5, "plain"),        # ragged tail of 232 rows
    (65536 + 700, 4, 4, 65536, 3, "kernel"),   # the stats kernel's plan
])
def test_kmeans_outofcore_matches_jax(tmp_path, n, d, k, batch, iters, impl):
    """The same cache through both packages' streamed Lloyd's; at >= 65536
    rows a batch the port plans the stats kernel (its plain version on the
    CPU), and the ragged tail runs at its own size."""
    cache, _ = _km_cache(tmp_path, n, d, segment_rows=max(4096, batch))
    want = JKM.kmeans_fit_outofcore(
        lambda: JD.DataCacheReader(cache, batch_rows=batch), k,
        max_iter=iters, seed=2, mesh=_mesh1())
    info = {}
    got = TKM.kmeans_fit_outofcore(
        lambda: TD.DataCacheReader(cache, batch_rows=batch), k,
        max_iter=iters, seed=2, device="cpu", info=info)
    assert info["impl"] == impl and info["batch_rows"] == batch
    assert len(info["epoch_seconds"]) == iters
    np.testing.assert_allclose(got, want, rtol=KM_RTOL, atol=KM_ATOL)


def _batches(pts, batch):
    def gen():
        for s in range(0, len(pts), batch):
            yield {"features": pts[s:s + batch]}
    return gen


def test_kmeans_outofcore_matches_incore_lloyd():
    """Per-batch accumulation reproduces the in-memory Lloyd's update from
    the same init on the concatenated rows (a layout change, not a math
    change)."""
    pts = np.random.default_rng(0).normal(size=(257, 5)).astype(np.float32)
    k, iters, batch = 4, 6, 64
    got = TKM.kmeans_fit_outofcore(_batches(pts, batch), k, max_iter=iters,
                                   seed=3, device="cpu")
    measure = DistanceMeasure.get_instance("euclidean")
    init = torch.from_numpy(TKM.select_random_centroids(pts[:batch], k, 3))
    result = TKM.fit_centroids(
        torch.from_numpy(pts), torch.ones(len(pts)), init,
        TKM._fit_plan(len(pts), 5, k, measure), measure=measure,
        max_iter=iters)
    np.testing.assert_allclose(got, result.state.numpy(), atol=1e-5)


def test_kmeans_outofcore_epoch_aware_shuffled_reader(tmp_path):
    """An epoch-aware ShuffledCacheReader factory: each Lloyd's round gets
    its epoch number, the fit recovers the generating centers, and it
    equals the JAX fit over the same shuffled reader."""
    rng = np.random.default_rng(4)
    centers = np.array([[0.0, 0.0], [8.0, 8.0], [-8.0, 8.0]], np.float32)
    pts = np.concatenate([
        centers[i] + rng.normal(scale=0.3, size=(200, 2)).astype(np.float32)
        for i in range(3)])
    rng.shuffle(pts)
    cache = str(tmp_path / "kmshuf")
    w = TD.DataCacheWriter(cache, segment_rows=256)
    w.append({"features": pts})
    w.finish()
    seen = []

    def factory(epoch):
        seen.append(epoch)
        return TD.ShuffledCacheReader(cache, batch_rows=128, seed=3,
                                      epoch=epoch)

    got = TKM.kmeans_fit_outofcore(factory, k=3, max_iter=8, seed=1,
                                   device="cpu")
    assert seen == list(range(8))
    d = np.linalg.norm(got[:, None, :] - centers[None, :, :], axis=-1)
    assert d.min(axis=0).max() < 0.5
    want = JKM.kmeans_fit_outofcore(
        lambda epoch: JD.ShuffledCacheReader(cache, batch_rows=128, seed=3,
                                             epoch=epoch),
        k=3, max_iter=8, seed=1, mesh=_mesh1())
    np.testing.assert_allclose(got, want, rtol=KM_RTOL, atol=KM_ATOL)


def test_kmeans_outofcore_estimator_and_errors(tmp_path):
    cache, pts = _km_cache(tmp_path, 600, 3, seed=5)
    est = T.KMeans(device="cpu").set_k(3).set_max_iter(4).set_seed(1)
    model = est.fit_outofcore(lambda: TD.DataCacheReader(cache,
                                                         batch_rows=128))
    assert est.planned_impl == model.planned_impl == "plain"
    want = JKM.KMeans().set_k(3).set_max_iter(4).set_seed(1).fit_outofcore(
        lambda: JD.DataCacheReader(cache, batch_rows=128), mesh=_mesh1())
    np.testing.assert_allclose(
        model.get_model_data()[0]["centroids"][0],
        np.asarray(want.get_model_data()[0]["centroids"][0]),
        rtol=KM_RTOL, atol=KM_ATOL)
    pred = model.transform(T.Table({"features": pts}))[0]["prediction"]
    assert pred.shape == (600,) and set(np.unique(pred)) <= {0, 1, 2}
    with pytest.raises(ValueError, match="empty"):
        TKM.kmeans_fit_outofcore(lambda: iter(()), 2, max_iter=2,
                                 device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        TKM.kmeans_fit_outofcore(lambda: iter(()), 2, mesh=object(),
                                 device="cpu")


# ------------------------------------------------------------- Wide&Deep

def _wd_cols(n=500, seed=5):
    """``tests/test_chunked_dispatch.py::_wd_cache``'s data."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, 10, n),
                    rng.integers(0, 7, n)], axis=1).astype(np.int32)
    logits = dense[:, 0] + 0.3 * (cat[:, 0] % 3) - 0.5
    y = (logits > 0).astype(np.float32)
    return {"denseFeatures": dense, "catFeatures": cat, "label": y}


def _wd_cache(tmp_path, n=500):
    cache = str(tmp_path / "wd")
    w = TD.DataCacheWriter(cache, segment_rows=256)
    w.append(_wd_cols(n))
    w.finish()
    return cache


def _wd_fit(cache, lazy, iters=4, W=8, **kw):
    est = (T.WideDeep(device="cpu").set_vocab_sizes([10, 7])
           .set_max_iter(iters).set_seed(0)
           .set(T.WideDeep.LAZY_EMB_OPT, lazy))
    return est.fit_outofcore(
        lambda: TD.DataCacheReader(cache, batch_rows=128),
        steps_per_dispatch=W, **kw)


@pytest.mark.parametrize("lazy", [False, True])
def test_widedeep_outofcore_matches_jax(tmp_path, lazy):
    """One streamed epoch (4 Adam steps, the last on a padded batch) of
    both packages from the same init draws."""
    cache = _wd_cache(tmp_path)
    got = _wd_fit(cache, lazy, iters=1)
    want = (JWD.WideDeep().set_vocab_sizes([10, 7]).set_max_iter(1)
            .set_seed(0).set(JWD.WideDeep.LAZY_EMB_OPT, lazy)
            .fit_outofcore(lambda: JD.DataCacheReader(cache, batch_rows=128),
                           mesh=_mesh1()))
    np.testing.assert_allclose(got.loss_log, want._loss_log, **LOSS_TOL)
    for k in TABLE_KEYS:
        np.testing.assert_allclose(got._params[k],
                                   np.asarray(want._params[k]),
                                   err_msg=k, **PARAM_TOL)
    for a, b in zip(got._params["mlp"], want._params["mlp"]):
        np.testing.assert_allclose(a["w"], np.asarray(b["w"]), **PARAM_TOL)


@pytest.mark.parametrize("lazy", [False, True])
def test_widedeep_outofcore_chunked_bitexact(tmp_path, lazy):
    """W in (1, 3, 8) on a 4-batch epoch (a padded final chunk at W 3 and
    8): parameters and loss logs bit for bit."""
    cache = _wd_cache(tmp_path)
    ref = _wd_fit(cache, lazy, W=1)
    for W in (3, 8):
        _assert_bits(_wd_fit(cache, lazy, W=W), ref)


@pytest.mark.parametrize("lazy", [False, True])
def test_widedeep_outofcore_kill_and_resume_bitexact(tmp_path, lazy):
    """A reader that dies fetching batch 6 (epoch 1's third), healed by
    ``resilient_fit`` from a ``checkpoint_every_steps=2`` cut: the resumed
    fit equals the uninterrupted one bit for bit."""
    cache = _wd_cache(tmp_path)
    ref = _wd_fit(cache, lazy, iters=3, W=2)
    plan = FaultPlan().inject("source.pull", at=6, kind="crash")
    est = (T.WideDeep(device="cpu").set_vocab_sizes([10, 7]).set_max_iter(3)
           .set_seed(0).set(T.WideDeep.LAZY_EMB_OPT, lazy))
    report = RecoveryReport()
    with plan:
        healed = resilient_fit(
            est.fit_outofcore,
            lambda: plan.wrap_source(TD.DataCacheReader(cache,
                                                        batch_rows=128)),
            checkpoint=CheckpointConfig(str(tmp_path / "ck")),
            checkpoint_every_steps=2, steps_per_dispatch=2, max_restarts=1,
            report=report, backoff=RetryPolicy(sleep=lambda s: None))
    assert report.restarts == 1 and plan.fires
    _assert_bits(healed, ref)


def _wd_cols_ctr(n, seed=0):
    """``tests/test_widedeep.py::_ctr_table``'s data."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 4)).astype(np.float32)
    cat = np.stack([rng.integers(0, 10, size=n),
                    rng.integers(0, 7, size=n)], axis=1).astype(np.int32)
    logit = (cat[:, 0] - 4.5) * 1.2 + dense[:, 0] * 2.0
    label = (logit + 0.3 * rng.normal(size=n) > 0).astype(np.int64)
    return {"denseFeatures": dense, "catFeatures": cat, "label": label}


def test_widedeep_outofcore_partial_batch_and_lazy(tmp_path):
    """Ragged final batch (padding rows) + lazyEmbeddingOptimizer: the
    padded rows are inert and training still converges
    (``tests/test_widedeep.py:331-349``)."""
    cols = _wd_cols_ctr(500)
    cache = str(tmp_path / "wdlazy")
    w = TD.DataCacheWriter(cache, segment_rows=256)
    w.append({**cols, "label": cols["label"].astype(np.float32)})
    w.finish()
    model = (T.WideDeep(device="cpu").set_vocab_sizes([10, 7])
             .set_max_iter(10).set(T.WideDeep.LAZY_EMB_OPT, True)
             .fit_outofcore(lambda: TD.DataCacheReader(cache,
                                                       batch_rows=128)))
    out = model.transform(T.Table(cols))[0]
    assert np.mean(out["prediction"] == cols["label"]) > 0.8
    assert model.loss_log[-1] < model.loss_log[0]


def test_widedeep_outofcore_errors(tmp_path):
    est = T.WideDeep(device="cpu").set_vocab_sizes([10, 7])
    with pytest.raises(ValueError, match="not replayed"):
        (T.WideDeep(device="cpu").set_vocab_sizes([10, 7])
         .set(T.WideDeep.ROUTED_EMB_GRAD, "on")
         .fit_outofcore(lambda: iter(())))
    with pytest.raises(ValueError, match="empty epoch"):
        est.fit_outofcore(lambda: iter(()))
    with pytest.raises(ValueError, match="vocabSizes"):
        T.WideDeep(device="cpu").fit_outofcore(lambda: iter(()))


def test_fixed_order_rows_gradient_equals_index_select():
    """The fixed-order gather's backward is the scatter-add of autograd's
    own ``index_select`` backward (bit for bit on the CPU, where both add
    serially)."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 40, size=200))
    up = torch.from_numpy(rng.normal(size=(200, 3)).astype(np.float32))
    a = table.clone().requires_grad_(True)
    (TWD._FixedOrderRows.apply(a, ids) * up).sum().backward()
    b = table.clone().requires_grad_(True)
    (torch.index_select(b, 0, ids) * up).sum().backward()
    assert torch.equal(a.grad, b.grad)
    assert torch.equal(TWD._rows(table, ids.reshape(50, 4)),
                       torch.index_select(table, 0, ids).reshape(50, 4, 3))
