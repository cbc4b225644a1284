"""The port's instance and wrapper classifiers (``NaiveBayes``,
``KNNClassifier``, ``OneVsRest``) against the JAX package's on the same
seeded numpy inputs, both on the CPU.

Tolerances: predictions are equal; NaiveBayes' f32 scores equal the JAX
package's within ``rtol 1e-6`` (one product each, summed in another
order); OneVsRest's per-class scores within the one-fit tolerance of the
linear family (``rtol 1e-5, atol 1e-6``).  Saves load in the other
package, and converted models compute what the JAX models do."""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flink_ml_tpu as J
import flink_ml_tpu.models.classification as JC
import flink_ml_tpu.models.classification.knn as JK
import flink_ml_tpu.models.classification.naivebayes as JNB
import flink_ml_tpu_torch as T
import flink_ml_tpu_torch.models.classification as TC
import flink_ml_tpu_torch.models.classification.knn as TK
import flink_ml_tpu_torch.models.classification.naivebayes as TNB
from flink_ml_tpu_torch.distance import DistanceMeasure
from flink_ml_tpu_torch.utils import persist as TP
from flink_ml_tpu_torch.utils.convert import (model_data_from_jax,
                                              onevsrest_model_from_jax,
                                              pipeline_model_from_jax)

FIT = dict(rtol=1e-5, atol=1e-6)


def _tables(cols):
    return J.Table(cols), T.Table(cols)


def _pred(model, table):
    return np.asarray(model.transform(table)[0]["prediction"])


def _for_jax(tmp_path, name, src):
    """A copy of the port-saved directory ``src`` whose metadata names the
    JAX package's classes."""
    dst = tmp_path / name
    shutil.copytree(src, dst)
    for meta_path in dst.rglob("metadata"):
        meta = json.loads(meta_path.read_text())
        assert meta["className"].startswith("flink_ml_tpu_torch.")
        meta["className"] = "flink_ml_tpu." + \
            meta["className"][len("flink_ml_tpu_torch."):]
        meta_path.write_text(json.dumps(meta))
    return str(dst)


# -------------------------------------------------------------- NaiveBayes


def _count_cols(n=600, seed=0, labels=None):
    """Two classes with distinct word distributions (and one word class 1
    never uses, so smoothing 0 gives -inf log-likelihoods)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n)
    theta = np.array([[0.5, 0.2, 0.1, 0.1, 0.1],
                      [0.1, 0.1, 0.2, 0.6, 0.0]])
    X = np.stack([rng.multinomial(30, theta[c]) for c in y]).astype(
        np.float64)
    return {"features": X, "label": y if labels is None else labels[y]}


@pytest.mark.parametrize("smoothing", [1.0, 0.5, 0.0])
def test_naivebayes_matches_jax(smoothing):
    cols = _count_cols()
    jt, tt = _tables(cols)
    jm = JC.NaiveBayes().set_smoothing(smoothing).fit(jt)
    tm = TC.NaiveBayes(device="cpu").set_smoothing(smoothing).fit(tt)
    assert tm.device == "cpu"
    np.testing.assert_array_equal(tm._log_theta, jm._log_theta)
    np.testing.assert_array_equal(tm._log_prior, jm._log_prior)
    np.testing.assert_array_equal(_pred(tm, tt), _pred(jm, jt))
    assert np.mean(_pred(tm, tt) == cols["label"]) > 0.95
    # the scores themselves: f32 products in both packages
    X = cols["features"].astype(np.float32)
    want = np.asarray(JNB._scores(jnp.asarray(X),
                                  jnp.asarray(jm._log_theta, jnp.float32),
                                  jnp.asarray(jm._log_prior, jnp.float32)))
    got = TNB._scores(torch.from_numpy(X),
                      torch.tensor(tm._log_theta, dtype=torch.float32),
                      torch.tensor(tm._log_prior, dtype=torch.float32))
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
    np.testing.assert_allclose(got.numpy()[finite], want[finite], rtol=1e-6)
    if smoothing == 0.0:
        assert np.isneginf(tm._log_theta).any()
        assert not np.isnan(got.numpy()).any()


def test_naivebayes_zero_smoothing_no_nan():
    X = np.array([[5.0, 0.0, 0.0], [0.0, 5.0, 0.0], [0.0, 0.0, 5.0]])
    y = np.array([0, 1, 2])
    tt = T.Table({"features": X, "label": y})
    model = TC.NaiveBayes(device="cpu").set_smoothing(0.0).fit(tt)
    np.testing.assert_array_equal(_pred(model, tt), y)


def test_naivebayes_string_labels_and_errors(tmp_path):
    cols = _count_cols(n=200, labels=np.array(["ham", "spam"]))
    jt, tt = _tables(cols)
    tm = TC.NaiveBayes(device="cpu").fit(tt)
    np.testing.assert_array_equal(_pred(tm, tt),
                                  _pred(JC.NaiveBayes().fit(jt), jt))
    bad = T.Table({"features": -np.ones((2, 5)), "label": np.zeros(2)})
    with pytest.raises(ValueError, match="non-negative"):
        TC.NaiveBayes(device="cpu").fit(bad)
    with pytest.raises(ValueError, match="non-negative"):
        tm.transform(bad)
    with pytest.raises(RuntimeError, match="no model data"):
        TC.NaiveBayesModel(device="cpu").get_model_data()
    with pytest.raises(RuntimeError, match="no model data"):
        TC.NaiveBayesModel(device="cpu").save(str(tmp_path / "nb"))
    assert not (tmp_path / "nb").exists()


def test_naivebayes_save_load_both_ways_and_conversion(tmp_path):
    cols = _count_cols(n=300, seed=3)
    jt, tt = _tables(cols)
    jm = JC.NaiveBayes().set_smoothing(0.5).fit(jt)
    tm = TC.NaiveBayes(device="cpu").set_smoothing(0.5).fit(tt)
    jm.save(str(tmp_path / "jax"))
    loaded = TP.load_stage(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, TC.NaiveBayesModel) and loaded.device == "cpu"
    assert loaded.get_smoothing() == 0.5
    np.testing.assert_array_equal(_pred(loaded, tt), _pred(jm, jt))
    tm.save(str(tmp_path / "port"))
    back = JC.NaiveBayesModel.load(_for_jax(tmp_path, "j2",
                                            tmp_path / "port"))
    np.testing.assert_array_equal(_pred(back, jt), _pred(tm, tt))
    conv = model_data_from_jax(jm, device="cpu")
    assert isinstance(conv, TC.NaiveBayesModel)
    np.testing.assert_array_equal(_pred(conv, tt), _pred(jm, jt))
    fresh = TC.NaiveBayesModel(device="cpu").set_model_data(
        *tm.get_model_data())
    fresh.copy_params_from(tm)
    np.testing.assert_array_equal(_pred(fresh, tt), _pred(tm, tt))


# --------------------------------------------------------------------- KNN


def _blobs(n_per=40, seed=0, d=2):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, d)) * 4
    X = np.concatenate([rng.normal(size=(n_per, d)) + c for c in centers])
    y = np.repeat([0, 1, 2], n_per)
    return {"features": X, "label": y}


@pytest.mark.parametrize("measure,k", [("euclidean", 5), ("euclidean", 1),
                                       ("cosine", 3), ("manhattan", 5)])
def test_knn_matches_jax(measure, k):
    rows = _blobs(n_per=90, seed=1, d=4)
    held = np.arange(len(rows["label"])) % 3 == 0
    train = {k: v[~held] for k, v in rows.items()}
    queries = {k: v[held] for k, v in rows.items()}
    jm = JC.KNNClassifier().set_k(k).set_distance_measure(measure).fit(
        J.Table(train))
    tm = TC.KNNClassifier(device="cpu").set_k(k).set_distance_measure(
        measure).fit(T.Table(train))
    np.testing.assert_array_equal(tm._train, jm._train)
    np.testing.assert_array_equal(tm._classes, jm._classes)
    jq, tq = _tables({"features": queries["features"]})
    np.testing.assert_array_equal(_pred(tm, tq), _pred(jm, jq))
    assert (_pred(tm, tq) == queries["label"]).mean() > 0.8


def test_knn_vote_matches_jax():
    """The chunk vote itself, with ties in the vote (k 4 over 2 classes)
    resolving to the smaller class index in both packages."""
    rng = np.random.default_rng(7)
    train = rng.normal(size=(64, 3)).astype(np.float32)
    cls = (np.arange(64) % 2).astype(np.int32)
    q = rng.normal(size=(16, 3)).astype(np.float32)
    measure = DistanceMeasure.get_instance("euclidean")
    jmeasure = JK.DistanceMeasure.get_instance("euclidean")
    got = TK._vote(measure, 4, 2, torch.from_numpy(q),
                   torch.from_numpy(train), torch.from_numpy(cls))
    want = JK._vote(jmeasure, 4, 2, jnp.asarray(q), jnp.asarray(train),
                    jnp.asarray(cls))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knn_chunking_and_clamped_k(monkeypatch):
    monkeypatch.setattr(TK, "_QUERY_CHUNK", 8)
    monkeypatch.setattr(JK, "_QUERY_CHUNK", 8)
    cols = _blobs(n_per=7)          # 21 rows: 2 chunks + remainder
    jt, tt = _tables(cols)
    tm = TC.KNNClassifier(device="cpu").set_k(3).fit(tt)
    pred = _pred(tm, tt)
    assert len(pred) == 21
    np.testing.assert_array_equal(pred,
                                  _pred(JC.KNNClassifier().set_k(3).fit(jt),
                                        jt))
    tiny = T.Table({"features": np.asarray([[0.0], [1.0], [1.1]],
                                           np.float32),
                    "label": np.asarray([0, 1, 1])})
    big_k = TC.KNNClassifier(device="cpu").set_k(100).fit(tiny)
    assert _pred(big_k, T.Table({"features": np.asarray(
        [[0.9]], np.float32)}))[0] == 1
    with pytest.raises(ValueError):
        TC.KNNClassifier(device="cpu").fit(T.Table(
            {"features": np.zeros((0, 2), np.float32),
             "label": np.zeros((0,))}))


def test_knn_save_load_both_ways_and_conversion(tmp_path):
    cols = _blobs(n_per=10, seed=4)
    labels = np.array(["a", "b", "c"])[cols["label"]]
    cols = {"features": cols["features"], "label": labels}
    jt, tt = _tables(cols)
    jm = JC.KNNClassifier().set_k(3).fit(jt)
    tm = TC.KNNClassifier(device="cpu").set_k(3).fit(tt)
    jm.save(str(tmp_path / "jax"))
    loaded = TP.load_stage(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, TC.KNNClassifierModel) and loaded.get_k() == 3
    np.testing.assert_array_equal(_pred(loaded, tt), _pred(jm, jt))
    tm.save(str(tmp_path / "port"))
    back = JC.KNNClassifierModel.load(_for_jax(tmp_path, "j2",
                                               tmp_path / "port"))
    np.testing.assert_array_equal(_pred(back, jt), _pred(tm, tt))
    conv = model_data_from_jax(jm, device="cpu")
    np.testing.assert_array_equal(_pred(conv, tt), _pred(jm, jt))
    est = TC.KNNClassifier(device="cpu").set_k(4)
    est.save(str(tmp_path / "est"))
    assert TC.KNNClassifier.load(str(tmp_path / "est"),
                                 device="cpu").get_k() == 4


# --------------------------------------------------------------- OneVsRest


def _ovr_cols(n=600, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.array([[2.0, 0.0], [-2.0, 1.0], [0.0, -2.5], [2.0, 2.5]])
    y = rng.integers(0, 4, size=n)
    X = centers[y] + 0.4 * rng.normal(size=(n, 2))
    # non-contiguous label VALUES to prove the inventory mapping
    return {"features": X, "label": np.array([10.0, 20.0, 30.0, 40.0])[y]}


def _lr(pkg, **kw):
    return (pkg.LogisticRegression(**kw).set_max_iter(20)
            .set_learning_rate(0.5).set_global_batch_size(128)
            .set_raw_prediction_col("rawPrediction"))


def test_onevsrest_lr_matches_jax():
    cols = _ovr_cols()
    jt, tt = _tables(cols)
    jm = JC.OneVsRest(_lr(JC)).fit(jt)
    tm = TC.OneVsRest(_lr(TC, device="cpu")).fit(tt)
    assert len(tm.models) == 4
    assert all(m.device == "cpu" for m in tm.models)
    np.testing.assert_array_equal(tm.label_values, jm.label_values)
    for a, b in zip(tm.models, jm.models):
        np.testing.assert_allclose(a._state.coefficients,
                                   np.asarray(b._state.coefficients),
                                   **FIT)
    jo, to = jm.transform(jt)[0], tm.transform(tt)[0]
    np.testing.assert_array_equal(to["prediction"], jo["prediction"])
    np.testing.assert_allclose(to["rawPrediction"], jo["rawPrediction"],
                               **FIT)
    assert (to["prediction"] == cols["label"]).mean() > 0.9


def test_onevsrest_errors():
    tt = T.Table(_ovr_cols(n=60))
    with pytest.raises(ValueError, match="set_classifier"):
        TC.OneVsRest().fit(tt)
    with pytest.raises(ValueError, match="rawPredictionCol"):
        TC.OneVsRest(TC.LogisticRegression(device="cpu")
                     .set_raw_prediction_col(None)).fit(tt)
    one = T.Table({"features": np.zeros((4, 2)), "label": np.ones(4)})
    with pytest.raises(ValueError, match=">= 2 label values"):
        TC.OneVsRest(_lr(TC, device="cpu")).fit(one)
    with pytest.raises(ValueError, match="no fitted sub-models"):
        TC.OneVsRestModel().transform(tt)


def test_onevsrest_save_load_both_ways_and_conversion(tmp_path):
    cols = _ovr_cols(n=300, seed=2)
    jt, tt = _tables(cols)
    jm = JC.OneVsRest(_lr(JC)).fit(jt)
    tm = TC.OneVsRest(_lr(TC, device="cpu")).fit(tt)
    jm.save(str(tmp_path / "jax"))
    loaded = TC.OneVsRestModel.load(str(tmp_path / "jax"), device="cpu")
    assert all(m.device == "cpu" for m in loaded.models)
    np.testing.assert_array_equal(_pred(loaded, tt), _pred(jm, jt))
    tm.save(str(tmp_path / "port"))
    back = JC.OneVsRestModel.load(_for_jax(tmp_path, "j2",
                                           tmp_path / "port"))
    np.testing.assert_array_equal(_pred(back, jt), _pred(tm, tt))
    conv = onevsrest_model_from_jax(jm, device="cpu")
    np.testing.assert_array_equal(_pred(conv, tt), _pred(jm, jt))
    np.testing.assert_allclose(conv.transform(tt)[0]["rawPrediction"],
                               jm.transform(jt)[0]["rawPrediction"],
                               rtol=1e-12)
    # the estimator keeps its base classifier through a save
    est = TC.OneVsRest(_lr(TC, device="cpu"))
    est.save(str(tmp_path / "est"))
    est_back = TC.OneVsRest.load(str(tmp_path / "est"), device="cpu")
    assert isinstance(est_back._classifier, TC.LogisticRegression)
    assert est_back._classifier.device == "cpu"
    assert est_back._classifier.get_max_iter() == 20


def test_pipeline_of_the_three_carried_from_jax():
    """``pipeline_model_from_jax`` carries each of the three (and a
    OneVsRest inside a pipeline) stage by stage."""
    from flink_ml_tpu.models.feature import StandardScaler as JScaler

    cols = _ovr_cols(n=200, seed=5)
    jt, tt = _tables(cols)
    for est in (JC.KNNClassifier().set_k(3),
                JC.OneVsRest(_lr(JC))):
        jpm = J.Pipeline([JScaler().set_output_col("scaled"),
                          est.set_features_col("scaled")]).fit(jt)
        tpm = pipeline_model_from_jax(jpm, device="cpu")
        assert type(tpm.stages[1]).__name__ == type(jpm.stages[1]).__name__
        np.testing.assert_array_equal(_pred(tpm, tt), _pred(jpm, jt))
    counts = _count_cols(n=100)
    jpm = J.Pipeline([JC.NaiveBayes()]).fit(J.Table(counts))
    tpm = pipeline_model_from_jax(jpm, device="cpu")
    np.testing.assert_array_equal(_pred(tpm, T.Table(counts)),
                                  _pred(jpm, J.Table(counts)))


def test_entry_points_default_to_the_card():
    for cls in (TC.NaiveBayes, TC.NaiveBayesModel, TC.KNNClassifier,
                TC.KNNClassifierModel):
        assert cls().device == "cuda"
    if torch.cuda.is_available():
        return
    cols = _count_cols(n=20)
    model = TC.NaiveBayes().fit(T.Table(cols))     # the fit is host numpy
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.transform(T.Table(cols))
    knn = TC.KNNClassifier().fit(T.Table(_blobs(n_per=3)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        knn.transform(T.Table(_blobs(n_per=3)))
