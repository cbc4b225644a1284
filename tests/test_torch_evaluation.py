"""The port's evaluators (``flink_ml_tpu_torch.models.evaluation``) against
the JAX package's on the same seeded tables.  Tolerances: the multiclass
and regression evaluators are host numpy copies and must agree exactly;
the binary evaluator sums its integrals in float64 where the JAX package
sums in f32, so its metrics agree within 1e-5; the silhouette (f32 on the
device in both) within rtol 1e-5."""

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu.models.evaluation as JE
import flink_ml_tpu_torch as T
import flink_ml_tpu_torch.models.evaluation as TE


def _tables(cols):
    return J.Table(cols), T.Table(cols)


def _metrics(out):
    return {k: float(out[k][0]) for k in out.column_names}


@pytest.mark.parametrize("case", ["continuous", "ties", "one_class",
                                  "probabilities"])
def test_binary_evaluator_matches_jax(case):
    rng = np.random.default_rng(0)
    n = 3000
    y = (rng.random(n) < 0.4).astype(np.float64)
    scores = rng.normal(size=n) + 0.8 * y
    if case == "ties":
        scores = np.round(scores, 1)
    elif case == "one_class":
        y = np.ones(n)
    elif case == "probabilities":
        scores = 1.0 / (1.0 + np.exp(-scores))
    jt, tt = _tables({"label": y, "rawPrediction": scores})
    names = ("areaUnderROC", "areaUnderPR", "accuracy")
    (want,) = JE.BinaryClassificationEvaluator().set_metrics(
        *names).transform(jt)
    (got,) = TE.BinaryClassificationEvaluator(device="cpu").set_metrics(
        *names).transform(tt)
    w, g = _metrics(want), _metrics(got)
    assert g.keys() == w.keys() == set(names)
    for k in names:
        assert g[k] == pytest.approx(w[k], abs=1e-5), k
    (default,) = TE.BinaryClassificationEvaluator(device="cpu").transform(tt)
    assert default.column_names == ["areaUnderROC", "areaUnderPR"]


def test_binary_evaluator_rejects_vector_scores():
    t = T.Table({"label": np.zeros(4), "rawPrediction": np.zeros((4, 2))})
    with pytest.raises(ValueError, match="scalar scores"):
        TE.BinaryClassificationEvaluator(device="cpu").transform(t)


@pytest.mark.parametrize("weighted", [False, True])
def test_regression_evaluator_matches_jax(weighted):
    rng = np.random.default_rng(1)
    y = rng.normal(size=500)
    cols = {"label": y, "prediction": y + 0.3 * rng.normal(size=500)}
    if weighted:
        cols["w"] = rng.uniform(0.1, 2.0, size=500)
    names = ("rmse", "mse", "mae", "r2")
    outs = []
    for pkg, table in zip((JE, TE), _tables(cols)):
        ev = pkg.RegressionEvaluator().set_metrics(*names)
        if weighted:
            ev = ev.set_weight_col("w")
        outs.append(_metrics(ev.transform(table)[0]))
    assert outs[0] == outs[1]


def test_multiclass_evaluator_matches_jax():
    rng = np.random.default_rng(2)
    y = rng.integers(0, 5, size=700)
    pred = np.where(rng.random(700) < 0.7, y, rng.integers(0, 6, size=700))
    names = ("accuracy", "weightedPrecision", "weightedRecall",
             "weightedFMeasure")
    outs = [_metrics(pkg.MulticlassClassificationEvaluator().set_metrics(
        *names).transform(t)[0])
        for pkg, t in zip((JE, TE), _tables({"label": y,
                                             "prediction": pred}))]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("measure", ["euclidean", "cosine", "manhattan"])
def test_clustering_evaluator_matches_jax(measure):
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(4, 6)) * 4.0
    labels = rng.integers(0, 4, size=300)
    X = centers[labels] + rng.normal(size=(300, 6))
    labels[7] = 9                          # a singleton cluster
    cols = {"features": X, "prediction": labels}
    jt, tt = _tables(cols)
    want = JE.ClusteringEvaluator().set_distance_measure(
        measure).transform(jt)[0]["silhouette"][0]
    got = TE.ClusteringEvaluator(device="cpu").set_distance_measure(
        measure).transform(tt)[0]["silhouette"][0]
    assert got == pytest.approx(want, rel=1e-5)
    one = T.Table({"features": X[:20], "prediction": np.zeros(20)})
    assert TE.ClusteringEvaluator(device="cpu").transform(one)[0][
        "silhouette"][0] == 0.0
    with pytest.raises(ValueError, match="at least 2 rows"):
        TE.ClusteringEvaluator(device="cpu").transform(
            T.Table({"features": X[:1], "prediction": labels[:1]}))


def test_evaluators_score_the_ports_models():
    """The binary evaluator on a port LogisticRegression's probabilities
    and the multiclass one on a SoftmaxRegression's predictions, as the
    JAX evaluators score the same columns."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(600, 5))
    y = (X[:, 0] + 0.5 * rng.normal(size=600) > 0).astype(np.float64)
    lr = T.LogisticRegression(device="cpu").set_max_iter(3).fit(
        T.Table({"features": X, "label": y}))
    (out,) = lr.transform(T.Table({"features": X, "label": y}))
    cols = {"label": y, "rawPrediction": out["rawPrediction"]}
    jt, tt = _tables(cols)
    want = JE.BinaryClassificationEvaluator().transform(jt)[0]
    got = TE.BinaryClassificationEvaluator(device="cpu").transform(tt)[0]
    assert float(got["areaUnderROC"][0]) == pytest.approx(
        float(want["areaUnderROC"][0]), abs=1e-5)
    assert float(got["areaUnderROC"][0]) > 0.8
    sm = T.SoftmaxRegression(device="cpu").set_max_iter(3).fit(
        T.Table({"features": X, "label": np.argmax(X[:, :3], 1)}))
    (pred,) = sm.transform(T.Table({"features": X}))
    cols = {"label": np.argmax(X[:, :3], 1), "prediction": pred["prediction"]}
    outs = [_metrics(pkg.MulticlassClassificationEvaluator().transform(t)[0])
            for pkg, t in zip((JE, TE), _tables(cols))]
    assert outs[0] == outs[1] and outs[1]["accuracy"] > 0.8
