"""The port's SQLTransformer, stats tests and feature selectors
(``flink_ml_tpu_torch.models.feature.sqltransformer``, ``.selectors`` and
``flink_ml_tpu_torch.models.stats``) against the JAX package's on the
same seeded numpy inputs, after ``tests/test_sqltransformer.py``,
``test_selectors.py`` and ``test_stats_evaluation.py``.

Tolerances: SQLTransformer and ChiSqTest (host numpy and scipy) equal the
JAX package's bit for bit, error texts included.  The ANOVA F values, the
F-regression F values and the sample variances are f32 reductions in
another summation order (PyTorch on the CPU against XLA): within rtol
1e-5 (``RED_TOL``); their p-values are scipy's on each package's F, held
within rtol 1e-3 where p > 1e-12 (a p-value's relative error is its F's
times d log p / d log F).  Selected indices are equal for every
selection mode, an exact p-value tie included.  A selector inside a
fused segment equals its stagewise transform at tolerance 0.  The port
runs on the CPU."""

import json
import shutil

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu.models import feature as JF
from flink_ml_tpu.models import stats as JS
from flink_ml_tpu.models.feature import selectors as JSel
from flink_ml_tpu_torch.api import chain as TC
from flink_ml_tpu_torch.models import feature as TF
from flink_ml_tpu_torch.models import stats as TS
from flink_ml_tpu_torch.models.feature import selectors as TSel
from flink_ml_tpu_torch.utils.convert import feature_model_from_jax

RED_TOL = dict(rtol=1e-5, atol=0.0)
P_TOL = dict(rtol=1e-3, atol=1e-12)


def _tables(cols):
    return J.Table(dict(cols)), T.Table(dict(cols))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


# -- SQLTransformer ----------------------------------------------------------

def _sql_cols():
    rng = np.random.default_rng(0)
    n = 40
    return {"a": rng.normal(size=n) * 3, "b": np.abs(rng.normal(size=n)) + 0.5,
            "k": rng.integers(-3, 4, size=n),
            "label": rng.integers(0, 2, size=n),
            "s": np.asarray(rng.choice(["x=y", "a and b", "p,q", "plain"],
                                       size=n), dtype=object),
            "v": rng.normal(size=(n, 3))}


STATEMENTS = [
    "SELECT * FROM __THIS__",
    "select a, b from __THIS__",
    "SELECT a + b AS s, a - b AS d, a * b AS m, a / b AS q, k % 3 AS r, "
    "b ** 2 AS p FROM __THIS__",
    "SELECT ABS(a) AS f0, SQRT(b) AS f1, EXP(b) AS f2, LOG(b) AS f3, "
    "LOG1P(b) AS f4, SIN(a) AS f5, COS(a) AS f6, FLOOR(a) AS f7, "
    "CEIL(a) AS f8, ROUND(a) AS f9, MIN(a, 0.5) AS f10, MAX(a, b) AS f11, "
    "POW(b, 3) AS f12 FROM __THIS__",
    "SELECT log1p(max(a, 0)) AS a, abs(k), -a AS neg, +b AS pos FROM __THIS__",
    "SELECT *, a + 1 AS a1 FROM __THIS__ WHERE a > 0",
    "SELECT a FROM __THIS__ WHERE label = 1 AND b >= 1",
    "SELECT a FROM __THIS__ WHERE NOT (label = 1) OR k <> 0",
    "SELECT a, k FROM __THIS__ WHERE -1 < k <= 2",
    "SELECT a FROM __THIS__ WHERE s = 'x=y' OR s = 'a and b'",
    "SELECT 'p,q' AS c, 7 AS seven, a FROM __THIS__ WHERE s != 'p,q'",
    "SELECT v * 2 AS v2, v - 1 AS v1 FROM __THIS__ WHERE k >= 0",
    "SELECT (a + b) * (a - b) AS diff2, a < b AS lt, a == b AS eq "
    "FROM __THIS__",
]


@pytest.mark.parametrize("statement", STATEMENTS)
def test_sqltransformer_equal(statement):
    jt, tt = _tables(_sql_cols())
    jo = JF.SQLTransformer().set_statement(statement).transform(jt)[0]
    to = TF.SQLTransformer().set_statement(statement).transform(tt)[0]
    assert to.column_names == jo.column_names
    for name in jo.column_names:
        _same_bits(jo[name], to[name])


@pytest.mark.parametrize("statement", [
    "DELETE FROM __THIS__",
    "SELECT a FROM other",
    "SELECT missing FROM __THIS__",
    "SELECT open('/etc/passwd') FROM __THIS__",
    "SELECT __import__('os') FROM __THIS__",
    "SELECT a.dtype FROM __THIS__",
    "SELECT a[0] FROM __THIS__",
    "SELECT ABS(x=a) FROM __THIS__",
    "SELECT (lambda: 1)() FROM __THIS__",
    "SELECT a + FROM __THIS__",
    "SELECT a FROM __THIS__ WHERE a = 'unterminated",
    "SELECT a FROM __THIS__ WHERE v > 0",
    None,
])
def test_sqltransformer_rejects_with_the_same_text(statement):
    jt, tt = _tables(_sql_cols())
    errors = []
    for pkg, table in ((JF, jt), (TF, tt)):
        stage = pkg.SQLTransformer()
        if statement is not None:
            stage.set_statement(statement)
        with pytest.raises(ValueError) as err:
            stage.transform(table)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_sqltransformer_save_load_both_ways(tmp_path):
    stmt = "SELECT LOG1P(MAX(a, 0)) AS la, label FROM __THIS__ WHERE k > 0"
    jt, tt = _tables(_sql_cols())
    JF.SQLTransformer().set_statement(stmt).save(str(tmp_path / "jax"))
    TF.SQLTransformer().set_statement(stmt).save(str(tmp_path / "port"))
    loaded = TF.SQLTransformer.load(str(tmp_path / "jax"))
    assert loaded.get_statement() == stmt
    want = JF.SQLTransformer().set_statement(stmt).transform(jt)[0]
    for stage in (loaded, TF.SQLTransformer.load(str(tmp_path / "port")),
                  feature_model_from_jax(
                      JF.SQLTransformer().set_statement(stmt), "cpu")):
        got = stage.transform(tt)[0]
        for name in want.column_names:
            _same_bits(want[name], got[name])


# -- the stats tests ----------------------------------------------------------

def _classif(n=600, d=8, k=3, seed=1):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=n)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 20.0, size=d) \
        + rng.normal(size=d) * 5
    X[:, 1] += y * 2.0
    X[:, 4] += (y == 1) * 1.0
    X[:, 6] += y * 0.2
    return X, y


def _regress(n=500, d=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * 4 + 1
    y = 3.0 * X[:, 2] - 0.5 * X[:, 4] + rng.normal(scale=2.0, size=n)
    return X, y


def _close_p(jp, tp):
    jp, tp = np.asarray(jp), np.asarray(tp)
    both = (jp > 1e-12) | (tp > 1e-12)
    np.testing.assert_allclose(tp[both], jp[both], **P_TOL)


@pytest.mark.parametrize("k", [2, 3, 7])
def test_anova_f_scores_within_tolerance(k):
    X, y = _classif(k=k)
    jf, jp, jdfn, jdfd = JS.anovatest.anova_f_scores(X, y)
    tf, tp, tdfn, tdfd = TS.anova_f_scores(X, y, device="cpu")
    assert (jdfn, jdfd) == (tdfn, tdfd)
    np.testing.assert_allclose(tf, jf, **RED_TOL)
    _close_p(jp, tp)


def test_anova_degenerate_cases_equal():
    X = np.ones((4, 2))
    for y in (np.zeros(4), np.asarray([0, 1, 2, 3])):
        j = JS.anovatest.anova_f_scores(X, y)
        t = TS.anova_f_scores(X, y, device="cpu")
        for a, b in zip(j, t):
            _same_bits(a, b)
    # f_p_values: host float64, the same bits
    f = np.asarray([0.0, 1.5, 24.0, np.inf, np.nan, 1e6])
    _same_bits(JS.anovatest.f_p_values(f, np.full(6, 2), np.full(6, 9)),
               TS.f_p_values(f, np.full(6, 2), np.full(6, 9)))


def test_anova_and_fvalue_tests_equal():
    X, y = _classif()
    jt, tt = _tables({"features": X, "label": y})
    jo = JS.ANOVATest().transform(jt)[0]
    to = TS.ANOVATest(device="cpu").transform(tt)[0]
    _same_bits(jo["featureIndex"], to["featureIndex"])
    _same_bits(jo["degreesOfFreedom"], to["degreesOfFreedom"])
    np.testing.assert_allclose(to["fValue"], jo["fValue"], **RED_TOL)
    _close_p(jo["pValue"], to["pValue"])
    Xr, yr = _regress()
    jt, tt = _tables({"features": Xr, "label": yr})
    jo = JS.FValueTest().transform(jt)[0]
    to = TS.FValueTest(device="cpu").transform(tt)[0]
    _same_bits(jo["degreesOfFreedom"], to["degreesOfFreedom"])
    np.testing.assert_allclose(to["fValue"], jo["fValue"], **RED_TOL)
    _close_p(jo["pValue"], to["pValue"])


def test_f_regression_perfect_and_degenerate():
    rng = np.random.default_rng(4)
    x = rng.normal(size=200)
    X = np.column_stack([x, rng.normal(size=200), np.ones(200)])
    jf, jp, jd = JS.fvaluetest.f_regression_scores(X, 2.0 * x)
    tf, tp, td = TS.f_regression_scores(X, 2.0 * x, device="cpu")
    assert jd == td
    # r = +-1: F finite and huge, p 0; a constant column: r 0, p 1
    assert np.isfinite(tf[0]) and tf[0] > 1e6 and tp[0] == jp[0] == 0.0
    assert tf[2] == jf[2] == 0.0 and tp[2] == jp[2] == 1.0
    np.testing.assert_allclose(tf[1], jf[1], **RED_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_chisq_equal_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    n = 800
    y = rng.integers(0, 3, n)
    X = np.column_stack([
        (y + (rng.random(n) < 0.1)) % 3,
        rng.integers(0, 4, n),
        rng.integers(0, 2, n),
        np.zeros(n),
    ]).astype(np.float64)
    jt, tt = _tables({"features": X, "label": y})
    jo = JS.ChiSqTest().transform(jt)[0]
    to = TS.ChiSqTest().transform(tt)[0]
    assert to.column_names == jo.column_names
    for name in jo.column_names:
        _same_bits(jo[name], to[name])


# -- the selectors -------------------------------------------------------------

@pytest.mark.parametrize("threshold", [0.0, 0.5, 4.0, 100.0])
def test_variance_threshold_selector_equal(threshold):
    X, _ = _classif()
    X[:, 3] = 7.0
    jt, tt = _tables({"features": X})
    jm = JF.VarianceThresholdSelector().set_variance_threshold(
        threshold).fit(jt)
    tm = TF.VarianceThresholdSelector(device="cpu").set_variance_threshold(
        threshold).fit(tt)
    _same_bits(jm.get_model_data()[0]["indices"],
               tm.get_model_data()[0]["indices"])
    _same_bits(jm.transform(jt)[0]["output"], tm.transform(tt)[0]["output"])
    # the variances themselves, within the reduction tolerance
    want = np.asarray(JSel._sample_variances(X.astype(np.float32)))
    got = TSel._sample_variances(__import__("torch").as_tensor(
        X.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, want, **RED_TOL)


def _univariate(pkg, ftype, ltype, mode, threshold, **dev):
    s = (pkg.UnivariateFeatureSelector(**dev).set_feature_type(ftype)
         .set_label_type(ltype).set_selection_mode(mode))
    return s if threshold is None else s.set_selection_threshold(threshold)


def _categorical(n=700, seed=2):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, size=n)
    X = np.column_stack([
        (y + (rng.random(n) < 0.2)) % 3, rng.integers(0, 3, n),
        (y > 0) ^ (rng.random(n) < 0.3), rng.integers(0, 5, n),
        y * 0, (y == 2) ^ (rng.random(n) < 0.45)]).astype(np.float64)
    return X, y


@pytest.mark.parametrize("mode,threshold", [
    ("numTopFeatures", None), ("numTopFeatures", 3), ("percentile", None),
    ("percentile", 0.5), ("fpr", None), ("fpr", 1e-3), ("fdr", None),
    ("fdr", 0.2), ("fwe", None), ("fwe", 0.5)])
@pytest.mark.parametrize("types", [("continuous", "categorical"),
                                   ("continuous", "continuous"),
                                   ("categorical", "categorical")])
def test_univariate_selector_indices_equal(mode, threshold, types):
    if types == ("continuous", "categorical"):
        X, y = _classif()
    elif types == ("continuous", "continuous"):
        X, y = _regress()
    else:
        X, y = _categorical()
    jt, tt = _tables({"features": X, "label": y})
    jm = _univariate(JF, *types, mode, threshold).fit(jt)
    tm = _univariate(TF, *types, mode, threshold, device="cpu").fit(tt)
    _same_bits(jm.get_model_data()[0]["indices"],
               tm.get_model_data()[0]["indices"])
    _same_bits(jm.transform(jt)[0]["output"], tm.transform(tt)[0]["output"])


@pytest.mark.parametrize("types", [("continuous", "categorical"),
                                   ("continuous", "continuous"),
                                   ("categorical", "categorical")])
def test_exact_p_value_tie_breaks_to_the_lower_index(types):
    """Columns 1, 3 and 5 are one column: their p-values are equal to the
    bit in each package, and the stable argsort keeps the lowest index
    first in both."""
    make, strong = {("continuous", "categorical"): (_classif, 1),
                    ("continuous", "continuous"): (_regress, 2),
                    ("categorical", "categorical"): (_categorical, 0)}[types]
    X, y = make()
    weak = [j for j in range(X.shape[1]) if j != strong][:3]
    X = X[:, [weak[0], strong, weak[1], strong, weak[2], strong]].copy()
    jt, tt = _tables({"features": X, "label": y})
    for pkg, table, dev in ((JF, jt, {}), (TF, tt, {"device": "cpu"})):
        if types[0] == "categorical":
            p = JSel._chi2_scores(X, y) if pkg is JF else \
                TSel._chi2_scores(X, y)
        elif types[1] == "categorical":
            p = (JS.anovatest.anova_f_scores(X, y)[1] if pkg is JF
                 else TS.anova_f_scores(X, y, device="cpu")[1])
        else:
            p = (JS.fvaluetest.f_regression_scores(X, y)[1] if pkg is JF
                 else TS.f_regression_scores(X, y, device="cpu")[1])
        assert p[1] == p[3] == p[5]
        assert p[1] < p[[0, 2, 4]].min()
        for k, want in ((1, [1]), (2, [1, 3])):
            model = _univariate(pkg, *types, "numTopFeatures", k,
                                **dev).fit(table)
            _same_bits(model.get_model_data()[0]["indices"],
                       np.asarray(want, np.int64))


def test_univariate_errors_equal():
    X, y = np.zeros((4, 2)), np.zeros(4)
    jt, tt = _tables({"features": X, "label": y})
    for args, exc in ((("categorical", "continuous"), ValueError),
                      ((None, "categorical"), ValueError)):
        msgs = []
        for pkg, table, dev in ((JF, jt, {}), (TF, tt, {"device": "cpu"})):
            s = pkg.UnivariateFeatureSelector(**dev).set_label_type(args[1])
            if args[0]:
                s.set_feature_type(args[0])
            with pytest.raises(exc) as err:
                s.fit(table)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    msgs = []
    table_of = {JF: J.Table, TF: T.Table}
    for pkg, table, dev in ((JF, jt, {}), (TF, tt, {"device": "cpu"})):
        model = (pkg.VarianceThresholdSelector(**dev).fit(
            table_of[pkg]({"features": np.eye(4)})))
        with pytest.raises(ValueError) as err:
            model.transform(table)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(RuntimeError, match="no model data"):
        TF.UnivariateFeatureSelectorModel(device="cpu").transform(tt)


@pytest.mark.parametrize("name", ["VarianceThresholdSelector",
                                  "UnivariateFeatureSelector"])
def test_selector_saves_load_both_ways(tmp_path, name):
    X, y = _classif()
    jt, tt = _tables({"features": X, "label": y})

    def cfg(s):
        if name == "VarianceThresholdSelector":
            return s.set_variance_threshold(10.0)
        return (s.set_feature_type("continuous").set_label_type(
            "categorical").set_selection_mode("fdr"))

    jm = cfg(getattr(JF, name)()).fit(jt)
    tm = cfg(getattr(TF, name)(device="cpu")).fit(tt)
    want = jm.transform(jt)[0]["output"]
    jm.save(str(tmp_path / "jax"))
    tm.save(str(tmp_path / "port"))
    model_cls = type(tm)
    loaded = model_cls.load(str(tmp_path / "jax"), device="cpu")
    assert loaded.get_selection_mode() == tm.get_selection_mode() \
        if name != "VarianceThresholdSelector" else True
    dst = tmp_path / "for_jax"
    shutil.copytree(tmp_path / "port", dst)
    meta = json.loads((dst / "metadata").read_text())
    meta["className"] = "flink_ml_tpu." + \
        meta["className"][len("flink_ml_tpu_torch."):]
    (dst / "metadata").write_text(json.dumps(meta))
    back = type(jm).load(str(dst))
    assert type(back) is type(jm)
    for model, table in ((loaded, tt), (back, jt), (tm, tt),
                         (feature_model_from_jax(jm, device="cpu"), tt)):
        _same_bits(want, model.transform(table)[0]["output"])
    # the estimators' params saved by the JAX package load in the port
    cfg(getattr(JF, name)()).save(str(tmp_path / "est"))
    est = getattr(TF, name).load(str(tmp_path / "est"), device="cpu")
    _same_bits(want, est.fit(tt).transform(tt)[0]["output"])


def test_stats_tests_carried_over_from_jax():
    X, y = _classif()
    tt = T.Table({"features": X, "label": y})
    for jax_stage in (JS.ANOVATest().set_features_col("features"),
                      JS.ChiSqTest().set_label_col("label"),
                      JS.FValueTest()):
        port = feature_model_from_jax(jax_stage, device="cpu")
        assert type(port).__name__ == type(jax_stage).__name__
        assert port.transform(tt)[0].column_names == \
            jax_stage.transform(J.Table({"features": X, "label": y})
                                )[0].column_names


def test_selector_joins_a_fused_segment():
    """StandardScaler -> UnivariateFeatureSelector -> LogisticRegression
    as one segment of three stages: one dispatch, fused equal to
    stagewise at tolerance 0, and the predictions equal to the JAX
    package's pipeline."""
    from flink_ml_tpu.models.classification import LogisticRegression as JLR

    X, y = _classif(k=2)
    jt, tt = _tables({"features": X, "label": y.astype(np.float64)})

    def stages(pkg, lr, **dev):
        return [pkg.models.feature.StandardScaler(**dev)
                .set_output_col("scaled"),
                pkg.models.feature.UnivariateFeatureSelector(**dev)
                .set_features_col("scaled").set_output_col("sel")
                .set_feature_type("continuous")
                .set_label_type("categorical").set_selection_threshold(3),
                lr(**dev).set_features_col("sel").set_max_iter(5)]

    jpm = J.Pipeline(stages(J, JLR)).fit(jt)
    tpm = T.Pipeline(stages(T, T.LogisticRegression, device="cpu")).fit(tt)
    _same_bits(jpm.stages[1].get_model_data()[0]["indices"],
               tpm.stages[1].get_model_data()[0]["indices"])
    plan = tpm._chain_plan([tt])
    assert plan is not None and [s.num_stages for s in plan.segments] == [3]
    d0 = TC.dispatch_count()
    fused = tpm.transform(tt)[0]
    assert TC.dispatch_count() - d0 == 1
    with TC.chain_disabled():
        stagewise = tpm.transform(tt)[0]
    for name in ("prediction", "rawPrediction"):
        _same_bits(stagewise[name], fused[name])
    assert np.mean(fused["prediction"]
                   == jpm.transform(jt)[0]["prediction"]) >= 0.99


@pytest.mark.parametrize("module", [
    "utils.native_text", "models.feature.tokenize", "models.feature.text",
    "models.feature.sqltransformer", "models.feature.selectors",
    "models.stats.anovatest", "models.stats.chisqtest",
    "models.stats.fvaluetest"])
def test_every_exported_name_has_a_counterpart(module):
    """Each name in the JAX module's ``__all__`` is in the port module's
    ``__all__`` and defined there (the parity tests above reach each)."""
    import importlib

    jax_mod = importlib.import_module(f"flink_ml_tpu.{module}")
    port_mod = importlib.import_module(f"flink_ml_tpu_torch.{module}")
    assert set(jax_mod.__all__) == set(port_mod.__all__)
    for name in jax_mod.__all__:
        assert hasattr(port_mod, name), name
