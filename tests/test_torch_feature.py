"""The port's feature stages (``flink_ml_tpu_torch.models.feature``) against
the JAX package's on the same seeded numpy inputs, after
``tests/test_feature.py``, ``test_feature_transforms.py``,
``test_vector_ops.py``, ``test_pca.py`` and the scaler/splitter cases of
``test_agglomerative_scalers.py`` and ``test_lsh_splitter_swing.py``: one
case per stage for fit and transform, each stage's kernel against its
standalone transform, persistence across the packages, and the errors.

Tolerances: exact-compare outputs (bins, indices, one-hot, splits) equal;
continuous outputs ``allclose(rtol=1e-6, atol=1e-6)`` (XLA on the CPU may
contract a multiply and add into an FMA); the PCA fit within 1e-4 on a
spectrum with gaps; a stage's kernel against its own standalone transform
in the port, tolerance 0.  The port runs on the CPU."""

import json
import shutil

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu.models import feature as JF
from flink_ml_tpu_torch.api import chain as TC
from flink_ml_tpu_torch.models import feature as TF
from flink_ml_tpu_torch.models.feature.transforms import _OnDevice
from flink_ml_tpu_torch.utils.convert import feature_model_from_jax

CONT = dict(rtol=1e-6, atol=1e-6)


def _new(pkg, name):
    cls = getattr(pkg, name)
    if pkg is TF and issubclass(cls, _OnDevice):
        return cls(device="cpu")
    return cls()


def _both(name, configure=lambda s: s):
    return configure(_new(JF, name)), configure(_new(TF, name))


def _tables(cols):
    return J.Table(dict(cols)), T.Table(dict(cols))


def _dense(n=200, d=5, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(dtype)


def _compare(jt, tt, exact, cols):
    for name in cols:
        a = np.asarray(jt[name], np.float64)
        b = np.asarray(tt[name], np.float64)
        assert a.shape == b.shape, name
        if exact:
            assert np.array_equal(a, b, equal_nan=True), name
        else:
            np.testing.assert_allclose(b, a, err_msg=name, **CONT)


def _run(name, cols, configure=lambda s: s, *, exact, out="output"):
    """Fit (estimators) and transform in both packages; the port's kernel
    (where it has one for this schema) equals its standalone transform."""
    jst, tst = _both(name, configure)
    jtab, ttab = _tables(cols)
    if hasattr(jst, "fit"):
        jst, tst = jst.fit(jtab), tst.fit(ttab)
    (jo,), (to,) = jst.transform(jtab), tst.transform(ttab)
    outs = out if isinstance(out, tuple) else (out,)
    _compare(jo, to, exact, outs)
    kernel = (tst.transform_kernel(ttab.schema())
              if hasattr(tst, "transform_kernel") else None)
    if kernel is not None and to.num_rows == ttab.num_rows:
        got = TC.apply_kernel(kernel, ttab)
        for name_ in outs:
            a = np.asarray(to[name_])
            b = np.asarray(got[name_])
            assert np.array_equal(a.astype(b.dtype), b, equal_nan=True), \
                name_
    return jst, tst, jo, to


# -- stateless transformers ---------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("thr", [0.5, 0.0, -0.25, 0.1])
def test_binarizer(thr, dtype):
    _run("Binarizer", {"features": _dense(dtype=dtype)},
         lambda s: s.set_threshold(thr), exact=True)


@pytest.mark.parametrize("policy", ["keep", "clip", "error"])
def test_bucketizer(policy):
    X = _dense(seed=1, dtype=np.float32) * 2
    if policy != "keep":
        X = np.clip(X, -2.9, 2.9)
    X[3, 1] = np.nan if policy == "keep" else 0.0
    _run("Bucketizer", {"features": X},
         lambda s: s.set_splits(-3.0, -0.7, 0.1, 0.3, 3.0)
         .set_handle_invalid(policy), exact=True)


def test_bucketizer_errors_match():
    for pkg in (JF, TF):
        tab = (J if pkg is JF else T).Table({"features": np.array([[-0.1]])})
        with pytest.raises(ValueError, match="handleInvalid"):
            _new(pkg, "Bucketizer").set_splits(0.0, 1.0, 2.0).transform(tab)
        with pytest.raises(ValueError, match="increasing"):
            _new(pkg, "Bucketizer").set_splits(0.0, 2.0, 1.0).transform(tab)
        with pytest.raises(ValueError, match=">= 3"):
            _new(pkg, "Bucketizer").set_splits(0.0, 1.0).transform(tab)


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0, float("inf")])
def test_normalizer(p):
    X = _dense(seed=2)
    X[0] = 0.0                                   # zero row stays finite
    _, _, _, to = _run("Normalizer", {"features": X},
                       lambda s: s.set_p(p), exact=False)
    assert np.isfinite(np.asarray(to["output"])).all()


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_polynomial_expansion(degree):
    _run("PolynomialExpansion", {"features": _dense(d=3, seed=3)},
         lambda s: s.set_degree(degree), exact=False)


def test_polynomial_expansion_order():
    t = T.Table({"features": np.array([[2.0, 3.0]])})
    out = (TF.PolynomialExpansion(device="cpu").set_degree(2)
           .transform(t)[0]["output"])
    np.testing.assert_allclose(out, [[2.0, 4.0, 6.0, 3.0, 9.0]], atol=1e-5)


def test_vector_slicer():
    _run("VectorSlicer", {"features": _dense(seed=4)},
         lambda s: s.set_indices(4, 0, 0, 2), exact=True)
    with pytest.raises(ValueError, match="out of range"):
        (TF.VectorSlicer(device="cpu").set_indices(7)
         .transform(T.Table({"features": _dense()})))


def test_elementwise_product():
    _run("ElementwiseProduct", {"features": _dense(seed=5)},
         lambda s: s.set_scaling_vec(0.5, -2.0, 3.0, 0.0, 1e-3),
         exact=False)
    with pytest.raises(ValueError, match="scalingVec"):
        (TF.ElementwiseProduct(device="cpu").set_scaling_vec(1.0, 2.0)
         .transform(T.Table({"features": _dense()})))


@pytest.mark.parametrize("ncols", [2, 3])
def test_interaction(ncols):
    rng = np.random.default_rng(6)
    cols = {"a": rng.normal(size=(50, 2)), "b": rng.normal(size=50),
            "c": rng.normal(size=(50, 3))}
    names = ("a", "b", "c")[:ncols]
    _run("Interaction", cols,
         lambda s: s.set_input_cols(*names).set_output_col("output"),
         exact=False)
    with pytest.raises(ValueError, match=">= 2"):
        (TF.Interaction(device="cpu").set_input_cols("a")
         .transform(T.Table(cols)))


@pytest.mark.parametrize("inverse", [False, True])
def test_dct(inverse):
    _, tst, _, to = _run("DCT", {"features": _dense(d=8, seed=7)},
                         lambda s: s.set_inverse(inverse), exact=False)
    back = (TF.DCT(device="cpu").set_inverse(not inverse)
            .set_features_col("output").set_output_col("back")
            .transform(to)[0]["back"])
    np.testing.assert_allclose(back, _dense(d=8, seed=7), atol=1e-5)


def test_dense_vector_column_runs_the_kernel_on_the_stacked_matrix():
    X = _dense(n=20, seed=8)
    rows = np.empty(20, dtype=object)
    rows[:] = [T.DenseVector(r) for r in X]
    jrows = np.empty(20, dtype=object)
    jrows[:] = [J.DenseVector(r) for r in X]
    got = (TF.Normalizer(device="cpu").transform(
        T.Table({"features": rows}))[0]["output"])
    want = JF.Normalizer().transform(J.Table({"features": jrows}))[0][
        "output"]
    np.testing.assert_allclose(got, want, **CONT)


# -- fitted stages ------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["mean", "median", "most_frequent"])
def test_imputer(strategy):
    X = np.round(_dense(n=60, d=3, seed=9), 1)
    X[::7, 0] = np.nan
    X[::5, 2] = np.nan
    jst, tst, _, _ = _run("Imputer", {"features": X},
                          lambda s: s.set_strategy(strategy), exact=False)
    np.testing.assert_array_equal(tst._fill, jst._fill)


def test_imputer_custom_missing_value_and_errors():
    X = np.array([[1.0], [-999.0], [3.0]], np.float32)
    _run("Imputer", {"features": X}, lambda s: s.set_missing_value(-999.0),
         exact=False)
    with pytest.raises(RuntimeError, match="no model data"):
        TF.ImputerModel(device="cpu").transform(T.Table({"features": X}))


@pytest.mark.parametrize("with_mean,with_std", [(True, True), (False, True),
                                                (True, False),
                                                (False, False)])
def test_standard_scaler(with_mean, with_std):
    jst, tst, _, _ = _run(
        "StandardScaler", {"features": _dense(seed=10) * 3 + 1},
        lambda s: s.set("withMean", with_mean).set("withStd", with_std),
        exact=False)
    np.testing.assert_array_equal(tst._mean, jst._mean)
    np.testing.assert_array_equal(tst._std, jst._std)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0), (2.0, 5.0)])
def test_minmax_scaler(lo, hi):
    _run("MinMaxScaler", {"features": _dense(seed=11)},
         lambda s: s.set("min", lo).set("max", hi), exact=False)


def test_minmax_range_error():
    m = (TF.MinMaxScaler(device="cpu")
         .fit(T.Table({"features": _dense()})).set("min", 2.0)
         .set("max", 1.0))
    with pytest.raises(ValueError):
        m.transform(T.Table({"features": _dense()}))


def test_maxabs_scaler():
    _, _, _, to = _run("MaxAbsScaler", {"features": _dense(seed=12) * 5},
                       exact=False)
    assert np.abs(np.asarray(to["output"])).max() <= 1.0


@pytest.mark.parametrize("center,scale", [(True, True), (False, True),
                                          (True, False)])
def test_robust_scaler(center, scale):
    X = _dense(seed=13)
    X[0] = 1e4                                   # an outlier row
    _run("RobustScaler", {"features": X},
         lambda s: s.set("withCentering", center).set("withScaling", scale),
         exact=False)
    with pytest.raises(ValueError):
        (TF.RobustScaler(device="cpu").set("lower", 80.0)
         .fit(T.Table({"features": X})))


@pytest.mark.parametrize("strategy", ["uniform", "quantile", "kmeans"])
def test_kbins(strategy):
    X = _dense(seed=14, dtype=np.float32)
    X[:, 4] = 2.0                                # a constant column
    jst, tst, _, _ = _run("KBinsDiscretizer", {"features": X},
                          lambda s: s.set_num_bins(4).set_strategy(strategy)
                          .set_sub_samples(150).set_seed(3), exact=True)
    np.testing.assert_array_equal(tst._edges, jst._edges)


@pytest.mark.parametrize("policy", ["keep", "skip", "error"])
def test_vector_indexer(policy):
    rng = np.random.default_rng(15)
    X = np.stack([rng.integers(0, 4, 100), rng.normal(size=100),
                  rng.integers(0, 3, 100) * 0.5], axis=1).astype(np.float32)
    jst, tst = _both("VectorIndexer", lambda s: s.set_max_categories(5)
                     .set_handle_invalid(policy))
    jt, tt = _tables({"features": X})
    jm, tm = jst.fit(jt), tst.fit(tt)
    Y = X.copy()
    if policy != "error":
        Y[::9, 0] = 7.0                          # unseen categories
    jy, ty = _tables({"features": Y})
    _compare(jm.transform(jy)[0], tm.transform(ty)[0], True, ("output",))
    kernel = tm.transform_kernel(ty.schema())
    if policy == "keep":
        got = TC.apply_kernel(kernel, ty)["output"]
        assert np.array_equal(
            np.asarray(tm.transform(ty)[0]["output"], np.float32), got)
    else:
        assert kernel is None
    if policy == "error":
        Y[0, 0] = 9.0
        with pytest.raises(ValueError, match="unseen"):
            tm.transform(T.Table({"features": Y}))


@pytest.mark.parametrize("order", ["frequencyDesc", "frequencyAsc",
                                   "alphabetAsc", "alphabetDesc"])
def test_string_indexer_strings(order):
    rng = np.random.default_rng(16)
    vals = np.array(["b", "a", "c", "dd", "b", "b", "c"])[
        rng.integers(0, 7, 90)]
    jst, tst = _both("StringIndexer", lambda s: s.set_input_cols("s")
                     .set_output_cols("sid").set_string_order_type(order))
    jt, tt = _tables({"s": vals})
    jm, tm = jst.fit(jt), tst.fit(tt)
    assert tm._vocab == jm._vocab
    unseen = _tables({"s": np.array(["zzz", "a", "ddd"])})
    for (j, t) in ((jt, tt), unseen):
        _compare(jm.transform(j)[0], tm.transform(t)[0], True, ("sid",))
    assert tm.transform_kernel(tt.schema()) is None     # strings stay host
    with pytest.raises(ValueError, match="Unseen"):
        tm.set("handleInvalid", "error").transform(unseen[1])


def test_string_indexer_numeric_vocab_chains():
    rng = np.random.default_rng(17)
    v = rng.choice([1.5, 2.5, 7.0, 9.0], size=70).astype(np.float32)
    jst, tst, _, _ = _run("StringIndexer", {"v": v},
                          lambda s: s.set_input_cols("v")
                          .set_output_cols("vid"), exact=True, out="vid")
    assert tst.transform_kernel(T.Table({"v": v}).schema()) is not None


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("policy", ["keep", "error"])
def test_one_hot_encoder(drop_last, policy):
    ids = np.random.default_rng(18).integers(0, 4, 50).astype(np.int64)
    jst, tst = _both("OneHotEncoder", lambda s: s.set_input_cols("id")
                     .set_output_cols("hot").set("dropLast", drop_last)
                     .set("handleInvalid", policy))
    jt, tt = _tables({"id": ids})
    jm, tm = jst.fit(jt), tst.fit(tt)
    assert tm._sizes == jm._sizes
    _compare(jm.transform(jt)[0], tm.transform(tt)[0], True, ("hot",))
    big = T.Table({"id": np.array([1, 9])})
    if policy == "keep":
        got = TC.apply_kernel(tm.transform_kernel(tt.schema()), big)["hot"]
        assert np.array_equal(
            np.asarray(tm.transform(big)[0]["hot"], np.float32), got)
    else:
        assert tm.transform_kernel(tt.schema()) is None
        with pytest.raises(ValueError, match="out of range"):
            tm.transform(big)


def test_vector_assembler():
    rng = np.random.default_rng(19)
    cols = {"a": rng.normal(size=30), "b": rng.normal(size=(30, 2)),
            "c": rng.integers(0, 5, 30)}
    _run("VectorAssembler", cols,
         lambda s: s.set_input_cols("a", "b", "c").set_features_col("f"),
         exact=True, out="f")
    with pytest.raises(ValueError):
        TF.VectorAssembler(device="cpu").transform(T.Table(cols))


def test_online_standard_scaler_matches_jax():
    X = _dense(n=10000, d=4, seed=20) * 2 + 1e4   # large mean: no cancel
    jst, tst = _both("OnlineStandardScaler")
    jm = jst.fit(iter([J.Table({"features": X[i:i + 3000]})
                       for i in range(0, 10000, 3000)]))
    tm = tst.fit(iter([T.Table({"features": X[i:i + 3000]})
                       for i in range(0, 10000, 3000)]))
    np.testing.assert_array_equal(tm._mean, jm._mean)
    np.testing.assert_array_equal(tm._std, jm._std)
    assert tm.model_version == jm.model_version == 4
    np.testing.assert_allclose(tm._std, X.std(axis=0), rtol=1e-9)
    with pytest.raises(ValueError, match="empty"):
        TF.OnlineStandardScaler(device="cpu").fit(iter([]))


@pytest.mark.parametrize("weights", [(1.0, 1.0), (1.0, 2.0, 3.0)])
def test_random_splitter_matches_jax(weights):
    X = _dense(n=301, seed=21)
    jt, tt = _tables({"features": X, "i": np.arange(301)})
    js = JF.RandomSplitter().set_weights(*weights).set_seed(5)
    ts = TF.RandomSplitter().set_weights(*weights).set_seed(5)
    jo, to = js.transform(jt), ts.transform(tt)
    assert len(to) == len(weights)
    for a, b in zip(jo, to):
        assert np.array_equal(np.asarray(a["i"]), np.asarray(b["i"]))
    assert sum(t.num_rows for t in to) == 301
    with pytest.raises(ValueError):
        TF.RandomSplitter().set_weights(1.0)


# -- PCA ----------------------------------------------------------------------

def _gapped(n=300, d=6, seed=22):
    """Rows whose covariance has well-separated eigenvalues."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    scales = np.array([6.0, 4.0, 2.5, 1.5, 0.8, 0.3])[:d]
    return ((rng.normal(size=(n, d)) * scales) @ Q.T + 3.0).astype(
        np.float32)


@pytest.mark.parametrize("k", [1, 3, 6])
def test_pca_fit_matches_jax(k):
    X = _gapped()
    jt, tt = _tables({"features": X})
    jm = JF.PCA().set_k(k).fit(jt)
    tm = TF.PCA(device="cpu").set_k(k).fit(tt)
    np.testing.assert_allclose(tm._components, jm._components, atol=1e-4)
    np.testing.assert_allclose(tm._mean, jm._mean, rtol=1e-6)
    np.testing.assert_allclose(tm._variance, jm._variance, rtol=1e-4)
    np.testing.assert_allclose(tm.explained_variance_ratio,
                               jm.explained_variance_ratio, rtol=1e-4)


def test_pca_tied_eigenvalues_span_the_same_subspace():
    """Where eigenvalues tie, the vectors are not unique: compare the
    projector onto the spanned subspace."""
    rng = np.random.default_rng(23)
    X = np.concatenate([rng.normal(size=(400, 2)) * 3.0,
                        rng.normal(size=(400, 2)) * 0.5], axis=1)
    X = np.concatenate([X, -X]).astype(np.float32)   # exact symmetric
    jm = JF.PCA().set_k(2).fit(J.Table({"features": X}))
    tm = TF.PCA(device="cpu").set_k(2).fit(T.Table({"features": X}))
    pj = jm._components.T @ jm._components
    pt = tm._components.T @ tm._components
    np.testing.assert_allclose(pt, pj, atol=1e-3)


def test_pca_transform_on_carried_components():
    X = _gapped(seed=24)
    jt, tt = _tables({"features": X})
    jm = JF.PCA().set_k(3).set_output_col("pc").fit(jt)
    tm = feature_model_from_jax(jm, device="cpu")
    a = np.asarray(jm.transform(jt)[0]["pc"])
    b = np.asarray(tm.transform(tt)[0]["pc"])
    np.testing.assert_allclose(b, a, **CONT)
    kernel = tm.transform_kernel(tt.schema())
    assert np.array_equal(TC.apply_kernel(kernel, tt)["pc"], b)


def test_pca_sign_rule_and_errors():
    X = _gapped(seed=25)
    tm = TF.PCA(device="cpu").set_k(4).fit(T.Table({"features": X}))
    pivot = np.argmax(np.abs(tm._components), axis=1)
    assert (tm._components[np.arange(4), pivot] > 0).all()
    again = TF.PCA(device="cpu").set_k(4).fit(T.Table({"features": X}))
    np.testing.assert_array_equal(again._components, tm._components)
    with pytest.raises(ValueError, match="exceeds"):
        TF.PCA(device="cpu").set_k(9).fit(T.Table({"features": X}))
    with pytest.raises(RuntimeError, match="no model data"):
        TF.PCAModel(device="cpu").transform(T.Table({"features": X}))


# -- persistence across the packages -----------------------------------------

def _fitted_pairs():
    X = _gapped(n=120, seed=26)
    ids = np.random.default_rng(27).integers(0, 3, 120)
    cols = {"features": X, "id": ids}
    jt, _ = _tables(cols)
    return cols, [
        JF.StandardScaler().fit(jt), JF.MinMaxScaler().fit(jt),
        JF.MaxAbsScaler().fit(jt), JF.RobustScaler().fit(jt),
        JF.Imputer().fit(jt), JF.PCA().set_k(2).fit(jt),
        JF.KBinsDiscretizer().set_num_bins(3).fit(jt),
        JF.VectorIndexer().set_handle_invalid("keep").fit(jt),
        JF.StringIndexer().set_input_cols("id").set_output_cols("sid")
        .fit(jt),
        JF.OneHotEncoder().set_input_cols("id").set_output_cols("hot")
        .fit(jt),
        JF.Binarizer().set_threshold(0.3), JF.Normalizer().set_p(1.0),
    ]


def _out_cols(stage):
    if hasattr(stage, "get_output_cols"):
        return list(stage.get_output_cols())
    return [stage.get_output_col()]


@pytest.mark.parametrize("i", range(12))
def test_jax_saved_feature_stage_loads_in_port(tmp_path, i):
    cols, stages = _fitted_pairs()
    js = stages[i]
    path = str(tmp_path / "jax")
    js.save(path)
    ts = getattr(TF, type(js).__name__).load(path, device="cpu")
    assert ts.device == "cpu"
    jt, tt = _tables(cols)
    outs = _out_cols(js)
    exact = type(js).__name__ in ("KBinsDiscretizerModel", "Binarizer",
                                  "VectorIndexerModel", "StringIndexerModel",
                                  "OneHotEncoderModel")
    _compare(js.transform(jt)[0], ts.transform(tt)[0], exact, outs)
    # the carried-over model gives the same outputs as the loaded one
    conv = feature_model_from_jax(js, device="cpu")
    _compare(ts.transform(tt)[0], conv.transform(tt)[0], True, outs)
    # the port's save loads in the JAX package (className pointed at it)
    ts.save(str(tmp_path / "port"))
    meta_path = tmp_path / "port" / "metadata"
    meta = json.loads(meta_path.read_text())
    assert meta["className"].startswith("flink_ml_tpu_torch.")
    shutil.copytree(tmp_path / "port", tmp_path / "for_jax")
    meta["className"] = "flink_ml_tpu." + \
        meta["className"][len("flink_ml_tpu_torch."):]
    (tmp_path / "for_jax" / "metadata").write_text(json.dumps(meta))
    back = type(js).load(str(tmp_path / "for_jax"))
    assert type(back) is type(js)
    _compare(js.transform(jt)[0], back.transform(jt)[0], True, outs)


def test_cross_class_load_rejected(tmp_path):
    TF.Binarizer(device="cpu").save(str(tmp_path / "b"))
    with pytest.raises(IOError):
        TF.Normalizer.load(str(tmp_path / "b"), device="cpu")


def test_feature_stages_need_cuda_unless_cpu_asked(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = T.Table({"features": _dense(n=8)})
    with pytest.raises(RuntimeError, match="no GPU"):
        TF.Normalizer().transform(t)
    with pytest.raises(RuntimeError, match="no GPU"):
        TF.PCA().set_k(2).fit(t)
    model = TF.StandardScaler().fit(t)           # host statistics
    with pytest.raises(RuntimeError, match="no GPU"):
        model.transform(t)
    model.device = "cpu"
    assert model.transform(t)[0]["output"].shape == (8, 5)
