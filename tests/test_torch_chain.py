"""The port's operator chaining (``flink_ml_tpu_torch.api.chain``), case by
case after ``tests/test_chain.py``: fused segments equal the stagewise path
bit for bit at every terminal family (linear, KMeans, Wide&Deep, IVF),
chain breaks land at non-chainable stages, one dispatch runs a segment,
exact-compare kernels decline f64 columns, and the port's outputs agree
with the JAX package's on the same inputs.  The JAX pipelines are fitted
as the JAX tests fit them and carried over with
``pipeline_model_from_jax``; the port runs on the CPU."""

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu.api import chain as JC
from flink_ml_tpu.models.classification.logisticregression import (
    LogisticRegression as JLR,
)
from flink_ml_tpu.models.clustering.kmeans import KMeans as JKMeans
from flink_ml_tpu.models.feature import encoders as JE
from flink_ml_tpu.models.feature import pca as JP
from flink_ml_tpu.models.feature import randomsplitter as JRS
from flink_ml_tpu.models.feature import scalers as JS
from flink_ml_tpu.models.feature import transforms as JT
from flink_ml_tpu.models.feature import vector_ops as JV
from flink_ml_tpu.models.recommendation.widedeep import WideDeep as JWD
from flink_ml_tpu_torch.api import chain as TC
from flink_ml_tpu_torch.models.feature import encoders as TE
from flink_ml_tpu_torch.models.feature import scalers as TS
from flink_ml_tpu_torch.models.feature import transforms as TT
from flink_ml_tpu_torch.models.feature import vector_ops as TV
from flink_ml_tpu_torch.utils.convert import pipeline_model_from_jax

CONT = dict(rtol=1e-6, atol=1e-6)     # continuous outputs vs JAX (FMA)


def _table(n=120, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] > 0).astype(np.int64)
    return X, y


def _jscaler_chain(table):
    """std -> minmax -> maxabs in the JAX package, each feeding the next."""
    s1 = JS.StandardScaler().set_output_col("std").fit(table)
    t1 = s1.transform(table)[0]
    s2 = (JS.MinMaxScaler().set_features_col("std").set_output_col("mm")
          .fit(t1))
    t2 = s2.transform(t1)[0]
    s3 = (JS.MaxAbsScaler().set_features_col("mm").set_output_col("ma")
          .fit(t2))
    return [s1, s2, s3], s3.transform(t2)[0]


def _equal(ref, out, cols=None, cast=()):
    """Tolerance 0 inside the port.  ``cast`` names columns whose
    stagewise value is host f64 (the assembler's), compared after the
    cast to the fused f32 — the JAX package's test does the same."""
    for name in (cols or ref.column_names):
        a, b = np.asarray(ref[name]), np.asarray(out[name])
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if name in cast:
            a = a.astype(b.dtype)
        assert np.array_equal(a, b), f"column {name!r} diverged"


def _ab(pm, *tables):
    """(stagewise, fused) port outputs for the same inputs."""
    with TC.chain_disabled():
        ref = pm.transform(*tables)
    return ref, pm.transform(*tables)


def _against_jax(jout, tout, exact=(), skip=()):
    """Port output vs the JAX package's: ``exact`` columns equal, every
    other column within the continuous tolerance."""
    for name in jout.column_names:
        if name in skip:
            continue
        a = np.asarray(jout[name], np.float64)
        b = np.asarray(tout[name], np.float64)
        assert a.shape == b.shape, name
        if name in exact:
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(b, a, err_msg=name, **CONT)


def _port(jpm):
    return pipeline_model_from_jax(jpm, device="cpu")


def _check(jpm, jfeats, plan, exact=("prediction",), cast=()):
    """Convert, run both paths in the port, hold fused == stagewise, the
    plan's shape, and the port against the JAX transform."""
    pm = _port(jpm)
    feats = T.Table(jfeats.to_dict())
    (ref,), (out,) = _ab(pm, feats)
    _equal(ref, out, cast=cast)
    assert pm._chain_plan([feats]).describe() == plan
    (jout,) = jpm.transform(jfeats)
    _against_jax(jout, out, exact=exact)
    return pm, feats, out


# -- bit-exactness per terminal family ---------------------------------------

def test_fused_bitexact_linear_terminal():
    X, y = _table()
    t = J.Table({"features": X, "label": y})
    stages, t3 = _jscaler_chain(t)
    lr = JLR().set_features_col("ma").set_max_iter(3).fit(t3)
    _check(J.PipelineModel(stages + [lr]), t.drop("label"),
           [("segment", 4)])


def test_fused_bitexact_kmeans_terminal():
    X, y = _table(seed=3)
    t = J.Table({"features": X, "label": y})
    stages, t3 = _jscaler_chain(t)
    km = JKMeans().set_k(4).set_max_iter(3).set_features_col("ma").fit(t3)
    _check(J.PipelineModel(stages + [km]), t.drop("label"),
           [("segment", 4)])


def _wd_table(n, width, seed=6):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, width)).astype(np.float32)
    cat = np.stack([rng.integers(0, 10, size=n),
                    rng.integers(0, 7, size=n)], axis=1).astype(np.int32)
    label = (cat[:, 0] > 4).astype(np.int64)
    return dense, cat, label


def test_fused_bitexact_widedeep_terminal():
    dense, cat, label = _wd_table(96, 4)
    t = J.Table({"denseFeatures": dense, "catFeatures": cat, "label": label})
    s1 = (JS.StandardScaler().set_features_col("denseFeatures")
          .set_output_col("denseFeatures").fit(t))
    t1 = s1.transform(t)[0]
    s2 = (JS.MaxAbsScaler().set_features_col("denseFeatures")
          .set_output_col("denseFeatures").fit(t1))
    t2 = s2.transform(t1)[0]
    s3 = (JT.Normalizer().set_features_col("denseFeatures")
          .set_output_col("denseFeatures"))
    t3 = s3.transform(t2)[0]
    wd = JWD().set_vocab_sizes([10, 7]).set_max_iter(3).fit(t3)
    pm, _, _ = _check(J.PipelineModel([s1, s2, s3, wd]), t.drop("label"),
                      [("segment", 4)])
    # the categorical range check (WideDeep's host `pre`) fires on both
    # paths
    bad = T.Table({"denseFeatures": dense, "catFeatures": cat + 100})
    with pytest.raises(ValueError):
        pm.transform(bad)
    with TC.chain_disabled(), pytest.raises(ValueError):
        pm.transform(bad)


def test_widedeep_wide_dense_bitexact():
    dense, cat, label = _wd_table(128, 8)
    t = J.Table({"denseFeatures": dense, "catFeatures": cat, "label": label})
    s1 = (JS.StandardScaler().set_features_col("denseFeatures")
          .set_output_col("denseFeatures").fit(t))
    t1 = s1.transform(t)[0]
    s2 = (JS.MaxAbsScaler().set_features_col("denseFeatures")
          .set_output_col("denseFeatures").fit(t1))
    t2 = s2.transform(t1)[0]
    wd = JWD().set_vocab_sizes([10, 7]).set_max_iter(2).fit(t2)
    _check(J.PipelineModel([s1, s2, wd]), t.drop("label"), [("segment", 3)])


def test_mixed_feature_chain_bitexact():
    """Binarizer's f32 threshold surrogate, Normalizer and PCA inside one
    segment ending in LR."""
    X, y = _table(seed=9)
    t = J.Table({"features": X, "label": y})
    s1 = JS.StandardScaler().set_output_col("std").fit(t)
    t1 = s1.transform(t)[0]
    s2 = JT.Binarizer().set_features_col("std").set_output_col("bin") \
        .set_threshold(0.25)
    t2 = s2.transform(t1)[0]
    s3 = JT.Normalizer().set_features_col("std").set_output_col("norm")
    t3 = s3.transform(t2)[0]
    s4 = JP.PCA().set_k(3).set_features_col("norm").set_output_col("pc") \
        .fit(t3)
    t4 = s4.transform(t3)[0]
    lr = JLR().set_features_col("pc").set_max_iter(2).fit(t4)
    _check(J.PipelineModel([s1, s2, s3, s4, lr]), t.drop("label"),
           [("segment", 5)], exact=("prediction", "bin"))


def test_encoder_chain_wide_margins_bitexact():
    """The encoder kernels (numeric StringIndexer, OneHot, VectorAssembler)
    feeding an 8-wide LR terminal."""
    rng = np.random.default_rng(1)
    n = 80
    cat = rng.integers(0, 5, size=n).astype(np.int64)
    x = rng.normal(size=(n, 3))
    val = rng.choice([1.5, 2.5, 7.0, 9.0], size=n).astype(np.float32)
    t = J.Table({"cat": cat, "x": x, "val": val,
                 "label": (x[:, 0] > 0).astype(np.int64)})
    si = JE.StringIndexer().set_input_cols("val").set_output_cols("vid") \
        .fit(t)
    t0 = si.transform(t)[0]
    oh = (JE.OneHotEncoder().set_input_cols("cat").set_output_cols("hot")
          .set(JE.OneHotEncoderParams.HANDLE_INVALID, "keep").fit(t0))
    t1 = oh.transform(t0)[0]
    va = (JE.VectorAssembler().set_input_cols("hot", "x", "vid")
          .set_features_col("raw"))
    t2 = va.transform(t1)[0]
    sc = (JS.StandardScaler().set_features_col("raw")
          .set_output_col("features").fit(t2))
    t3 = sc.transform(t2)[0]
    lr = JLR().set_max_iter(2).fit(t3)
    _check(J.PipelineModel([si, oh, va, sc, lr]), t.drop("label"),
           [("segment", 5)], exact=("prediction", "vid", "hot"),
           cast=("raw",))


def test_softmax_breaks_chain_and_matches():
    """A stage without a chain kernel (SoftmaxRegression here; GBT in the
    JAX package's test) runs stagewise after the fused scaler segment."""
    X, y = _table(seed=4)
    tt = T.Table({"features": X, "label": y})
    s1 = TS.StandardScaler(device="cpu").set_output_col("std").fit(tt)
    t1 = s1.transform(tt)[0]
    s2 = (TS.MinMaxScaler(device="cpu").set_features_col("std")
          .set_output_col("mm").fit(t1))
    t2 = s2.transform(t1)[0]
    sm = (T.SoftmaxRegression(device="cpu").set_features_col("mm")
          .set_max_iter(3).fit(t2))
    pm = T.PipelineModel([s1, s2, sm])
    feats = tt.drop("label")
    (ref,), (out,) = _ab(pm, feats)
    _equal(ref, out)
    assert pm._chain_plan([feats]).describe() == \
        [("segment", 2), ("stage", 1)]


def test_ivf_terminal_bitexact():
    """StandardScaler -> IVF index (flat and PQ): the fused search equals
    the stagewise one and ``scaler.transform`` followed by ``search``."""
    X, _ = _table(n=400, d=8, seed=21)
    tt = T.Table({"query": X})
    sc = (TS.StandardScaler(device="cpu").set_features_col("query")
          .set_output_col("query").fit(tt))
    scaled = np.asarray(sc.transform(tt)[0]["query"], np.float32)
    for pq in (None, T.PQConfig(m=4, ksub=8)):
        index = T.IVFIndex.build(scaled, nlist=8, pq=pq, k=5, nprobe=2,
                                 seed=3, device="cpu")
        pm = T.PipelineModel([sc, index])
        queries = T.Table({"query": X[:37]})
        (ref,), (out,) = _ab(pm, queries)
        _equal(ref, out)
        assert pm._chain_plan([queries]).describe() == [("segment", 2)]
        nn, dist = index.search(scaled[:37])
        assert np.array_equal(np.asarray(out["neighbors"]), nn)
        assert np.array_equal(np.asarray(out["distances"]), dist)


# -- chain-break correctness --------------------------------------------------

def test_chain_break_at_splitter_bitexact():
    X, y = _table(seed=5)
    t = J.Table({"features": X, "label": y})
    s1 = JS.StandardScaler().set_output_col("std").fit(t)
    t1 = s1.transform(t)[0]
    s2 = (JS.MinMaxScaler().set_features_col("std").set_output_col("mm")
          .fit(t1))
    t2 = s2.transform(t1)[0]
    lr = JLR().set_features_col("mm").set_max_iter(2).fit(t2)
    splitter = JRS.RandomSplitter().set_weights(1.0, 1.0).set_seed(7)
    jpm = J.PipelineModel([s1, splitter, s2, lr])
    pm = _port(jpm)
    feats = T.Table({"features": X})
    ref, out = _ab(pm, feats)
    assert len(ref) == len(out) == 2            # the split fans out
    for r, o in zip(ref, out):
        _equal(r, o)
    assert pm._chain_plan([feats]).describe() == \
        [("segment", 1), ("stage", 1), ("segment", 2)]
    jout = jpm.transform(t.drop("label"))
    for j, o in zip(jout, out):                 # the same seeded split
        _against_jax(j, o, exact=("prediction",))


def test_zero_row_table_fused():
    X, y = _table()
    tt = T.Table({"features": X, "label": y})
    s1 = TS.StandardScaler(device="cpu").set_output_col("std").fit(tt)
    t1 = s1.transform(tt)[0]
    s2 = (TS.MinMaxScaler(device="cpu").set_features_col("std")
          .set_output_col("mm").fit(t1))
    t2 = s2.transform(t1)[0]
    lr = (T.LogisticRegression(device="cpu").set_features_col("mm")
          .set_max_iter(2).fit(t2))
    from flink_ml_tpu_torch.models.feature.randomsplitter import (
        RandomSplitter)
    for stages in ([s1, s2, lr],
                   [s1, RandomSplitter().set_weights(1.0, 1.0), s2, lr]):
        pm = T.PipelineModel(stages)
        empty = tt.drop("label").take(0)
        ref, out = _ab(pm, empty)
        assert len(ref) == len(out)
        for r, o in zip(ref, out):
            assert o.num_rows == 0
            _equal(r, o)


def test_single_chainable_stage_stays_stagewise():
    X, y = _table()
    tt = T.Table({"features": X, "label": y})
    s1 = TS.StandardScaler(device="cpu").set_output_col("std").fit(tt)
    pm = T.PipelineModel([s1])
    assert pm._chain_plan([tt.drop("label")]) is None


def test_unsafe_int_values_fall_back_stagewise():
    """Integers beyond +-2^24 run the segment's stages stagewise for that
    call only; safe batches keep the fused plan."""
    rng = np.random.default_rng(3)
    n = 64
    big = (1 << 24) + rng.integers(0, 3, size=n).astype(np.int64)
    tt = T.Table({"features": rng.normal(size=(n, 4)), "big": big})
    s1 = TS.StandardScaler(device="cpu").set_output_col("std").fit(tt)
    bz = (TT.Binarizer(device="cpu").set_features_col("big")
          .set_output_col("bin").set_threshold((1 << 24) + 0.5))
    pm = T.PipelineModel([s1, bz])
    (ref,), (out,) = _ab(pm, tt)
    _equal(ref, out)
    assert np.asarray(out["bin"]).any()
    small = T.Table({"features": np.asarray(tt["features"]),
                     "big": big - (1 << 24)})
    (ref2,), (out2,) = _ab(pm, small)
    _equal(ref2, out2)
    mm = (TS.MinMaxScaler(device="cpu").set_features_col("big")
          .set_output_col("mm").fit(tt))
    got = np.asarray(mm.transform(tt)[0]["mm"])
    X = big.astype(np.float64).reshape(-1, 1)
    span = np.maximum(X.max() - X.min(), 1e-12)
    assert np.array_equal(got, (X - X.min()) / span)


def _off_schema_cases():
    """(model, on-schema table, off-schema table, output columns): the
    same values, once in the chain's column types and once in a type the
    terminal's kernel declines (a column of vectors, f32-unsafe integers,
    float categorical ids)."""
    rng = np.random.default_rng(11)
    n = 40
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int64)
    rows = np.empty(n, dtype=object)
    rows[:] = [T.DenseVector(r) for r in X]
    lr = (T.LogisticRegression(device="cpu").set_max_iter(3)
          .fit(T.Table({"features": X, "label": y})))
    big = ((1 << 24) + rng.integers(0, 9, size=(n, 3))).astype(np.int64)
    km = (T.KMeans(device="cpu").set_k(3).set_max_iter(2)
          .fit(T.Table({"features": X})))
    dense, cat, label = _wd_table(n, 4)
    wd = (T.WideDeep(device="cpu").set_vocab_sizes([10, 7]).set_max_iter(1)
          .fit(T.Table({"denseFeatures": dense, "catFeatures": cat,
                        "label": label})))
    lr_out = ("prediction", "rawPrediction")
    return {
        "linear_vectors": (lr, T.Table({"features": X}),
                           T.Table({"features": rows}), lr_out),
        "linear_unsafe_ints": (lr, T.Table({"features": big.astype(
            np.float32)}), T.Table({"features": big}), lr_out),
        "kmeans_vectors": (km, T.Table({"features": X}),
                           T.Table({"features": rows}), ("prediction",)),
        "widedeep_float_ids": (
            wd, T.Table({"denseFeatures": dense, "catFeatures": cat}),
            T.Table({"denseFeatures": dense.astype(np.float64),
                     "catFeatures": cat.astype(np.float64)}),
            ("rawPrediction", "prediction")),
    }


@pytest.mark.parametrize("case", ["linear_vectors", "linear_unsafe_ints",
                                  "kmeans_vectors", "widedeep_float_ids"])
def test_terminal_off_schema_runs_the_kernel(case):
    """A standalone terminal whose input the chain declines casts it and
    runs the same kernel on the same padded shape: bit-equal to the
    on-schema input, one dispatch."""
    model, on, off, cols = _off_schema_cases()[case]
    assert model.transform_kernel(off.schema()) is None or \
        case == "linear_unsafe_ints"
    ref = model.transform(on)[0]
    before = TC.dispatch_count()
    out = model.transform(off)[0]
    assert TC.dispatch_count() == before + 1
    _equal(ref, out, cols=cols)


def test_widedeep_off_schema_range_check_raises():
    model, _, off, _ = _off_schema_cases()["widedeep_float_ids"]
    bad = T.Table({"denseFeatures": np.asarray(off["denseFeatures"]),
                   "catFeatures": np.asarray(off["catFeatures"]) + 100})
    with pytest.raises(ValueError, match="out of vocab range"):
        model.transform(bad)


def test_fused_onehot_negative_id_raises():
    rng = np.random.default_rng(9)
    n = 40
    tt = T.Table({"cat": rng.integers(0, 4, size=n).astype(np.int64),
                  "x": rng.normal(size=(n, 3))})
    oh = (TE.OneHotEncoder(device="cpu").set_input_cols("cat")
          .set_output_cols("hot")
          .set(TE.OneHotEncoderParams.HANDLE_INVALID, "keep").fit(tt))
    va = (TE.VectorAssembler(device="cpu").set_input_cols("hot", "x")
          .set_features_col("f"))
    pm = T.PipelineModel([oh, va])
    pm.transform(tt)
    assert pm._chain_plan([tt]).describe() == [("segment", 2)]
    bad = T.Table({"cat": np.array([1, -1, 2], np.int64),
                   "x": np.zeros((3, 3))})
    with pytest.raises(ValueError, match="out of range"):
        pm.transform(bad)
    with TC.chain_disabled(), \
            pytest.raises(ValueError, match="out of range"):
        pm.transform(bad)


def test_exact_compare_kernels_decline_f64():
    rng = np.random.default_rng(17)
    n = 64
    Xd = rng.normal(size=(n, 2))
    t64 = T.Table({"features": Xd})
    t32 = T.Table({"features": Xd.astype(np.float32)})
    cats = T.Table({"features": rng.integers(0, 3, size=(n, 2))
                    .astype(np.float64)})
    for stage in (
            TV.KBinsDiscretizer(device="cpu").set_num_bins(4).fit(t64),
            TV.VectorIndexer(device="cpu").set_handle_invalid("keep")
            .fit(cats),
            TT.Imputer(device="cpu").set_missing_value(0.1).fit(t64),
    ):
        assert stage.transform_kernel(t64.schema()) is None
        assert stage.transform_kernel(t32.schema()) is not None
    si = (TE.StringIndexer(device="cpu").set_input_cols("v")
          .set_output_cols("vid")
          .fit(T.Table({"v": np.array([1.0, 2.0, 1.0], np.float32)})))
    assert si.transform_kernel({"v": ((), np.dtype(np.float64))}) is None
    assert si.transform_kernel({"v": ((), np.dtype(np.float32))}) \
        is not None

    kb = TV.KBinsDiscretizerModel(device="cpu").set_model_data(
        T.Table({"edges": np.array([[0.0, 0.3, 1.0]]),
                 "n_edges": np.array([3])}))
    near = T.Table({"features": np.array(
        [[np.nextafter(0.3, 0.0)], [0.3], [0.75]])})
    assert np.array_equal(
        np.asarray(kb.transform(near)[0]["output"]).ravel(), [0.0, 1.0, 1.0])
    s1 = (TS.StandardScaler(device="cpu").set_features_col("output")
          .set_output_col("std").fit(kb.transform(near)[0]))
    s2 = (TS.MaxAbsScaler(device="cpu").set_features_col("std")
          .set_output_col("ma")
          .fit(s1.transform(kb.transform(near)[0])[0]))
    pm = T.PipelineModel([kb, s1, s2])
    (ref,), (out,) = _ab(pm, near)
    _equal(ref, out)
    assert pm._chain_plan([near]).describe() == \
        [("stage", 1), ("segment", 2)]


def test_kbins_nan_bins_last_fused():
    kb = TV.KBinsDiscretizerModel(device="cpu").set_model_data(
        T.Table({"edges": np.array([[0.0, 0.3, 1.0]]),
                 "n_edges": np.array([3])}))
    t = T.Table({"features": np.array([[0.1], [np.nan], [0.8]],
                                      np.float32)})
    host = np.asarray(kb.transform(t)[0]["output"])
    fused = TC.apply_kernel(kb.transform_kernel(t.schema()), t)["output"]
    assert np.array_equal(host.astype(np.float32), np.asarray(fused))
    assert np.array_equal(np.asarray(fused).ravel(), [0.0, 1.0, 1.0])
    jkb = JV.KBinsDiscretizerModel().set_model_data(
        J.Table({"edges": np.array([[0.0, 0.3, 1.0]]),
                 "n_edges": np.array([3])}))
    jt = J.Table(t.to_dict())
    jfused = JC.apply_kernel(jkb.transform_kernel(jt.schema()), jt)["output"]
    assert np.array_equal(np.asarray(jfused), np.asarray(fused))


def test_imputer_f64_placeholder_fills_exactly():
    t = T.Table({"features": np.array([[0.1], [1.0], [3.0]])})
    im = (TT.Imputer(device="cpu").set_missing_value(0.1)
          .set_output_col("out").fit(t))
    got = np.asarray(im.transform(t)[0]["out"]).ravel()
    assert np.array_equal(got, [2.0, 1.0, 3.0])


def test_pre_cols_conflict_splits_segments():
    rng = np.random.default_rng(21)
    n = 64
    tt = T.Table({"val": rng.choice([1.5, 2.5, 7.0], size=n)
                  .astype(np.float32), "x": rng.normal(size=(n, 3))})
    si = (TE.StringIndexer(device="cpu").set_input_cols("val")
          .set_output_cols("vid").fit(tt))
    t0 = si.transform(tt)[0]
    oh = (TE.OneHotEncoder(device="cpu").set_input_cols("vid")
          .set_output_cols("hot")
          .set(TE.OneHotEncoderParams.HANDLE_INVALID, "keep").fit(t0))
    va = (TE.VectorAssembler(device="cpu").set_input_cols("hot", "x")
          .set_features_col("f"))
    pm = T.PipelineModel([si, oh, va])
    (ref,), (out,) = _ab(pm, tt)
    assert pm._chain_plan([tt]).describe() == \
        [("segment", 1), ("segment", 2)]
    for name in ("vid", "hot", "f"):
        a, b = np.asarray(ref[name]), np.asarray(out[name])
        assert a.shape == b.shape
        assert np.array_equal(a.astype(b.dtype), b), name


def test_param_mutation_rebuilds_plan():
    X, y = _table(seed=14)
    tt = T.Table({"features": X, "label": y})
    s1 = TS.StandardScaler(device="cpu").set_output_col("std").fit(tt)
    bz = (TT.Binarizer(device="cpu").set_features_col("std")
          .set_output_col("bin").set_threshold(0.0))
    pm = T.PipelineModel([s1, bz])
    feats = tt.drop("label")
    pm.transform(feats)
    bz.set_threshold(0.75)
    (ref,), (out,) = _ab(pm, feats)
    _equal(ref, out)
    assert not np.array_equal(np.asarray(out["bin"]),
                              (np.asarray(out["std"]) > 0.0))


# -- dispatch accounting ------------------------------------------------------

@pytest.mark.parametrize("n", [1, 37, 120])
def test_fused_dispatch_count_is_one_per_segment(n):
    X, y = _table(seed=8)
    t = J.Table({"features": X, "label": y})
    stages, t3 = _jscaler_chain(t)
    lr = JLR().set_features_col("ma").set_max_iter(2).fit(t3)
    pm = _port(J.PipelineModel(stages + [lr]))
    feats = T.Table({"features": X[:n]})
    pm.transform(feats)                          # plan build
    d0 = TC.dispatch_count()
    pm.transform(feats)
    assert TC.dispatch_count() - d0 == 1         # 4 stages, ONE dispatch
    with TC.chain_disabled():
        pm.transform(feats)
    assert TC.dispatch_count() - d0 == 1 + 4     # stagewise: one a stage


def test_dtype_hygiene_f64_f32_same_outputs():
    """f64 and f32 views of the same data give identical derived columns
    (segment entry casts to f32 on the host)."""
    X, y = _table(n=64, d=8, seed=11)
    t = J.Table({"features": X, "label": y})
    stages, t3 = _jscaler_chain(t)
    lr = JLR().set_features_col("ma").set_max_iter(2).fit(t3)
    pm = _port(J.PipelineModel(stages + [lr]))
    (a,) = pm.transform(T.Table({"features": X}))
    (b,) = pm.transform(T.Table({"features": X.astype(np.float32)}))
    _equal(a, b, cols=[c for c in a.column_names if c != "features"])


def test_segment_transfer_bytes():
    """Entry and fetch bytes of a scaler -> LR segment, equal to the JAX
    package's: the f32 entry matrix in; the three scaled columns the
    output table carries and the f32 margins out."""
    X, y = _table(n=64, d=8, seed=2)
    t = J.Table({"features": X, "label": y})
    stages, t3 = _jscaler_chain(t)
    lr = JLR().set_features_col("ma").set_max_iter(2).fit(t3)
    jpm = J.PipelineModel(stages + [lr])
    pm = _port(jpm)
    feats = T.Table({"features": X})
    (seg,) = pm._chain_plan([feats]).segments
    (jseg,) = jpm._chain_plan([J.Table({"features": X})]).segments
    assert seg.transfer_bytes(1 << 17) == jseg.transfer_bytes(1 << 17) \
        == ((1 << 17) * 8 * 4, (1 << 17) * (3 * 8 + 1) * 4)
    assert seg.entry_cols == ("features",)


# -- persistence --------------------------------------------------------------

def test_persist_round_trip_fused_bitexact(tmp_path):
    X, y = _table(seed=12)
    t = J.Table({"features": X, "label": y})
    stages, t3 = _jscaler_chain(t)
    lr = JLR().set_features_col("ma").set_max_iter(3).fit(t3)
    pm = _port(J.PipelineModel(stages + [lr]))
    feats = T.Table({"features": X})
    with TC.chain_disabled():
        (ref,) = pm.transform(feats)
    path = str(tmp_path / "pipeline")
    pm.save(path)
    loaded = T.PipelineModel.load(path, device="cpu")
    (out,) = loaded.transform(feats)
    _equal(ref, out)
    assert loaded._chain_plan([feats]).describe() == [("segment", 4)]
