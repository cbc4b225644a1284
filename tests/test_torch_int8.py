"""The port's int8 serving path, case by case after ``tests/test_int8.py``,
on the CPU: ``quantize_stage_params`` equals the JAX package's codes and
scales bit for bit for every family; each int8 scoring function on those
codes agrees with the JAX int8 servable (LR: rawPrediction within 1e-6,
KMeans: assignments equal, Wide&Deep: scores within rtol 1e-5, the
transform tolerances of the f32 parity tests); decisions agree with f32
to the envelope (0.99) and repeat bit for bit; refusals; precision in the
warm-up report; int8 pools hold ~2x the rows at equal bytes; cached int8
equals bypassed int8 bit for bit; the scheduler's precision gauges."""

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu import serving as JS
from flink_ml_tpu.kernels import quantize as JQ
from flink_ml_tpu_torch.kernels import quantize as TQ
from flink_ml_tpu_torch.serving import (
    SLO_BULK,
    SLO_INTERACTIVE,
    SLO_STANDARD,
    EmbeddingRowCache,
    ModelRegistry,
    SharedScheduler,
    make_servable,
)
from flink_ml_tpu_torch.utils.convert import pipeline_model_from_jax

ENVELOPE = 0.99


# -- fixtures ----------------------------------------------------------------

def _lr_table(n=64, d=8, seed=0, pkg=T):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.int64)
    return pkg.Table({"features": X, "label": y})


def _fit_lr(seed=0):
    return (T.LogisticRegression(device="cpu").set_max_iter(3)
            .fit(_lr_table(seed=seed)))


def _feats(n=256, seed=1, pkg=T):
    return _lr_table(n=n, seed=seed, pkg=pkg).drop("label")


def _widedeep(seed=6, vocab=(50, 30), n=128):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 4)).astype(np.float32)
    cat = np.stack([rng.integers(0, v, size=n) for v in vocab],
                   axis=1).astype(np.int32)
    label = (cat[:, 0] > vocab[0] // 2).astype(np.int64)
    t = T.Table({"denseFeatures": dense, "catFeatures": cat, "label": label})
    return (T.WideDeep(device="cpu").set_vocab_sizes(list(vocab))
            .set_max_iter(2).fit(t)), t


def _jax_models():
    """One fitted JAX model per int8 family, with its request columns."""
    from flink_ml_tpu.models.classification.logisticregression import (
        LogisticRegression)
    from flink_ml_tpu.models.clustering.kmeans import KMeans
    from flink_ml_tpu.models.recommendation.widedeep import WideDeep

    rng = np.random.default_rng(4)
    lr = LogisticRegression().set_max_iter(3).fit(_lr_table(pkg=J))
    centers = rng.normal(scale=6.0, size=(5, 6))
    X = np.concatenate([c + rng.normal(size=(40, 6)) for c in centers])
    km = KMeans().set_k(5).set_max_iter(5).set_seed(1).fit(
        J.Table({"features": X}))
    dense = rng.normal(size=(128, 4)).astype(np.float32)
    cat = np.stack([rng.integers(0, 50, 128), rng.integers(0, 30, 128)],
                   axis=1).astype(np.int32)
    wd = WideDeep().set_vocab_sizes([50, 30]).set_max_iter(2).fit(J.Table({
        "denseFeatures": dense, "catFeatures": cat,
        "label": (cat[:, 0] > 25).astype(np.int64)}))
    return {
        "linear_margins": (lr, {"features": np.asarray(
            _feats(pkg=J)["features"])}),
        "kmeans_assign": (km, {"features": X}),
        "widedeep_scores": (wd, {"denseFeatures": dense,
                                 "catFeatures": cat}),
    }


def _agreement(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.mean(a == b))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


# -- calibration and scoring vs the JAX package ------------------------------

@pytest.mark.parametrize("op", ["linear_margins", "kmeans_assign",
                                "widedeep_scores"])
def test_quantize_stage_params_equals_jax_bit_for_bit(op):
    jmodel, cols = _jax_models()[op]
    jkernel = jmodel.transform_kernel(J.Table(cols).schema())
    tkernel = pipeline_model_from_jax(jmodel, device="cpu").transform_kernel(
        T.Table(cols).schema())
    got = dict(_leaves(TQ.quantize_stage_params(op, tkernel.params)))
    want = dict(_leaves(JQ.quantize_stage_params(op, jkernel.params)))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("op", ["linear_margins", "kmeans_assign",
                                "widedeep_scores"])
def test_int8_servable_matches_jax_int8_servable(op):
    jmodel, cols = _jax_models()[op]
    tmodel = pipeline_model_from_jax(jmodel, device="cpu")
    jsv = JS.make_servable(jmodel, J.Table(cols).take(2), max_batch_rows=64,
                           precision="int8").warm_up()
    tsv = make_servable(tmodel, T.Table(cols).take(2), max_batch_rows=64,
                        precision="int8").warm_up()
    n = len(next(iter(cols.values())))
    for lo, hi in ((0, 1), (1, 40), (40, min(n, 104))):
        jout = jsv.predict(J.Table(cols).slice(lo, hi))
        tout = tsv.predict(T.Table(cols).slice(lo, hi))
        np.testing.assert_array_equal(tout["prediction"],
                                      np.asarray(jout["prediction"]))
        if op == "linear_margins":
            np.testing.assert_allclose(tout["rawPrediction"],
                                       jout["rawPrediction"], rtol=1e-6,
                                       atol=1e-6)
        elif op == "widedeep_scores":
            np.testing.assert_allclose(tout["rawPrediction"],
                                       jout["rawPrediction"], rtol=1e-5)


def test_quantized_ops_and_unknown_op():
    assert TQ.quantized_ops() == JQ.quantized_ops()
    with pytest.raises(KeyError, match="no int8 calibration recipe"):
        TQ.quantize_stage_params("retrieve", {})


def test_dequantize_equals_jax():
    rng = np.random.default_rng(0)
    import torch

    w = rng.normal(size=(6, 5)).astype(np.float32)
    for axis in (None, 0, 1):
        codes, scales = TQ.quantize_channelwise(w, axis)
        got = TQ.dequantize(torch.from_numpy(codes),
                            torch.as_tensor(scales), axis).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JQ.dequantize(codes, scales, axis)))


# -- servable precision plumbing ---------------------------------------------

def test_int8_linear_servable_envelope_and_bitstable():
    model = _fit_lr()
    feats = _feats(n=256)
    sv8 = make_servable(model, feats.take(2), max_batch_rows=64,
                        precision="int8").warm_up()
    svf = make_servable(model, feats.take(2), max_batch_rows=64).warm_up()
    assert sv8.precision == "int8" and svf.precision == "f32"
    out8 = sv8.predict(feats)
    outf = svf.predict(feats)
    assert _agreement(out8["prediction"], outf["prediction"]) >= ENVELOPE
    again = sv8.predict(feats)
    np.testing.assert_array_equal(again["rawPrediction"],
                                  out8["rawPrediction"])
    assert sv8.param_bytes < svf.param_bytes


def test_int8_kmeans_servable_envelope():
    rng = np.random.default_rng(4)
    centers = rng.normal(scale=6.0, size=(5, 6))
    X = np.concatenate([c + rng.normal(size=(40, 6)) for c in centers])
    t = T.Table({"features": X})
    model = T.KMeans(device="cpu").set_k(5).set_max_iter(5).set_seed(1).fit(t)
    sv8 = make_servable(model, t.take(2), max_batch_rows=64,
                        precision="int8").warm_up()
    svf = make_servable(model, t.take(2), max_batch_rows=64).warm_up()
    assert _agreement(sv8.predict(t)["prediction"],
                      svf.predict(t)["prediction"]) >= ENVELOPE
    np.testing.assert_array_equal(sv8.predict(t)["prediction"],
                                  sv8.predict(t)["prediction"])


def test_int8_widedeep_servable_envelope():
    model, t = _widedeep()
    feats = t.drop("label")
    sv8 = make_servable(model, feats.take(2), max_batch_rows=64,
                        precision="int8").warm_up()
    svf = make_servable(model, feats.take(2), max_batch_rows=64).warm_up()
    assert _agreement(sv8.predict(feats)["prediction"],
                      svf.predict(feats)["prediction"]) >= ENVELOPE
    np.testing.assert_array_equal(sv8.predict(feats)["rawPrediction"],
                                  sv8.predict(feats)["rawPrediction"])


def test_precision_refused_without_a_quantized_seam():
    """Families with no int8 function refuse at construction: the
    generic adapter, the IVF index, an unknown precision."""
    from flink_ml_tpu_torch.models.feature import StandardScaler

    t = _lr_table(n=96, seed=4)
    scaler = StandardScaler(device="cpu").set_output_col("s").fit(t)
    with pytest.raises(TypeError, match="precision"):
        make_servable(scaler, t.drop("label").take(2), precision="int8")
    X = np.random.default_rng(1).normal(size=(64, 4)).astype(np.float32)
    index = T.IVFIndex.build(X, nlist=4, device="cpu")
    with pytest.raises(TypeError, match="precision"):
        make_servable(index, T.Table({"query": X[:1]}), precision="int8")
    with pytest.raises(TypeError, match="precision"):
        make_servable(_fit_lr(), _feats().take(2), precision="fp8")


def test_int8_requires_the_kernel_plan():
    """A linear config whose transform_kernel is None (the sparse and
    mixed layouts) cannot serve int8: never a silent f32 fallback."""
    model = _fit_lr()
    model.transform_kernel = lambda schema: None
    with pytest.raises(TypeError, match="int8"):
        make_servable(model, _feats().take(2), precision="int8")


def test_warmup_report_attributes_precision_per_bucket():
    model = _fit_lr()
    rep = make_servable(model, _feats().take(2), max_batch_rows=32,
                        precision="int8").warm_up().warmup_report
    assert rep["precision"] == "int8"
    assert rep["buckets"]
    assert all(b["precision"] == "int8" for b in rep["buckets"].values())
    repf = make_servable(model, _feats().take(2),
                         max_batch_rows=32).warm_up().warmup_report
    assert repf["precision"] == "f32"
    assert all(b["precision"] == "f32" for b in repf["buckets"].values())


# -- embedding-row cache int8 pools ------------------------------------------

def test_embcache_int8_pools_double_resident_rows_at_equal_bytes():
    rng = np.random.default_rng(5)
    V, E, B = 256, 16, 8
    emb = rng.normal(size=(V, E)).astype(np.float32)
    cache_f = EmbeddingRowCache({"emb": emb}, block_rows=B,
                                capacity_blocks=8, device="cpu")
    cache_q = EmbeddingRowCache({"emb": emb}, block_rows=B,
                                capacity_blocks=8, precision="int8",
                                device="cpu")
    assert cache_q.snapshot()["precision"] == "int8"
    budget = cache_f.pool_bytes
    per_block_q = cache_q.pool_bytes // 8
    assert cache_q.pool_bytes * 2 <= budget + 8 * B * 4  # ~half + scales
    cap_q = budget // per_block_q
    assert cap_q >= 2 * 8
    cache_q2 = EmbeddingRowCache({"emb": emb}, block_rows=B,
                                 capacity_blocks=int(cap_q),
                                 precision="int8", device="cpu")
    assert cache_q2.pool_bytes <= budget
    assert cache_q2.capacity_blocks * B >= 2 * 8 * B
    jcache = JS.EmbeddingRowCache({"emb": emb}, block_rows=B,
                                  capacity_blocks=8, precision="int8")
    assert cache_q.pool_bytes == jcache.pool_bytes


def test_embcache_int8_cached_and_bypass_paths_agree_bitwise():
    rng = np.random.default_rng(6)
    V, E = 64, 6
    emb = rng.normal(size=(V, E)).astype(np.float32)
    wc = rng.normal(size=(V,)).astype(np.float32)
    cache = EmbeddingRowCache({"emb": emb, "wide_cat": wc}, block_rows=8,
                              capacity_blocks=2, precision="int8",
                              device="cpu")
    jcache = JS.EmbeddingRowCache({"emb": emb, "wide_cat": wc},
                                  block_rows=8, capacity_blocks=2,
                                  precision="int8")
    ids = np.array([[0, 9], [1, 8]])
    cached = cache.lookup(ids)["emb"].numpy()
    np.testing.assert_array_equal(cached,
                                  np.asarray(jcache.lookup(ids)["emb"]))
    big = np.array([[0, 9], [1, 8], [16, 24], [32, 40], [48, 56]])
    out = cache.lookup(big)                      # exceeds capacity
    assert cache.bypasses == 1
    np.testing.assert_array_equal(out["emb"].numpy()[:2], cached)
    # 1-d scalar-row tables never quantize: wide_cat rows stay exact
    np.testing.assert_array_equal(out["wide_cat"].numpy(), wc[big])


def test_cached_widedeep_int8_envelope_bitstable_and_bypass_equal():
    model, t = _widedeep(seed=9)
    feats = t.drop("label")
    kw = dict(emb_cache=True, cache_block_rows=8, max_batch_rows=64,
              precision="int8")
    sv8 = make_servable(model, feats.take(2), cache_capacity_blocks=6,
                        **kw).warm_up()
    assert sv8.precision == "int8"
    assert sv8.cache.snapshot()["precision"] == "int8"
    offline = model.transform(feats)[0]
    served = sv8.predict(feats)
    assert _agreement(served["prediction"],
                      offline["prediction"]) >= ENVELOPE
    again = sv8.predict(feats)
    np.testing.assert_array_equal(again["rawPrediction"],
                                  served["rawPrediction"])
    # a one-block cache bypasses every batch: the same bits from the host
    # dequantize of the same codes
    tiny = make_servable(model, feats.take(2), cache_capacity_blocks=1,
                         **kw).warm_up()
    for lo, hi in ((0, 1), (0, 40), (40, 128)):
        np.testing.assert_array_equal(
            tiny.predict(feats.slice(lo, hi))["rawPrediction"],
            sv8.predict(feats.slice(lo, hi))["rawPrediction"])
    assert tiny.cache.bypasses > 0


# -- scheduler: precision attribution ----------------------------------------

def test_scheduler_precision_gauges_and_shared_servable_inheritance():
    s = SharedScheduler(ModelRegistry(device="cpu"), max_batch_rows=64,
                        max_wait_ms=0.5, queue_capacity=1024)
    feats = _feats(seed=3)
    try:
        s.add_tenant("quant", _fit_lr(seed=1), feats.take(2),
                     slo=SLO_INTERACTIVE, precision="int8")
        s.add_tenant("plain", _fit_lr(seed=2), feats.take(2),
                     slo=SLO_STANDARD)
        s.add_tenant("shadow", servable_of="quant", slo=SLO_BULK)
        assert s.tenant("quant").precision == "int8"
        assert s.tenant("plain").precision == "f32"
        assert s.tenant("shadow").precision == "int8"
        for name, want in (("quant", "int8"), ("plain", "f32"),
                           ("shadow", "int8")):
            gauge = s.tenant(name).metrics.group.gauge("precision")
            assert gauge.value == want
        rep = s.tenant("quant").admission_report
        assert rep is not None and rep["precision"] == "int8"
        assert all(b["precision"] == "int8"
                   for b in rep["buckets"].values())
        s._refresh_gauges()
        assert s._int8_tenants.value == 2
    finally:
        s.close()


def test_second_int8_tenant_serves_its_own_quantized_program():
    """Tenant N+1 of an already-served int8 schema: its answers are its
    own model's int8 servable's, bit for bit."""
    feats = _feats(seed=7)
    s = SharedScheduler(ModelRegistry(device="cpu"), max_batch_rows=64,
                        max_wait_ms=0.5, queue_capacity=1024)
    s.add_tenant("q1", _fit_lr(seed=1), feats.take(2),
                 slo=SLO_INTERACTIVE, precision="int8")
    s.start()
    try:
        for n in (1, 2, 64):
            s.predict("q1", feats.take(n), timeout=30)
        model2 = _fit_lr(seed=2)
        tenant = s.add_tenant("q2", model2, feats.take(2), slo=SLO_BULK,
                              precision="int8")
        out = s.predict("q2", feats.take(5), timeout=30)
        assert tenant.admission_report["precision"] == "int8"
        assert tenant.admission_report["compiled"] == 0
        sv = make_servable(model2, feats.take(2), max_batch_rows=64,
                           precision="int8").warm_up()
        np.testing.assert_array_equal(
            out["rawPrediction"],
            sv.predict(feats.take(5))["rawPrediction"])
    finally:
        s.close()
