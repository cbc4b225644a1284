"""The port's serving runtime (``flink_ml_tpu_torch.serving``), case by case
after ``tests/test_serving.py``, on the CPU.

The JAX package fits each family as its tests do; the port deploys the
JAX-saved directory (``ModelRegistry(device="cpu")``) or the model
carried over with ``utils/convert.py``.  Inside the port every response
equals the offline ``transform`` of its request bit for bit; against the
JAX package's servable on the same requests, per family:

- LogisticRegression: predictions equal, rawPrediction within 1e-6
  (``tests/test_torch_chain.py``'s continuous tolerance);
- LinearRegression: prediction within 1e-5 (``test_torch_linear_models``);
- KMeans: predictions equal (the fixture's points are far from ties);
- Wide&Deep: predictions equal, rawPrediction within rtol 1e-5
  (``test_torch_widedeep.py``'s transform tolerance).

The GBT round trips of the JAX file wait for the GBT port (ROADMAP A6.3).
The JAX file's zero-lowering test becomes the port's analogue: steady
state runs one kernel segment a batch, builds no plan and loads no
kernel library.  Every blocking wait has a timeout and every endpoint
closes in a ``finally``."""

import json
import os
import threading

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu import serving as JS
from flink_ml_tpu.utils.padding import bucket_sizes as jax_bucket_sizes
from flink_ml_tpu.models.classification.logisticregression import (
    LogisticRegression as JLR,
)
from flink_ml_tpu_torch.api import chain as TC
from flink_ml_tpu_torch.models.feature import (StandardScaler,
                                               StandardScalerModel)
from flink_ml_tpu_torch.serving import (
    MicroBatcher,
    ModelRegistry,
    ServingEndpoint,
    ServingOverloadedError,
    make_servable,
    serve_model,
)
from flink_ml_tpu_torch.utils.convert import pipeline_model_from_jax
from flink_ml_tpu_torch.utils.padding import (
    DEFAULT_BUCKET_CAP,
    bucket_rows,
    bucket_sizes,
    pad_rows_to_bucket,
)

JOIN_S = 30


def _lr_table(n=64, d=8, seed=0, pkg=T):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.int64)
    return pkg.Table({"features": X, "label": y})


def _fit_lr(seed=0):
    return (T.LogisticRegression(device="cpu").set_max_iter(5)
            .fit(_lr_table(seed=seed)))


def _lr_from_weights(w, b):
    model = T.LogisticRegressionModel(device="cpu")
    model.set_model_data(T.Table({"coefficients": np.asarray(w)[None, :],
                                  "intercept": np.array([b])}))
    return model


def _requests(table, sizes):
    """Non-overlapping request tables of the given row counts."""
    out, start = [], 0
    for s in sizes:
        out.append(table.slice(start, start + s))
        start += s
    return out


def _join_all(threads):
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


# -- bucket padding helpers --------------------------------------------------

@pytest.mark.parametrize("max_rows,min_bucket", [
    (1, 8), (8, 8), (9, 8), (64, 8), (100, 8), (256, 8), (3, 2), (256, 16),
    (1000, 32)])
def test_bucket_sizes_equal_jax(max_rows, min_bucket):
    assert bucket_sizes(max_rows, min_bucket) == \
        jax_bucket_sizes(max_rows, min_bucket)


def test_bucket_rows_ladder():
    assert bucket_rows(1) == 8 and bucket_rows(8) == 8
    assert bucket_rows(9) == 16
    assert bucket_rows(100) == 128
    assert bucket_rows(3, min_bucket=2) == 4
    assert bucket_sizes(64) == (8, 16, 32, 64)
    assert bucket_sizes(100) == (8, 16, 32, 64, 128)
    with pytest.raises(ValueError):
        bucket_rows(4, min_bucket=0)
    with pytest.raises(ValueError):
        bucket_sizes(0)


def test_pad_rows_to_bucket_caps_huge_batches():
    big = np.ones((DEFAULT_BUCKET_CAP + 1, 2), np.float32)
    (padded,), n = pad_rows_to_bucket((big,))
    assert padded.shape[0] == n == DEFAULT_BUCKET_CAP + 1  # exact shape kept
    (padded,), n = pad_rows_to_bucket((np.ones((9, 2), np.float32),),
                                      max_bucket_rows=None)
    assert padded.shape[0] == 16 and n == 9    # None = unlimited bucketing
    with pytest.raises(ValueError, match="bucket cap"):
        make_servable(_fit_lr(), _lr_table().drop("label").take(1),
                      max_batch_rows=DEFAULT_BUCKET_CAP * 2)


# -- save -> deploy -> serve round trips -------------------------------------

def _jax_family(family):
    """(fitted JAX model, request columns, request sizes), each family
    fitted as ``tests/test_serving.py`` fits it."""
    rng = np.random.default_rng({"lr": 3, "linreg": 1, "kmeans": 2,
                                 "widedeep": 6}[family])
    if family == "lr":
        model = JLR().set_max_iter(5).fit(_lr_table(pkg=J))
        cols = {"features": np.asarray(_lr_table(seed=3)["features"])}
        return model, cols, (1, 3, 8, 13, 30)
    if family == "linreg":
        from flink_ml_tpu.models.regression.linearregression import (
            LinearRegression)

        X = rng.normal(size=(64, 6))
        t = J.Table({"features": X, "label": X @ rng.normal(size=6) + 0.2})
        return (LinearRegression().set_max_iter(5).fit(t),
                {"features": X}, (2, 5, 16, 31))
    if family == "kmeans":
        from flink_ml_tpu.models.clustering.kmeans import KMeans

        pts = np.concatenate([rng.normal(loc=c, size=(20, 3))
                              for c in (-4.0, 0.0, 4.0)]).astype(np.float32)
        model = KMeans().set_k(3).set_max_iter(5).fit(
            J.Table({"features": pts}))
        return model, {"features": pts}, (1, 7, 20, 32)
    from flink_ml_tpu.models.recommendation.widedeep import WideDeep

    n = 128
    dense = rng.normal(size=(n, 4)).astype(np.float32)
    cat = np.stack([rng.integers(0, 10, size=n),
                    rng.integers(0, 7, size=n)], axis=1).astype(np.int32)
    label = (cat[:, 0] > 4).astype(np.int64)
    t = J.Table({"denseFeatures": dense, "catFeatures": cat,
                 "label": label})
    model = WideDeep().set_vocab_sizes([10, 7]).set_max_iter(5).fit(t)
    return model, {"denseFeatures": dense, "catFeatures": cat}, \
        (1, 6, 14, 32)


def _against_jax(family, jout, tout):
    if family == "linreg":
        np.testing.assert_allclose(tout["prediction"], jout["prediction"],
                                   atol=1e-5)
        return
    np.testing.assert_array_equal(tout["prediction"],
                                  np.asarray(jout["prediction"]))
    if family == "lr":
        np.testing.assert_allclose(tout["rawPrediction"],
                                   jout["rawPrediction"], rtol=1e-6,
                                   atol=1e-6)
    elif family == "widedeep":
        np.testing.assert_allclose(tout["rawPrediction"],
                                   jout["rawPrediction"], rtol=1e-5)


@pytest.mark.parametrize("origin", ["jax_saved", "port_saved"])
@pytest.mark.parametrize("family", ["lr", "linreg", "kmeans", "widedeep"])
def test_roundtrip_serves_offline_transform_and_matches_jax(
        tmp_path, family, origin):
    """save -> registry deploy from the path (warmed) -> serve each
    request: every response equals the loaded model's offline transform
    bit for bit, and the JAX servable's predict within the family's
    tolerance.  ``jax_saved`` deploys the directory the JAX package wrote;
    ``port_saved`` the port's own save of the carried-over model."""
    from flink_ml_tpu_torch.utils import persist

    jmodel, cols, sizes = _jax_family(family)
    path = str(tmp_path / "model")
    if origin == "jax_saved":
        jmodel.save(path)
    else:
        pipeline_model_from_jax(jmodel, device="cpu").save(path)
    loaded = persist.load_stage(path, device="cpu")
    assert type(loaded).__name__ == type(jmodel).__name__
    reqs = _requests(T.Table(cols), sizes)
    jreqs = _requests(J.Table(cols), sizes)
    jserv = JS.make_servable(jmodel, jreqs[0], max_batch_rows=64).warm_up()
    registry = ModelRegistry(device="cpu")
    registry.deploy("m", path, reqs[0], max_batch_rows=64)
    endpoint = ServingEndpoint(registry, "m", max_wait_ms=0.5).start()
    try:
        for req, jreq in zip(reqs, jreqs):
            served = endpoint.predict(req, timeout=JOIN_S)
            offline = loaded.transform(req)[0]
            assert served.column_names == offline.column_names
            for col in offline.column_names:
                np.testing.assert_array_equal(served[col], offline[col])
            _against_jax(family, jserv.predict(jreq), served)
    finally:
        endpoint.close()


def test_steady_state_builds_no_plan_and_loads_no_library(monkeypatch):
    """The port's analogue of the zero-lowering test: after warm-up, every
    predict runs exactly one single-stage segment (``dispatch_count`` +1),
    asks the model for no new kernel and loads no kernel library."""
    from flink_ml_tpu_torch.kernels import build

    model = _fit_lr()
    feats = _lr_table(n=128, seed=7).drop("label")
    endpoint = serve_model(model, feats.take(2), max_batch_rows=64,
                           max_wait_ms=0.5)
    plans = []
    real_kernel = type(model).transform_kernel
    monkeypatch.setattr(type(model), "transform_kernel",
                        lambda self, schema: plans.append(schema)
                        or real_kernel(self, schema))

    def no_load(name):
        raise AssertionError(f"library {name} loaded in steady state")

    monkeypatch.setattr(build, "load_library", no_load)
    try:
        for n in (1, 3, 4, 7, 8, 11, 16, 23, 33, 48, 64):
            before = TC.dispatch_count()
            out = endpoint.predict(feats.take(n), timeout=JOIN_S)
            assert TC.dispatch_count() == before + 1
            assert out.num_rows == n
        assert plans == []
    finally:
        endpoint.close()


def test_warmup_required_before_start():
    registry = ModelRegistry(device="cpu")
    endpoint = ServingEndpoint(registry, "missing")
    with pytest.raises(KeyError):
        endpoint.start()   # nothing deployed

    class _Factory:
        def __call__(self, model, example, **kw):
            servable = make_servable(model, example, **kw)
            servable.warm_up = lambda: servable   # deploy skips warming
            return servable

    cold = ModelRegistry(servable_factory=_Factory(), device="cpu")
    cold.deploy("m", _fit_lr(), _lr_table().drop("label").take(1))
    with pytest.raises(RuntimeError, match="not.*warmed"):
        ServingEndpoint(cold, "m").start()


def test_warmup_report_keys_and_untracked_sources():
    """The JAX report's keys, with the JAX meaning of ``source``: a
    kernel-served warm-up's bucket is ``compile`` at the first run of its
    ``(plan, shapes)`` key in the process and ``cache`` at a later one
    (``aot`` where it loaded a library from the cache root), never
    ``untracked``; a second warm-up of the same shapes is all cache
    hits."""
    feats = _lr_table().drop("label")
    servable = make_servable(_fit_lr(), feats.take(1), max_batch_rows=32)
    rep = servable.warm_up().warmup_report
    jrep = JS.make_servable(
        JLR().set_max_iter(2).fit(_lr_table(pkg=J)),
        _lr_table(pkg=J).drop("label").take(1),
        max_batch_rows=32).warm_up().warmup_report
    assert set(rep) == set(jrep)
    assert set(rep["buckets"]) == set(jrep["buckets"]) == {8, 16, 32}
    for b in rep["buckets"].values():
        assert set(b) == {"source", "ms", "precision"}
        assert b["source"] in ("compile", "cache")
    assert rep["compiled"] + rep["cache_hits"] == 3
    assert rep["aot_loaded"] == 0
    again = make_servable(_fit_lr(), feats.take(1),
                          max_batch_rows=32).warm_up().warmup_report
    assert [b["source"] for b in again["buckets"].values()] == ["cache"] * 3
    assert again["compiled"] == again["aot_loaded"] == 0
    assert again["cache_hits"] == 3


# -- micro-batcher ----------------------------------------------------------

def test_microbatcher_coalesces_and_respects_capacity():
    batcher = MicroBatcher(max_batch_rows=16, max_wait_ms=20.0,
                           queue_capacity=4)
    t = _lr_table(n=32).drop("label")
    for _ in range(3):
        batcher.submit(t.take(4))
    batch = batcher.next_batch(timeout=0.1)
    assert [r.rows for r in batch] == [4, 4, 4]   # coalesced in order

    # a request that would overflow max_batch_rows stays for the next batch
    batcher.submit(t.take(12))
    batcher.submit(t.take(8))
    batch = batcher.next_batch(timeout=0.1)
    assert [r.rows for r in batch] == [12]
    batch = batcher.next_batch(timeout=0.1)
    assert [r.rows for r in batch] == [8]

    # bounded queue: capacity 4, fifth submit sheds
    for _ in range(4):
        batcher.submit(t.take(1))
    with pytest.raises(ServingOverloadedError, match="queue full"):
        batcher.submit(t.take(1))

    with pytest.raises(ValueError, match="max_batch_rows"):
        batcher.submit(t.take(17))
    with pytest.raises(ValueError, match="empty"):
        batcher.submit(t.take(0))


def test_microbatcher_requeue_restores_order_and_bypasses_capacity():
    batcher = MicroBatcher(max_batch_rows=8, max_wait_ms=0.0,
                           queue_capacity=2)
    t = _lr_table(n=16).drop("label")
    first = [batcher.submit(t.take(1)) for _ in range(2)]
    batch = batcher.next_batch(timeout=0.1)
    batcher.submit(t.take(2))
    batcher.submit(t.take(3))
    assert batcher.requeue(batch) == 2          # capacity 2, yet admitted
    again = batcher.next_batch(timeout=0.1)
    assert [r.request_id for r in again[:2]] == [r.request_id
                                                 for r in first]


def test_queue_full_requests_shed_with_documented_error():
    model = _fit_lr()
    feats = _lr_table(seed=8).drop("label")
    registry = ModelRegistry(device="cpu")
    registry.deploy("m", model, feats.take(1), max_batch_rows=32)
    endpoint = ServingEndpoint(registry, "m", max_batch_rows=32,
                               queue_capacity=3)
    try:
        # endpoint NOT started: submits accumulate in the bounded queue
        futures = [endpoint.submit(feats.take(1)) for _ in range(3)]
        with pytest.raises(ServingOverloadedError, match="shed"):
            endpoint.submit(feats.take(1))
        assert endpoint.metrics.shed.value == 1
        endpoint.start()   # queued requests drain once serving begins
        ref = model.transform(feats.take(1))[0]["rawPrediction"]
        for future in futures:
            np.testing.assert_array_equal(
                future.result(JOIN_S)["rawPrediction"], ref)
    finally:
        endpoint.close()


def test_schema_mismatch_rejected():
    endpoint = serve_model(_fit_lr(), _lr_table().drop("label").take(1),
                           max_batch_rows=32)
    try:
        with pytest.raises(ValueError, match="schema"):
            endpoint.predict(T.Table({"wrong": np.ones((2, 8))}),
                             timeout=JOIN_S)
    finally:
        endpoint.close()


# -- hot swap ----------------------------------------------------------------

def test_hot_swap_atomic_and_bitexact_under_load():
    rng = np.random.default_rng(9)
    d = 8
    model_a = _lr_from_weights(rng.normal(size=d), 0.0)
    model_b = _lr_from_weights(rng.normal(size=d) + 3.0, -1.0)
    feats = T.Table({"features": rng.normal(size=(256, d))})
    reqs = _requests(feats, [1 + i % 7 for i in range(40)])
    ref_a = [model_a.transform(r)[0]["rawPrediction"] for r in reqs]
    ref_b = [model_b.transform(r)[0]["rawPrediction"] for r in reqs]

    endpoint = serve_model(model_a, feats.take(1), max_batch_rows=64,
                           max_wait_ms=0.5, queue_capacity=4096)
    results = [None] * len(reqs)
    errors = []

    def client(worker, n_workers):
        try:
            for i in range(worker, len(reqs), n_workers):
                results[i] = endpoint.predict(reqs[i], timeout=JOIN_S)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    try:
        threads = [threading.Thread(target=client, args=(w, 4))
                   for w in range(4)]
        for t in threads:
            t.start()
        # swap mid-flight: warm-up runs here, OFF the serving path
        deployed = endpoint.registry.deploy("default", model_b)
        assert deployed.generation == 2
        # a request submitted after the deploy returned must see B
        post = feats.take(5)
        np.testing.assert_array_equal(
            endpoint.predict(post, timeout=JOIN_S)["rawPrediction"],
            model_b.transform(post)[0]["rawPrediction"])
        _join_all(threads)
        assert not errors
        # atomicity: every response equals EXACTLY one version's offline
        # transform — never a mix of generations within one response
        for i, out in enumerate(results):
            raw = out["rawPrediction"]
            assert np.array_equal(raw, ref_a[i]) or \
                np.array_equal(raw, ref_b[i]), f"request {i} matches neither"
        assert endpoint.metrics.group.snapshot()["model_generation"] == 2
    finally:
        endpoint.close()


def test_failed_hot_swap_rolls_back_and_a_good_one_heals(tmp_path):
    model_a, model_b = _fit_lr(seed=1), _fit_lr(seed=2)
    feats = _lr_table(seed=4).drop("label")
    endpoint = serve_model(model_a, feats.take(1), max_batch_rows=32)
    try:
        kept = endpoint.hot_swap(str(tmp_path / "no_such_model"))
        assert kept.generation == 1
        assert endpoint.metrics.health == "DEGRADED"
        assert endpoint.metrics.rollbacks.value == 1
        np.testing.assert_array_equal(
            endpoint.predict(feats.take(3), timeout=JOIN_S)["rawPrediction"],
            model_a.transform(feats.take(3))[0]["rawPrediction"])
        path = str(tmp_path / "b")
        model_b.save(path)
        endpoint.registry.device = "cpu"
        assert endpoint.hot_swap(path).generation == 2
        assert endpoint.metrics.health == "SERVING"
        np.testing.assert_array_equal(
            endpoint.predict(feats.take(3), timeout=JOIN_S)["rawPrediction"],
            model_b.transform(feats.take(3))[0]["rawPrediction"])
    finally:
        endpoint.close()


def test_registry_redeploy_inherits_example_and_generation():
    registry = ModelRegistry(device="cpu")
    feats = _lr_table().drop("label")
    gen1 = registry.deploy("m", _fit_lr(), feats.take(2), max_batch_rows=32)
    assert gen1.generation == 1 and gen1.servable.ready
    gen2 = registry.deploy("m", _fit_lr(seed=11))   # example inherited
    assert gen2.generation == 2
    assert gen2.servable.example is gen1.servable.example
    assert gen2.servable.max_batch_rows == 32
    with pytest.raises(ValueError, match="example"):
        registry.deploy("fresh", _fit_lr())


def test_publish_servable_rebind_and_generation_conflict():
    """A rebound clone is ready without a warm-up and scores the new
    params; a conditional publish against a stale generation is
    refused."""
    from flink_ml_tpu_torch.serving import GenerationConflict

    registry = ModelRegistry(device="cpu")
    feats = _lr_table().drop("label")
    a, b = _fit_lr(seed=1), _fit_lr(seed=2)
    live = registry.deploy("m", a, feats.take(2), max_batch_rows=32)
    clone = live.servable.rebind(b)
    assert clone.ready and clone is not live.servable
    np.testing.assert_array_equal(
        clone.predict(feats.take(5))["rawPrediction"],
        b.transform(feats.take(5))[0]["rawPrediction"])
    assert registry.publish_servable("m", clone,
                                     expected_generation=1).generation == 2
    with pytest.raises(GenerationConflict):
        registry.publish_servable("m", clone, expected_generation=1)
    generic = make_servable(StandardScalerModel(device="cpu"),
                            feats.take(1))
    with pytest.raises(TypeError, match="rebind-safe"):
        generic.rebind(a)


@pytest.mark.parametrize("family", ["lr", "linreg", "kmeans", "widedeep"])
def test_delta_publisher_serves_the_published_bits(family):
    """``endpoint.delta_publisher()`` publishes into the endpoint's entry:
    a nudged generation of each family swaps in through the rebind (one
    generation up, accounted on the endpoint), and every response after it
    is the offline transform of the published model bit for bit — and
    the JAX package's servable of the same params within the family's
    tolerance."""
    from flink_ml_tpu import online as JO
    from flink_ml_tpu_torch.online import (DeltaEncoder, encode_and_publish,
                                           flatten_params, model_with_params,
                                           params_of_model,
                                           unflatten_params)

    jmodel, cols, sizes = _jax_family(family)
    model = pipeline_model_from_jax(jmodel, device="cpu")
    reqs = _requests(T.Table(cols), sizes)
    endpoint = serve_model(model, reqs[0], max_batch_rows=64,
                           max_wait_ms=0.5)
    try:
        pub = endpoint.delta_publisher()
        enc = DeltaEncoder()
        p = params_of_model(model)
        flat = flatten_params(p)
        key = max(flat, key=lambda k: flat[k].size)
        nudged = dict(flat)
        nudged[key] = flat[key].copy()
        nudged[key].reshape(-1)[::3] += np.float32(0.25)
        p2 = unflatten_params(p, nudged)
        gen0 = endpoint.registry.current("default").generation
        res = encode_and_publish(enc, pub, 1, p2)
        assert res.mode == "full" and res.generation == gen0 + 1
        assert endpoint.metrics.snapshot()["publishes_full"] == 1
        published = endpoint.registry.current("default").servable.model
        assert flatten_params(params_of_model(published))[key].tobytes() \
            == nudged[key].tobytes()
        jpublished = JO.model_with_params(jmodel, p2)
        jserv = JS.make_servable(jpublished, _requests(J.Table(cols),
                                                       sizes)[0],
                                 max_batch_rows=64).warm_up()
        for req, jreq in zip(reqs, _requests(J.Table(cols), sizes)):
            served = endpoint.predict(req, timeout=JOIN_S)
            offline = model_with_params(model, p2).transform(req)[0]
            for col in offline.column_names:
                np.testing.assert_array_equal(served[col], offline[col])
            _against_jax(family, jserv.predict(jreq), served)
    finally:
        endpoint.close()


def test_delta_publisher_second_cut_ships_a_sparse_delta():
    """The endpoint's publisher ships a one-coefficient change as a sparse
    delta (12 bytes on the wire) and the endpoint serves it."""
    from flink_ml_tpu_torch.online import DeltaEncoder, params_of_model

    model = _fit_lr()
    feats = _lr_table(seed=5).drop("label")
    endpoint = serve_model(model, feats.take(1), max_batch_rows=16,
                           max_wait_ms=0.5)
    try:
        pub, enc = endpoint.delta_publisher(), DeltaEncoder()
        p = params_of_model(model)
        pub.apply(enc.encode(1, p, pub.stats))
        enc.ack()
        p2 = {"w": p["w"].copy(), "b": p["b"]}
        p2["w"][3] = np.float32(-4.0)
        res = pub.apply(enc.encode(2, p2, pub.stats))
        assert res.mode == "delta" and res.payload_bytes == 12
        assert endpoint.metrics.snapshot()["publishes_delta"] == 1
        out = endpoint.predict(feats.take(5), timeout=JOIN_S)
        np.testing.assert_array_equal(
            out["rawPrediction"],
            _lr_from_weights(p2["w"], float(p2["b"])).transform(
                feats.take(5))[0]["rawPrediction"])
    finally:
        endpoint.close()


def test_chip_down_at_dispatch_requeues_and_answers_bit_identically():
    """An injected ``chip_down`` at the endpoint's dispatch boundary puts
    the batch back with its futures; the retried dispatch answers every
    request exactly, and nothing is dropped."""
    from flink_ml_tpu_torch.robustness import FaultPlan

    model = _fit_lr()
    feats = _lr_table(n=64, seed=5).drop("label")
    reqs = _requests(feats, (1, 2, 3, 4, 5))
    endpoint = serve_model(model, feats.take(1), max_batch_rows=32,
                           max_wait_ms=0.5)
    plan = FaultPlan(seed=3).inject("serving.dispatch", at=0,
                                    kind="chip_down", times=2)
    try:
        with plan:
            futures = [endpoint.submit(r) for r in reqs]
            outs = [f.result(JOIN_S) for f in futures]
        assert [f[2] for f in plan.fires] == ["chip_down", "chip_down"]
        for req, out in zip(reqs, outs):
            np.testing.assert_array_equal(
                out["rawPrediction"],
                model.transform(req)[0]["rawPrediction"])
        assert endpoint.metrics.requeued.value >= 2
    finally:
        endpoint.close()


# -- persist diagnosability (the registry's load path) -----------------------

def test_load_stage_missing_class_is_clear_ioerror(tmp_path):
    from flink_ml_tpu_torch.utils import persist

    path = str(tmp_path / "m")
    _fit_lr().save(path)
    meta_path = os.path.join(path, "metadata")
    with open(meta_path) as f:
        meta = json.load(f)

    meta["className"] = "flink_ml_tpu.models.classification." \
        "logisticregression.RenamedAway"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(IOError, match="RenamedAway") as exc_info:
        persist.load_stage(path)
    assert path in str(exc_info.value)

    meta["className"] = "no_such_module.Thing"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(IOError, match="no_such_module.Thing"):
        persist.load_stage(path)

    del meta["className"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(IOError, match="className"):
        persist.load_stage(path)


# -- prefetch per-chunk stats as gauges --------------------------------------

def test_prefetch_chunk_stats_published_as_gauges():
    from flink_ml_tpu_torch.data.prefetch import prefetch_to_device
    from flink_ml_tpu_torch.utils.metrics import MetricGroup

    group = MetricGroup("prefetch")
    batches = [{"x": np.full((4, 2), i, np.float32)} for i in range(7)]
    seen = 0
    for chunk, mask, n_valid in prefetch_to_device(
            iter(batches), chunks=3, metric_group=group, device="cpu",
            transform=lambda b: (b["x"],)):
        seen += n_valid
    assert seen == 7
    snap = group.snapshot()
    assert snap["chunks_emitted"] == 3      # ceil(7 / 3)
    assert snap["batches"] == 7
    # final chunk padded 3 -> 1 real: 2 pad slots of 9 total
    assert snap["pad_fraction"] == pytest.approx(2 / 9, abs=1e-4)
    assert snap["put_overlap_s"] >= 0.0
    assert snap["chunk_assemble_s"] >= 0.0


# -- kernel seams the servables set ------------------------------------------

def _record_fn(static, params, cols):
    (seen,) = static
    seen.append(tuple(cols["x"].shape))
    return {"y": cols["x"] * params["scale"]}


def test_run_kernel_params_and_min_bucket():
    """``run_kernel(params=)`` runs on the given (device) params instead
    of copying ``kernel.params``; ``min_bucket`` is the padding floor."""
    import torch

    seen = []
    kernel = TC.StageKernel(fn=_record_fn, static=(seen,),
                            params={"scale": np.float32(2.0)},
                            consumes=("x",), produces=("y",), device="cpu")
    table = T.Table({"x": np.arange(3, dtype=np.float32)})
    np.testing.assert_array_equal(TC.run_kernel(kernel, table)["y"],
                                  [0.0, 2.0, 4.0])
    out = TC.run_kernel(kernel, table, params={"scale": torch.tensor(3.0)},
                        min_bucket=32)
    np.testing.assert_array_equal(out["y"], [0.0, 3.0, 6.0])
    assert seen == [(8,), (32,)]


def test_pipeline_servable_honors_min_bucket_and_serves_fused():
    """The plan pads with the servable's own bucket floor, and a served
    batch is the fused transform bit for bit (one segment run)."""
    X = np.random.default_rng(5).normal(size=(96, 4))
    t = T.Table({"features": X, "label": (X[:, 0] > 0).astype(np.int64)})
    scaler = StandardScaler(device="cpu").set_output_col("s").fit(t)
    lr = (T.LogisticRegression(device="cpu").set_features_col("s")
          .set_max_iter(2).fit(scaler.transform(t)[0]))
    pm = T.PipelineModel([scaler, lr])
    feats = t.drop("label")
    servable = make_servable(pm, feats.take(2), max_batch_rows=64,
                             min_bucket=16).warm_up()
    assert servable._plan is not None
    assert servable._plan.config.min_bucket == 16
    assert servable.buckets == (16, 32, 64)
    before = TC.dispatch_count()
    served = servable.predict(feats.take(7))
    assert TC.dispatch_count() == before + 1
    want = pm.transform(feats.take(7))[0]
    np.testing.assert_array_equal(served["rawPrediction"],
                                  want["rawPrediction"])


def test_retrieve_servable_equals_search_of_each_request():
    """The IVF and IVF-PQ indexes serve coalesced batches whose ids and
    distance bits equal ``index.search`` of each request alone."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(512, 8)).astype(np.float32)
    for pq in (None, T.PQConfig(m=2, ksub=8)):
        index = T.IVFIndex.build(X, nlist=8, pq=pq, device="cpu", nprobe=2)
        q = rng.normal(size=(40, 8)).astype(np.float32)
        example = T.Table({index.query_col: q[:1]})
        endpoint = serve_model(index, example, max_batch_rows=64,
                               max_wait_ms=2.0)
        try:
            reqs = _requests(T.Table({index.query_col: q}), (1, 3, 8, 12, 16))
            futures = [endpoint.submit(r) for r in reqs]
            for req, fut in zip(reqs, futures):
                out = fut.result(JOIN_S)
                ids, dist = index.search(req[index.query_col])
                np.testing.assert_array_equal(out[index.neighbors_col], ids)
                np.testing.assert_array_equal(out[index.distances_col],
                                              dist)
        finally:
            endpoint.close()


# -- concurrency -------------------------------------------------------------

def test_concurrent_clients_coalesce_and_stay_exact():
    model = _fit_lr()
    feats = _lr_table(n=256, seed=12).drop("label")
    reqs = _requests(feats, [1 + i % 5 for i in range(48)])
    refs = [model.transform(r)[0]["rawPrediction"] for r in reqs]
    endpoint = serve_model(model, feats.take(1), max_batch_rows=64,
                           max_wait_ms=5.0, queue_capacity=4096)
    results = [None] * len(reqs)

    def client(worker, n_workers):
        for i in range(worker, len(reqs), n_workers):
            results[i] = endpoint.predict(reqs[i], timeout=JOIN_S)

    try:
        threads = [threading.Thread(target=client, args=(w, 8))
                   for w in range(8)]
        for t in threads:
            t.start()
        _join_all(threads)
        for out, ref in zip(results, refs):
            np.testing.assert_array_equal(out["rawPrediction"], ref)
        snap = endpoint.metrics.snapshot()
        assert snap["requests"] == len(reqs)
        # 8 concurrent clients against a 5ms wait: batches must coalesce
        assert snap["batches"] < snap["requests"]
        assert 0.0 < snap["batch_fill_ratio"] <= 1.0
        assert snap["latency_p99_ms"] >= snap["latency_p50_ms"] > 0.0
        assert snap["kernels.dispatches"] >= snap["batches"]
    finally:
        endpoint.close()


def test_metrics_publish_skips_quantiles_when_no_new_samples():
    """The p50/p99 recompute is an O(window) np.quantile pass under the
    ring lock — a metric tick with no new samples must skip it, and the
    pair must come from ONE quantiles() call, not two ring passes."""
    from flink_ml_tpu_torch.serving.metrics import (LatencyTracker,
                                                    ServingMetrics)

    m = ServingMetrics()
    calls = []
    real = LatencyTracker.quantiles
    m.latency.quantiles = lambda qs: (calls.append(tuple(qs)) or
                                      real(m.latency, qs))

    m.publish()                       # nothing recorded yet: no pass
    assert calls == []
    m.latency.record(0.010)
    m.publish()
    assert calls == [(0.50, 0.99)]    # one pass for both quantiles
    snap = m.snapshot()
    assert snap["latency_p50_ms"] == pytest.approx(10.0, abs=0.1)

    m.publish()                       # no new samples: skipped
    m.publish()
    assert len(calls) == 1

    m.latency.record(0.030)
    m.publish()                       # new sample: recomputed
    assert len(calls) == 2


# -- kernel loading and launch counting under threads -------------------------

def test_concurrent_first_load_library_builds_once(monkeypatch, tmp_path):
    """Four threads reaching a kernel library for the first time at once
    (the serve thread and a deploy thread warming the next generation)
    run ONE build and share one loaded library.  The build is a stand-in
    (a one-function C library from the host compiler in place of nvcc),
    committed into the library cache at ``BUILD_DIR`` and loaded through
    ``ctypes`` as the real ones are."""
    import subprocess
    import sys

    from flink_ml_tpu_torch.kernels import build

    stub = tmp_path / "stub.c"
    stub.write_text("int stub_answer(void) { return 42; }\n")
    builds = []

    def stand_in(name, out_dir):
        builds.append((name,))
        threading.Event().wait(0.05)    # a build that takes a while
        return subprocess.Popen(
            ["cc", "-shared", "-fPIC", "-o",
             os.path.join(out_dir, f"lib{name}.so"), str(stub)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(build, "_start_nvcc", stand_in)
    gate = threading.Barrier(4, timeout=JOIN_S)
    got = []

    def first_use():
        gate.wait()
        got.append(build.load_library("kmeans"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_use) for _ in range(4)]
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        sys.setswitchinterval(old)
    assert builds == [("kmeans",)]
    assert len(got) == 4 and all(lib is got[0] for lib in got)
    assert got[0].stub_answer() == 42


def test_launch_counts_are_not_lost_under_threads(monkeypatch):
    """``count_launch`` from 8 threads at once: no increment is lost."""
    import sys

    from flink_ml_tpu_torch.kernels.build import count_launch

    counts = {"k": 0}
    per_thread = 2000

    def launch():
        for _ in range(per_thread):
            count_launch(counts, "k")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(8)]
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        sys.setswitchinterval(old)
    assert counts["k"] == 8 * per_thread
