"""The port's multi-tenant scheduler and embedding-row cache, case by case
after ``tests/test_scheduler.py``, on the CPU: WFQ shares and idle
re-entry, the shed order (property-tested at the boundary), admit-fraction
validation, health degrade and heal, interactive before bulk,
cross-tenant coalescing, same-schema admission without a plan build or a
library load, the row cache (exact under churn, LRU order, bypass,
validation, cached Wide&Deep bit-exact with offline transform, a fresh
cache on rebind, non-Wide&Deep refused), both lock-free shed paths,
generation-stamped sheds, tenant spans, the default tree's scheduler
subtree, the ``add_tenant`` lifecycle, dispatch failures, chip-down
requeues, and the real serve thread under concurrent clients.  The
queue-mechanics cases also run the JAX package's scheduler on the same
submits and require the same batches.  The JAX file's delta-publish
isolation test is in ``tests/test_torch_continuous.py``.

Every blocking wait has a timeout; every scheduler closes in a
``finally``."""

import threading

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu import serving as JS
from flink_ml_tpu_torch.serving import (
    SLO_BULK,
    SLO_CLASSES,
    SLO_INTERACTIVE,
    SLO_STANDARD,
    EmbeddingRowCache,
    MicroBatcher,
    ModelRegistry,
    ServingEndpoint,
    ServingOverloadedError,
    SharedScheduler,
    make_servable,
)
from flink_ml_tpu_torch.serving.metrics import HEALTH_DEGRADED, HEALTH_SERVING

JOIN_S = 30


# -- fixtures ----------------------------------------------------------------

def _lr_table(n=64, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.int64)
    return T.Table({"features": X, "label": y})


def _fit_lr(seed=0):
    return (T.LogisticRegression(device="cpu").set_max_iter(3)
            .fit(_lr_table(seed=seed)))


class _StubServable:
    """Queue-mechanics stub: echoes its input, always ready — the WFQ and
    shed tests exercise pure admission + placement without model fits."""

    ready = True
    warmup_report = None

    def __init__(self, model, example, **kwargs):
        self.model = model
        self.example = example
        self.max_batch_rows = kwargs.get("max_batch_rows", 256)
        self.min_bucket = kwargs.get("min_bucket", 8)
        self.output_cols = None

    def warm_up(self):
        return self

    def check_schema(self, table):
        pass

    def bucket_for(self, rows):
        return max(8, rows)

    def predict(self, table):
        return table


def _stub_scheduler(pkg=None, **kwargs):
    if pkg is JS:
        return JS.SharedScheduler(
            JS.ModelRegistry(servable_factory=_StubServable), **kwargs)
    return SharedScheduler(ModelRegistry(servable_factory=_StubServable),
                           **kwargs)


def _feats(n=256, seed=1):
    return _lr_table(n=n, seed=seed).drop("label")


def _drain(scheduler, max_batches=10_000):
    """Run the scheduler's pick->dispatch loop inline (no thread) until
    the queue is empty; returns the batches formed as (servable, tenant
    names, rows)."""
    formed_log = []
    for _ in range(max_batches):
        formed = scheduler._next_batch(timeout=0.0)
        if formed is None:
            return formed_log
        serve_name, picked = formed
        formed_log.append((serve_name, tuple(t.name for t, _ in picked),
                           sum(r.rows for _, r in picked)))
        scheduler._dispatch(*formed)
    raise AssertionError("queue did not drain")


# -- WFQ fairness ------------------------------------------------------------

def test_wfq_weighted_shares_within_class():
    """Backlogged same-class tenants share served rows in proportion to
    their weights: a prefix of the saturated queues shows the 3:1:1 split
    within one batch."""
    s = _stub_scheduler(max_batch_rows=4, max_wait_ms=0.0,
                        queue_capacity=4096)
    feats = _feats()
    for name, weight in (("heavy", 3.0), ("light1", 1.0),
                         ("light2", 1.0)):
        s.add_tenant(name, object(), feats.take(2), slo=SLO_STANDARD,
                     weight=weight)
        for _ in range(60):
            s.submit(name, feats.take(4))
    for _ in range(30):                 # a strict prefix: queues stay hot
        formed = s._next_batch(timeout=0.0)
        assert formed is not None
        s._dispatch(*formed)
    served = {name: s.tenant(name).rows_served
              for name in ("heavy", "light1", "light2")}
    total = sum(served.values())
    assert total == 30 * 4
    assert abs(served["heavy"] - total * 3 / 5) <= 4
    assert abs(served["light1"] - total / 5) <= 4
    assert abs(served["light2"] - total / 5) <= 4
    _drain(s)


def test_wfq_idle_tenant_reenters_at_class_virtual_time():
    s = _stub_scheduler(max_batch_rows=4, max_wait_ms=0.0,
                        queue_capacity=4096)
    feats = _feats()
    s.add_tenant("busy", object(), feats.take(2), slo=SLO_STANDARD)
    s.add_tenant("idle", object(), feats.take(2), slo=SLO_STANDARD)
    for _ in range(20):
        s.submit("busy", feats.take(4))
    _drain(s)
    vclass = s._vclass[SLO_STANDARD]
    assert vclass > 0.0
    s.submit("idle", feats.take(4))
    assert s.tenant("idle").vft >= vclass
    _drain(s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_formation_equals_jax_scheduler(seed):
    """The same tenants and the same seeded submits through both
    packages' schedulers form the same batches in the same order (WFQ
    tags, class priority, coalescing caps) and shed the same requests."""
    rng = np.random.default_rng(seed)
    tenants = [("t%d" % i, SLO_CLASSES[i % 3], float(1 + i % 4))
               for i in range(6)]
    ops = [(int(rng.integers(0, 6)), int(rng.integers(1, 9)))
           for _ in range(300)]
    logs = []
    for pkg, Table in ((None, T.Table), (JS, J.Table)):
        s = _stub_scheduler(pkg, max_batch_rows=16, max_wait_ms=0.0,
                            queue_capacity=64)
        x = np.zeros((8, 2))
        for name, slo, weight in tenants:
            s.add_tenant(name, object(), Table({"x": x[:1]}), slo=slo,
                         weight=weight)
        log = []
        for i, (t, rows) in enumerate(ops):
            try:
                s.submit(tenants[t][0], Table({"x": x[:rows]}))
            except (ServingOverloadedError, JS.ServingOverloadedError):
                log.append(("shed", i))
            if i % 7 == 6:
                formed = s._next_batch(timeout=0.0)
                if formed is not None:
                    log.append((formed[0], tuple(
                        t.name for t, _ in formed[1])))
                    s._dispatch(*formed)
        log += _drain(s)
        logs.append((log, s.shed_counts(),
                     {n: s.tenant(n).rows_served for n, _, _ in tenants}))
    assert logs[0] == logs[1]


# -- shed order (priority shedding) ------------------------------------------

def test_shed_order_bulk_before_standard_before_interactive():
    s = _stub_scheduler(queue_capacity=10)   # limits: bulk 5, std 8, int 10
    feats = _feats()
    for name, slo in (("i", SLO_INTERACTIVE), ("s", SLO_STANDARD),
                      ("b", SLO_BULK)):
        s.add_tenant(name, object(), feats.take(2), slo=slo)
    assert s.admit_limits == {SLO_INTERACTIVE: 10, SLO_STANDARD: 8,
                              SLO_BULK: 5}
    for _ in range(5):
        s.submit("i", feats.take(1))
    with pytest.raises(ServingOverloadedError, match="bulk"):
        s.submit("b", feats.take(1))
    for _ in range(3):
        s.submit("s", feats.take(1))
    with pytest.raises(ServingOverloadedError, match="standard"):
        s.submit("s", feats.take(1))
    for _ in range(2):
        s.submit("i", feats.take(1))
    with pytest.raises(ServingOverloadedError, match="interactive"):
        s.submit("i", feats.take(1))
    assert s.shed_counts() == {SLO_INTERACTIVE: 1, SLO_STANDARD: 1,
                               SLO_BULK: 1}
    _drain(s)


def test_shed_order_property_at_the_boundary():
    """Seeded random interleavings: a shed of a class happens only at or
    above its threshold, an interactive shed only at a FULL queue, and
    never before a bulk shed."""
    rng = np.random.default_rng(14)
    feats = _feats()
    for _ in range(8):
        s = _stub_scheduler(queue_capacity=int(rng.integers(4, 16)))
        for slo in SLO_CLASSES:
            s.add_tenant(slo, object(), feats.take(2), slo=slo)
        shed_events = []
        for _ in range(200):
            slo = SLO_CLASSES[int(rng.integers(0, 3))]
            depth_before = s._depth
            if rng.random() < 0.25 and s._depth:
                formed = s._next_batch(timeout=0.0)
                if formed is not None:
                    s._dispatch(*formed)
                continue
            try:
                s.submit(slo, feats.take(1))
            except ServingOverloadedError:
                shed_events.append(slo)
                assert depth_before >= s.admit_limits[slo]
                if slo == SLO_INTERACTIVE:
                    assert depth_before >= s.queue_capacity
                    assert SLO_BULK in shed_events
        _drain(s)


def test_shed_order_hypothesis_boundary():
    """The same property over hypothesis-drawn capacities and fractions:
    the per-class limits never invert the shed order."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=60, deadline=None, database=None)
    @hypothesis.given(cap=st.integers(1, 64),
                      std=st.floats(0.05, 1.0), bulk=st.floats(0.05, 1.0),
                      fill=st.integers(0, 70))
    def check(cap, std, bulk, fill):
        std, bulk = max(std, bulk), min(std, bulk)
        s = _stub_scheduler(queue_capacity=cap,
                            admit_fractions={SLO_STANDARD: std,
                                             SLO_BULK: bulk})
        feats = _feats(n=8)
        for slo in SLO_CLASSES:
            s.add_tenant(slo, object(), feats.take(1), slo=slo)
        lim = s.admit_limits
        assert lim[SLO_BULK] <= lim[SLO_STANDARD] <= lim[SLO_INTERACTIVE]
        for _ in range(min(fill, cap)):
            s.submit(SLO_INTERACTIVE, feats.take(1))
        for slo in SLO_CLASSES:
            admitted = s._depth < lim[slo]
            try:
                s.submit(slo, feats.take(1))
                assert admitted
            except ServingOverloadedError:
                assert not admitted
        _drain(s)

    check()


def test_admit_fractions_must_respect_priority_order():
    with pytest.raises(ValueError, match="non-increasing"):
        _stub_scheduler(queue_capacity=10,
                        admit_fractions={SLO_INTERACTIVE: 1.0,
                                         SLO_STANDARD: 0.5,
                                         SLO_BULK: 0.9})
    with pytest.raises(ValueError, match="admit fraction"):
        _stub_scheduler(queue_capacity=10,
                        admit_fractions={SLO_INTERACTIVE: 1.0,
                                         SLO_STANDARD: 0.5,
                                         SLO_BULK: 0.0})


def test_scheduler_health_degrades_on_shed_and_heals_after_drain():
    s = _stub_scheduler(queue_capacity=4)    # bulk limit: 2
    feats = _feats()
    s.add_tenant("b", object(), feats.take(2), slo=SLO_BULK)
    assert s.health == HEALTH_SERVING
    for _ in range(2):
        s.submit("b", feats.take(1))
    with pytest.raises(ServingOverloadedError):
        s.submit("b", feats.take(1))
    assert s.health == HEALTH_DEGRADED
    _drain(s)
    assert s.health == HEALTH_SERVING


# -- dispatch priority + coalescing ------------------------------------------

def test_interactive_dispatches_before_bulk_backlog():
    s = _stub_scheduler(max_batch_rows=8, max_wait_ms=0.0,
                        queue_capacity=4096)
    feats = _feats()
    s.add_tenant("inter", object(), feats.take(2), slo=SLO_INTERACTIVE)
    s.add_tenant("bulk", object(), feats.take(2), slo=SLO_BULK)
    for _ in range(20):
        s.submit("bulk", feats.take(8))
    s.submit("inter", feats.take(1))
    serve_name, picked = s._next_batch(timeout=0.0)
    assert serve_name == "inter"
    assert [t.name for t, _ in picked] == ["inter"]
    s._dispatch(serve_name, picked)
    _drain(s)


def test_cross_tenant_coalescing_on_shared_servable():
    model = _fit_lr()
    feats = _feats(seed=3)
    s = SharedScheduler(ModelRegistry(device="cpu"), max_batch_rows=64,
                        max_wait_ms=5.0, queue_capacity=1024)
    s.add_tenant("owner", model, feats.take(2), slo=SLO_STANDARD)
    s.add_tenant("guest", servable_of="owner", slo=SLO_STANDARD)
    reqs = [("owner", feats.slice(0, 3)), ("guest", feats.slice(3, 8)),
            ("owner", feats.slice(8, 9))]
    futures = [(name, req, s.submit(name, req)) for name, req in reqs]
    serve_name, picked = s._next_batch(timeout=0.0)
    assert serve_name == "owner"
    assert {t.name for t, _ in picked} == {"owner", "guest"}
    assert len(picked) == 3                  # ONE batch for all three
    s._dispatch(serve_name, picked)
    for name, req, future in futures:
        out = future.result(JOIN_S)
        np.testing.assert_array_equal(
            out["rawPrediction"], model.transform(req)[0]["rawPrediction"])
    assert s.tenant("guest").admission_report is None
    assert s.tenant("guest").rows_served == 5


# -- admission adds no build -------------------------------------------------

def test_second_tenant_of_served_schema_builds_nothing_new(monkeypatch):
    """Tenant N+1 of an already-served schema: its admission loads no
    kernel library, runs no new ``(plan, shapes)`` key (every warm-up
    bucket a ``cache`` hit, the JAX package's meaning), builds only its
    own kernel (one ``transform_kernel`` call, its bind) and its answers
    equal its model's transform."""
    from flink_ml_tpu_torch.kernels import build

    feats = _feats(seed=7)
    s = SharedScheduler(ModelRegistry(device="cpu"), max_batch_rows=64,
                        max_wait_ms=0.5, queue_capacity=1024)
    s.add_tenant("t1", _fit_lr(seed=1), feats.take(2), slo=SLO_INTERACTIVE)
    s.start()
    try:
        for n in (1, 2, 64):
            s.predict("t1", feats.take(n), timeout=JOIN_S)
        model2 = _fit_lr(seed=2)
        ref2 = model2.transform(feats.take(5))[0]["rawPrediction"]
        plans = []
        real_kernel = type(model2).transform_kernel
        monkeypatch.setattr(type(model2), "transform_kernel",
                            lambda self, schema: plans.append(self)
                            or real_kernel(self, schema))

        def no_load(name):
            raise AssertionError(f"library {name} loaded at admission")

        monkeypatch.setattr(build, "load_library", no_load)
        tenant = s.add_tenant("t2", model2, feats.take(2), slo=SLO_BULK)
        out = s.predict("t2", feats.take(5), timeout=JOIN_S)
        assert plans == [model2]
        report = tenant.admission_report
        assert report is not None and report["compiled"] == 0
        assert [b["source"] for b in report["buckets"].values()] == \
            ["cache"] * len(report["buckets"])
        assert report["cache_hits"] == len(report["buckets"])
        np.testing.assert_array_equal(out["rawPrediction"], ref2)
    finally:
        s.close()


# -- embedding-row cache -----------------------------------------------------

def _widedeep(seed=6, vocab=(50, 30), n=128):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 4)).astype(np.float32)
    cat = np.stack([rng.integers(0, v, size=n) for v in vocab],
                   axis=1).astype(np.int32)
    label = (cat[:, 0] > vocab[0] // 2).astype(np.int64)
    t = T.Table({"denseFeatures": dense, "catFeatures": cat, "label": label})
    return (T.WideDeep(device="cpu").set_vocab_sizes(list(vocab))
            .set_max_iter(2).fit(t)), t


def test_embcache_exact_under_eviction_churn():
    rng = np.random.default_rng(2)
    V, E = 80, 6
    emb = rng.normal(size=(V, E)).astype(np.float32)
    wc = rng.normal(size=(V,)).astype(np.float32)
    cache = EmbeddingRowCache({"emb": emb, "wide_cat": wc},
                              block_rows=8, capacity_blocks=4, device="cpu")
    jcache = JS.EmbeddingRowCache({"emb": emb, "wide_cat": wc},
                                  block_rows=8, capacity_blocks=4)
    for _ in range(100):
        ids = rng.integers(0, V, size=(int(rng.integers(1, 9)), 2))
        out = cache.lookup(ids)
        jcache.lookup(ids)
        np.testing.assert_array_equal(out["emb"].numpy(), emb[ids])
        np.testing.assert_array_equal(out["wide_cat"].numpy(), wc[ids])
    snap = cache.snapshot()
    assert snap["hits"] > 0 and snap["misses"] > 0
    assert snap["resident_blocks"] <= snap["capacity_blocks"] == 4
    assert snap["evictions"] > 0
    # the same LRU decisions as the JAX package's cache
    jsnap = jcache.snapshot()
    for key in ("hits", "misses", "block_faults", "evictions", "lookups",
                "bypasses", "resident_blocks", "pool_bytes"):
        assert snap[key] == jsnap[key], key
    assert cache._slot_of == jcache._slot_of


def test_embcache_lru_evicts_least_recently_touched():
    V, E = 32, 2
    emb = np.arange(V * E, dtype=np.float32).reshape(V, E)
    cache = EmbeddingRowCache({"emb": emb}, block_rows=8,
                              capacity_blocks=2, device="cpu")
    cache.lookup(np.array([0]))        # block 0
    cache.lookup(np.array([8]))        # block 1
    cache.lookup(np.array([1]))        # touch block 0 -> block 1 is LRU
    cache.lookup(np.array([16]))       # block 2 evicts block 1
    assert set(cache._slot_of) == {0, 2}
    assert cache.evictions == 1
    out = cache.lookup(np.array([9]))  # block 1 re-faults, still exact
    np.testing.assert_array_equal(out["emb"].numpy(), emb[[9]])
    assert cache.block_faults == 4


def test_embcache_bypasses_batches_larger_than_the_cache():
    V, E = 64, 3
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(V, E)).astype(np.float32)
    cache = EmbeddingRowCache({"emb": emb}, block_rows=8,
                              capacity_blocks=2, device="cpu")
    cache.lookup(np.array([0, 8]))     # two resident blocks
    resident = dict(cache._slot_of)
    ids = np.array([0, 8, 16, 24, 32])  # 5 unique blocks > capacity 2
    out = cache.lookup(ids)
    np.testing.assert_array_equal(out["emb"].numpy(), emb[ids])
    assert cache.bypasses == 1
    assert cache._slot_of == resident   # resident set untouched


def test_embcache_validation():
    with pytest.raises(ValueError, match="vocab dim"):
        EmbeddingRowCache({"a": np.zeros((4, 2)), "b": np.zeros((5,))},
                          device="cpu")
    with pytest.raises(ValueError, match="block_rows"):
        EmbeddingRowCache({"a": np.zeros((4, 2))}, block_rows=0,
                          device="cpu")
    with pytest.raises(ValueError, match="capacity_blocks"):
        EmbeddingRowCache({"a": np.zeros((4, 2))}, capacity_blocks=0,
                          device="cpu")
    with pytest.raises(ValueError, match="precision"):
        EmbeddingRowCache({"a": np.zeros((4, 2))}, precision="fp8",
                          device="cpu")
    cache = EmbeddingRowCache({"a": np.arange(10.0)}, block_rows=4,
                              capacity_blocks=99, device="cpu")
    assert cache.capacity_blocks == cache.n_blocks == 3   # capped
    with pytest.raises(ValueError, match="out of range"):
        cache.lookup(np.array([10]))
    with pytest.raises(ValueError, match="out of range"):
        cache.lookup(np.array([-1]))


def test_cached_widedeep_bitexact_with_offline_transform():
    model, t = _widedeep()
    feats = t.drop("label")
    servable = make_servable(model, feats.take(2), emb_cache=True,
                             cache_block_rows=8, cache_capacity_blocks=6,
                             max_batch_rows=64)
    servable.warm_up()
    uncached = make_servable(model, feats.take(2),
                             max_batch_rows=64).warm_up()
    for sz in (1, 7, 10, 33, 64):
        req = feats.slice(0, sz)
        served = servable.predict(req)
        offline = model.transform(req)[0]
        for col in ("rawPrediction", "prediction"):
            np.testing.assert_array_equal(served[col], offline[col])
            np.testing.assert_array_equal(uncached.predict(req)[col],
                                          offline[col])
    snap = servable.cache.snapshot()
    assert snap["hits"] > 0 and snap["lookups"] > 0


def test_cached_widedeep_rebind_gets_fresh_cache():
    model, t = _widedeep(seed=8)
    feats = t.drop("label")
    servable = make_servable(model, feats.take(2), emb_cache=True,
                             cache_block_rows=8, cache_capacity_blocks=8,
                             max_batch_rows=64)
    servable.warm_up()
    servable.predict(feats.take(10))    # populate the old cache

    new_model = T.WideDeepModel(device="cpu")
    new_model._params = {
        **{k: model._params[k] for k in ("wide_dense", "wide_b", "mlp")},
        "emb": np.asarray(model._params["emb"]) * 2.0 + 1.0,
        "wide_cat": np.asarray(model._params["wide_cat"]) - 3.0,
    }
    new_model._vocab_sizes = model._vocab_sizes
    clone = servable.rebind(new_model)
    assert clone.ready and clone.cache is not servable.cache
    req = feats.take(10)
    np.testing.assert_array_equal(
        clone.predict(req)["rawPrediction"],
        new_model.transform(req)[0]["rawPrediction"])
    np.testing.assert_array_equal(
        servable.predict(req)["rawPrediction"],
        model.transform(req)[0]["rawPrediction"])


def test_embcache_rejects_non_widedeep():
    with pytest.raises(TypeError, match="WideDeepModel"):
        make_servable(_fit_lr(), _feats().take(1), emb_cache=True)


def test_cached_widedeep_matches_jax_cached_servable():
    """The port's cached servable and the JAX package's, on the same
    Wide&Deep parameters and requests: predictions equal, scores within
    the transform tolerance (rtol 1e-5), the same cache ledger."""
    from flink_ml_tpu.models.recommendation.widedeep import WideDeepModel

    model, t = _widedeep(seed=10)
    jmodel = WideDeepModel()
    jmodel._params = model._params
    jmodel._vocab_sizes = model._vocab_sizes
    feats = t.drop("label")
    cols = {n: np.asarray(feats[n]) for n in feats.column_names}
    kw = dict(emb_cache=True, cache_block_rows=8, cache_capacity_blocks=6,
              max_batch_rows=64)
    sv = make_servable(model, feats.take(2), **kw).warm_up()
    jsv = JS.make_servable(jmodel, J.Table(cols).take(2), **kw).warm_up()
    for lo, hi in ((0, 5), (5, 37), (37, 101)):
        out = sv.predict(feats.slice(lo, hi))
        jout = jsv.predict(J.Table(cols).slice(lo, hi))
        np.testing.assert_array_equal(out["prediction"],
                                      np.asarray(jout["prediction"]))
        np.testing.assert_allclose(out["rawPrediction"],
                                   jout["rawPrediction"], rtol=1e-5)
    for key in ("hits", "misses", "evictions", "bypasses"):
        assert sv.cache.snapshot()[key] == jsv.cache.snapshot()[key]


# -- satellites: batcher fast path + shed generation stamping ----------------

class _PoisonedLock:
    """Context manager that fails the test if the fast path touches the
    queue lock."""

    def __enter__(self):
        raise AssertionError("queue lock acquired on the shed fast path")

    def __exit__(self, *exc):
        return False


def test_microbatcher_fast_shed_never_touches_the_lock():
    batcher = MicroBatcher(max_batch_rows=8, queue_capacity=2)
    t = _feats()
    for _ in range(2):
        batcher.submit(t.take(1))
    batcher._cond = _PoisonedLock()             # saturation reached
    with pytest.raises(ServingOverloadedError, match="queue full"):
        batcher.submit(t.take(1))               # lock-free shed
    batcher.fast_shed = False                   # the locked path
    with pytest.raises(AssertionError, match="fast path"):
        batcher.submit(t.take(1))


def test_scheduler_fast_shed_never_touches_the_lock():
    s = _stub_scheduler(queue_capacity=4)
    feats = _feats()
    s.add_tenant("b", object(), feats.take(2), slo=SLO_BULK)
    for _ in range(2):                          # bulk limit = 2
        s.submit("b", feats.take(1))
    s._cond = _PoisonedLock()
    with pytest.raises(ServingOverloadedError, match="shed"):
        s.submit("b", feats.take(1))


def test_endpoint_shed_stamps_live_generation():
    from flink_ml_tpu_torch.obs.trace import tracer

    model = _fit_lr()
    feats = _feats(seed=8)
    registry = ModelRegistry(device="cpu")
    registry.deploy("m", model, feats.take(1), max_batch_rows=32)
    endpoint = ServingEndpoint(registry, "m", max_batch_rows=32,
                               queue_capacity=1)
    try:
        endpoint.submit(feats.take(1))
        tracer.enable()
        try:
            with pytest.raises(ServingOverloadedError):
                endpoint.submit(feats.take(1))
        finally:
            tracer.disable()
        snap = endpoint.metrics.group.snapshot()
        assert snap["last_shed_generation"] == 1
        sheds = list(tracer.find("shed"))
        assert sheds and sheds[0].ids["generation"] == 1
        tracer.clear()
        endpoint.start()
    finally:
        endpoint.close()


# -- observability wiring ----------------------------------------------------

def test_scheduler_spans_carry_tenant_correlation_key():
    from flink_ml_tpu_torch.obs.trace import CORRELATION_KEYS, tracer

    assert "tenant" in CORRELATION_KEYS
    s = _stub_scheduler(max_batch_rows=8, max_wait_ms=0.0,
                        queue_capacity=64)
    feats = _feats()
    s.add_tenant("acme", object(), feats.take(2), slo=SLO_INTERACTIVE)
    tracer.enable()
    try:
        future = s.submit("acme", feats.take(2))
        formed = s._next_batch(timeout=0.0)
        s._dispatch(*formed)
        future.result(JOIN_S)
        spans = {sp.name: sp for sp in tracer.spans()}
        assert spans["request"].ids["tenant"] == "acme"
        assert spans["queue_wait"].ids["tenant"] == "acme"
        assert spans["serve_batch"].ids["tenant"] == "acme"
    finally:
        tracer.disable()
        tracer.clear()


def test_default_tree_registers_scheduler_subtree():
    from flink_ml_tpu_torch.obs.tree import default_tree, prometheus_text

    s = _stub_scheduler(queue_capacity=16)
    feats = _feats()
    s.add_tenant("t0", object(), feats.take(2), slo=SLO_INTERACTIVE)
    s.submit("t0", feats.take(1))
    _drain(s)
    snap = default_tree(scheduler=s).snapshot()
    assert snap["scheduler"]["batches"] == 1
    assert snap["scheduler"]["tenants.t0.requests"] == 1
    assert "dispatches" in snap["kernels"]
    text = prometheus_text(snap)
    assert "flink_ml_tpu_scheduler_tenants_t0_requests 1" in text


def test_add_tenant_validation_and_lifecycle():
    s = _stub_scheduler(queue_capacity=16)
    feats = _feats()
    s.add_tenant("a", object(), feats.take(2))
    with pytest.raises(ValueError, match="already admitted"):
        s.add_tenant("a", object(), feats.take(2))
    with pytest.raises(ValueError, match="SLO class"):
        s.add_tenant("x", object(), feats.take(2), slo="gold")
    with pytest.raises(ValueError, match="weight"):
        s.add_tenant("x", object(), feats.take(2), weight=0.0)
    with pytest.raises(ValueError, match="servable_of"):
        s.add_tenant("x", object(), servable_of="a")
    with pytest.raises(KeyError, match="not an admitted tenant"):
        s.add_tenant("x", servable_of="ghost")
    with pytest.raises(ValueError, match="needs a model"):
        s.add_tenant("x")
    with pytest.raises(KeyError, match="unknown tenant"):
        s.submit("ghost", feats.take(1))
    with pytest.raises(ValueError, match="empty"):
        s.submit("a", feats.take(0))
    with pytest.raises(ValueError, match="split it client-side"):
        s.submit("a", feats.take(16).concat(
            _feats(n=512, seed=5).take(241)))
    pub = s.delta_publisher("a")
    assert pub._name == "a" and pub._registry is s.registry
    assert pub._metrics is s.tenant("a").metrics
    with pytest.raises(KeyError, match="unknown tenant"):
        s.delta_publisher("ghost")
    s.start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            s.start()
    finally:
        s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.submit("a", feats.take(1))


def test_dispatch_failure_fails_futures_and_loop_survives():
    s = _stub_scheduler(queue_capacity=16, max_wait_ms=0.0)
    feats = _feats()
    s.add_tenant("a", object(), feats.take(2))
    s.add_tenant("b", object(), feats.take(2))
    s.start()
    try:
        s.registry.undeploy("a")
        future = s.submit("a", feats.take(1))
        with pytest.raises(KeyError, match="no model deployed"):
            future.result(JOIN_S)
        out = s.predict("b", feats.take(2), timeout=JOIN_S)
        assert out.num_rows == 2
    finally:
        s.close()


def test_chip_down_at_dispatch_requeues_losslessly():
    """A seeded ``chip_down``/``chip_flap`` schedule at the dispatch
    boundary: every request still answers bit-identically, nothing is
    dropped, and the requeue counters account the retried requests."""
    from flink_ml_tpu_torch.robustness import FaultPlan

    models = {"x": _fit_lr(seed=1), "y": _fit_lr(seed=2)}
    feats = _feats(seed=9)
    s = SharedScheduler(ModelRegistry(device="cpu"), max_batch_rows=32,
                        max_wait_ms=0.0, queue_capacity=1024)
    for name, model in models.items():
        s.add_tenant(name, model, feats.take(2), slo=SLO_STANDARD)
    plan = (FaultPlan(seed=5)
            .inject_random("serving.dispatch", rate=0.4, horizon=40,
                           kind="chip_down")
            .inject("serving.dispatch", at=1, kind="chip_flap"))
    reqs = [(("x", "y")[i % 2], feats.slice(i, i + 1 + i % 4))
            for i in range(24)]
    with plan:
        futures = [s.submit(name, req) for name, req in reqs]
        _drain(s)
    assert plan.fires
    for (name, req), fut in zip(reqs, futures):
        np.testing.assert_array_equal(
            fut.result(0)["rawPrediction"],
            models[name].transform(req)[0]["rawPrediction"])
    snap = s.snapshot()
    assert snap["requests"] == len(reqs)
    assert snap["requeued_requests"] >= len(plan.fires)


def test_scheduler_end_to_end_under_concurrent_clients():
    models = {name: _fit_lr(seed=i)
              for i, name in enumerate(("red", "green", "blue"))}
    feats = _feats(seed=4)
    refs = {name: m.transform(feats)[0]["rawPrediction"]
            for name, m in models.items()}
    s = SharedScheduler(ModelRegistry(device="cpu"), max_batch_rows=64,
                        max_wait_ms=1.0, queue_capacity=8192)
    for i, (name, model) in enumerate(models.items()):
        s.add_tenant(name, model, feats.take(2),
                     slo=SLO_CLASSES[i % 3], weight=1.0 + i)
    s.start()
    errors = []

    def client(name, worker):
        crng = np.random.default_rng(worker)
        try:
            for _ in range(25):
                start = int(crng.integers(0, 200))
                rows = int(crng.integers(1, 7))
                out = s.predict(name, feats.slice(start, start + rows),
                                timeout=JOIN_S)
                np.testing.assert_array_equal(
                    out["rawPrediction"], refs[name][start:start + rows])
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    try:
        threads = [threading.Thread(target=client, args=(name, 7 * i + 1))
                   for i, name in enumerate(models) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        snap = s.snapshot()
        assert snap["requests"] == 150
        assert s.shed_counts() == {slo: 0 for slo in SLO_CLASSES}
    finally:
        s.close()
