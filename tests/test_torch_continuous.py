"""The port's continuous learning (``flink_ml_tpu_torch.online``): the delta
codec, the publish protocol into live servables and index tenants, and
``ContinuousLearner`` over the write-ahead window log, case by case after
``tests/test_online.py`` and the train-while-serve cases of
``tests/test_faults.py``, ``tests/test_scheduler.py``,
``tests/test_retrieval.py`` and ``tests/test_obs.py``, on the CPU.

Tolerances:

- the codec against the JAX package's: tolerance 0 — the same keys, the
  same bytes, the same indices and CRCs for the same numpy trees, and a
  delta encoded by either package applies in the other bit for bit;
- the whole slice against the JAX package: both packages'
  ``ContinuousLearner`` on the same mixed windows publish at the same
  steps in the same modes, each generation's ``w`` and ``b`` within
  ``atol=1e-5`` (``tests/test_torch_outofcore.py``'s streamed-fit
  tolerance: f32 sums in another order);
- ``PublishingListener`` over an OnlineKMeans body: each published
  generation's centroids within ``rtol=1e-5, atol=1e-6`` of the JAX
  package's (``tests/test_torch_online.py``'s);
- inside the port, bit for bit: the generation served after the cut at
  step T equals the offline ``sgd_fit_outofcore`` over windows <= T, a
  crashed-and-resumed run ends on the uninterrupted run's bits, and every
  response equals the offline transform of exactly one published
  generation.

The JAX file's zero-lowering test becomes the port's analogue: publish +
serve cycles load no kernel library and ask the model for one kernel a
publish (the rebind's bind), none a request.  Every blocking wait and
thread join has a timeout; every endpoint and scheduler closes in a
``finally``."""

import json
import os
import threading

import numpy as np
import pytest
import torch

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu import online as JO
from flink_ml_tpu.models.common import sgd as JS
from flink_ml_tpu.models.common.losses import logistic_loss as j_logistic
from flink_ml_tpu.serving import serve_model as j_serve_model
from flink_ml_tpu_torch import online as TO
from flink_ml_tpu_torch.data.wal import WindowBatchReader, WindowLog
from flink_ml_tpu_torch.iteration import (CheckpointConfig,
                                          IterationBodyResult,
                                          IterationConfig, iterate)
from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES
from flink_ml_tpu_torch.obs import trace as trace_mod
from flink_ml_tpu_torch.online import (
    ContinuousLearner,
    DeltaBaseMismatch,
    DeltaCorrupt,
    DeltaEncoder,
    DeltaPublisher,
    DeltaShapeChanged,
    DeterminismViolation,
    ParamDelta,
    PublishingListener,
    PublishStats,
    StalenessPolicy,
    apply_delta,
    diff_params,
    encode_and_publish,
    flatten_params,
    params_of_model,
    tree_digest,
    unflatten_params,
)
from flink_ml_tpu_torch.robustness import (FaultPlan, InjectedCrash,
                                           RecoveryReport, RetryPolicy,
                                           corrupt_file)
from flink_ml_tpu_torch.serving import (SLO_INTERACTIVE, SLO_STANDARD,
                                        ModelRegistry, SharedScheduler,
                                        serve_model)

JOIN_S = 30
W_ATOL = 1e-5
C_TOL = dict(rtol=1e-5, atol=1e-6)


# -- fixtures ----------------------------------------------------------------

def _lr_table(n=64, d=8, seed=0, pkg=T):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.int64)
    return pkg.Table({"features": X, "label": y})


def _fit_lr(table, iters=3):
    return T.LogisticRegression(device="cpu").set_max_iter(iters).fit(table)


def _lr_endpoint(model=None, d=8, **kw):
    model = model or _fit_lr(_lr_table(d=d))
    kw.setdefault("max_batch_rows", 32)
    kw.setdefault("max_wait_ms", 0.5)
    return serve_model(model, _lr_table(seed=5, d=d).drop("label").take(2),
                       **kw)


def _lr_from_weights(w, b, pkg=T):
    if pkg is T:
        model = T.LogisticRegressionModel(device="cpu")
    else:
        from flink_ml_tpu.models import LogisticRegressionModel

        model = LogisticRegressionModel()
    return model.set_model_data(pkg.Table({
        "coefficients": np.asarray(w, np.float64)[None, :],
        "intercept": np.array([b], np.float64)}))


def _served_w(endpoint, name="default"):
    model = endpoint.registry.current(name).servable.model
    return np.asarray(model._state.coefficients, np.float32)


def _publish_chain(endpoint, steps):
    """Publish a chain of nudged params; returns the final params."""
    pub = endpoint.delta_publisher()
    enc = DeltaEncoder()
    p = params_of_model(endpoint.registry.current("default").servable.model)
    for step in steps:
        p = {"w": p["w"].copy(), "b": p["b"]}
        p["w"][step % p["w"].size] += np.float32(0.125)
        pub.apply(enc.encode(step, p, pub.stats))
        enc.ack()
    return pub, enc, p


def _windows(start, stop, rows=16, d=4, seed=1000, pkg=T):
    for i in range(start, stop):
        rng = np.random.default_rng(seed + i)
        X = rng.normal(size=(rows, d)).astype(np.float32)
        yield pkg.Table({"features": X,
                         "label": (X[:, 0] > 0).astype(np.float32)})


def _offline_fit(windows, upto, every):
    def make_reader():
        for w in windows[:upto]:
            yield w.to_dict()

    state, _ = TS.sgd_fit_outofcore(
        LOSSES["logistic"], make_reader, num_features=4,
        config=TS.SGDConfig(max_epochs=1, tol=0.0),
        steps_per_dispatch=every, device="cpu")
    return (np.asarray(state.coefficients, np.float32),
            np.float32(state.intercept))


def _learner(endpoint, source, tmp_path, **kw):
    kw.setdefault("publish_every_steps", 4)
    return ContinuousLearner(
        loss_fn=LOSSES["logistic"], num_features=kw.pop("num_features", 4),
        source=source, wal_dir=str(tmp_path / "wal"), endpoint=endpoint,
        batch_rows=kw.pop("batch_rows", 16),
        checkpoint=CheckpointConfig(str(tmp_path / "ck")), device="cpu",
        **kw)


class _SpyPublisher(DeltaPublisher):
    """Records the full published params at every landed publish."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.history = []

    def apply(self, update):
        result = super().apply(update)
        if result.mode != "noop":
            self.history.append(
                (result.step, result.mode,
                 {k: v.copy() for k, v in self._base.items()}))
        return result


# -- the delta codec (tests/test_online.py's cases) --------------------------

def test_delta_sparse_roundtrip_bitexact():
    base = {"w": np.arange(64, dtype=np.float32), "b": np.float32(0.5)}
    new = {"w": base["w"].copy(), "b": np.float32(0.5)}
    new["w"][3] = 7.5
    new["w"][41] = -2.0
    d = diff_params(base, new, step=5)
    assert d.changed_leaves == ["w"]
    assert d.leaves["w"].idx is not None          # sparse encode
    assert d.payload_bytes == 2 * (8 + 4)         # int64 idx + f32 val
    out = apply_delta(base, d)
    flat_new = flatten_params(new)
    assert all(out[k].tobytes() == flat_new[k].tobytes() for k in flat_new)


def test_delta_dense_leaf_ships_full_buffer():
    base = {"w": np.zeros(32, np.float32)}
    new = {"w": np.ones(32, np.float32)}           # 100% changed
    d = diff_params(base, new)
    assert d.leaves["w"].idx is None
    assert d.payload_bytes == 32 * 4
    out = apply_delta(base, d)
    assert out["w"].tobytes() == new["w"].tobytes()


def test_delta_bitexact_nan_and_signed_zero():
    base = {"w": np.array([0.0, 1.0, np.nan, 3.0], np.float32)}
    new = {"w": np.array([-0.0, 1.0, np.nan, 3.0], np.float32)}
    d = diff_params(base, new)
    assert d.leaves["w"].idx.tolist() == [0]      # only the zero flip
    out = apply_delta(base, d)
    assert out["w"].tobytes() == new["w"].tobytes()
    d2 = diff_params(new, {"w": new["w"].copy()})
    assert d2.changed_leaves == []


def test_delta_nested_tree_and_scalar_shapes():
    base = {"mlp": [{"w": np.ones((4, 2), np.float32),
                     "b": np.zeros(2, np.float32)}],
            "bias": np.float32(1.0)}
    new = {"mlp": [{"w": base["mlp"][0]["w"] * 2,
                    "b": base["mlp"][0]["b"]}],
           "bias": np.float32(2.0)}
    out = apply_delta(base, diff_params(base, new))
    assert out["bias"].shape == ()                # 0-d preserved
    assert out["mlp/0/w"].shape == (4, 2)
    tree = unflatten_params(base, out)
    assert isinstance(tree["mlp"], list)
    assert np.asarray(tree["mlp"][0]["w"]).tobytes() \
        == new["mlp"][0]["w"].tobytes()


def test_delta_base_mismatch_and_corrupt_detected():
    base = {"w": np.zeros(8, np.float32)}
    new = {"w": np.ones(8, np.float32)}
    d = diff_params(base, new)
    with pytest.raises(DeltaBaseMismatch):
        apply_delta({"w": np.full(8, 2.0, np.float32)}, d)
    torn = ParamDelta(step=d.step, base_digest=d.base_digest,
                      new_digest=d.new_digest ^ 1, leaves=d.leaves)
    with pytest.raises(DeltaCorrupt):
        apply_delta(base, torn)


def test_delta_shape_change_raises():
    base = {"w": np.zeros(8, np.float32)}
    with pytest.raises(DeltaShapeChanged):
        diff_params(base, {"w": np.zeros(9, np.float32)})
    with pytest.raises(DeltaShapeChanged):
        diff_params(base, {"w": np.zeros(8, np.float64)})
    with pytest.raises(DeltaShapeChanged):
        diff_params(base, {"v": np.zeros(8, np.float32)})
    with pytest.raises(DeltaShapeChanged):
        unflatten_params(base, {"w": base["w"], "x": base["w"]})


# -- the codec against the JAX package's -------------------------------------

def _wd_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"emb": rng.normal(size=(40, 8)).astype(np.float32),
            "wide_cat": rng.normal(size=40).astype(np.float32),
            "wide_dense": rng.normal(size=3).astype(np.float32),
            "wide_b": np.float32(0.25),
            "mlp": [{"w": rng.normal(size=(27, 16)).astype(np.float32),
                     "b": np.zeros(16, np.float32)},
                    {"w": rng.normal(size=(16, 1)).astype(np.float32),
                     "b": np.zeros(1, np.float32)}]}


def _ivf_params(seed=0):
    rng = np.random.default_rng(seed)
    ids = np.full((4, 8), -1, np.int32)
    ids[:, :5] = np.arange(20, dtype=np.int32).reshape(4, 5)
    return {"centroids": rng.normal(size=(4, 6)).astype(np.float32),
            "ids": ids, "counts": np.full(4, 5, np.int32),
            "vecs": rng.normal(size=(32, 6)).astype(np.float32)}


FAMILY_TREES = {
    "lr": lambda: {"w": np.linspace(-1, 1, 33, dtype=np.float32),
                   "b": np.asarray(-0.5, np.float32)},
    "kmeans": lambda: {"centroids": np.random.default_rng(3).normal(
        size=(16, 5)).astype(np.float32)},
    "widedeep": _wd_tree,
    "ivf": _ivf_params,
    "nested": lambda: {"a": (np.float32(1.0), [np.arange(3.0), None]),
                       "z": {"y": np.zeros((0, 2), np.float32),
                             "x": np.asarray(7)},
                       "n": None},
}


@pytest.mark.parametrize("family", sorted(FAMILY_TREES))
def test_flatten_and_digest_equal_the_jax_package(family):
    tree = FAMILY_TREES[family]()
    got, want = flatten_params(tree), JO.flatten_params(tree)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert got[key].shape == want[key].shape
        assert got[key].tobytes() == want[key].tobytes()
    assert tree_digest(tree) == JO.tree_digest(tree)
    assert tree_digest(got) == JO.tree_digest(want)
    # torch tensors are leaves through .detach().cpu().numpy()
    as_torch = unflatten_params(tree, {
        k: torch.from_numpy(np.array(v)) for k, v in got.items()})
    assert tree_digest(as_torch) == JO.tree_digest(tree)
    rebuilt = unflatten_params(tree, got)
    assert tree_digest(rebuilt) == tree_digest(tree)


def _pairs():
    wd, wd2 = _wd_tree(0), _wd_tree(0)
    wd2["emb"] = wd2["emb"].copy()
    wd2["emb"][[3, 17]] += 1.0                  # a sparse table delta
    wd2["mlp"][1]["w"] = wd2["mlp"][1]["w"] * 2  # a dense leaf
    wd2["wide_b"] = np.float32(-0.25)            # a 0-d leaf
    ivf, ivf2 = _ivf_params(), _ivf_params()
    ivf2["vecs"] = ivf2["vecs"].copy()
    ivf2["vecs"][5] = 9.0
    ivf2["ids"] = ivf2["ids"].copy()
    ivf2["ids"][1, 5] = 99
    return {
        "nan_and_signed_zero": (
            {"w": np.array([0.0, 1.0, np.nan, 3.0] * 4, np.float32)},
            {"w": np.array([-0.0, 1.0, np.nan, 3.0] * 4, np.float32)}),
        "nan_payload": (
            {"w": np.zeros(16, np.float32)},
            {"w": np.frombuffer(np.array([0x7fc00001] + [0] * 15,
                                         np.uint32).tobytes(),
                                np.float32).copy()}),
        "dense": ({"w": np.zeros(8, np.float32)},
                  {"w": np.ones(8, np.float32)}),
        "widedeep": (wd, wd2),
        "ivf": (ivf, ivf2),
        "same": (wd, _wd_tree(0)),
    }


@pytest.mark.parametrize("case", sorted(_pairs()))
def test_codec_equals_the_jax_package_in_both_directions(case):
    base, new = _pairs()[case]
    got = diff_params(base, new, step=7)
    want = JO.diff_params(base, new, step=7)
    assert (got.step, got.base_digest, got.new_digest) \
        == (want.step, want.base_digest, want.new_digest)
    assert got.changed_leaves == want.changed_leaves
    assert got.payload_bytes == want.payload_bytes
    for key in want.leaves:
        g, w = got.leaves[key], want.leaves[key]
        assert (g.idx is None) == (w.idx is None)
        if w.idx is not None:
            assert g.idx.dtype == w.idx.dtype
            assert g.idx.tobytes() == w.idx.tobytes()
        assert g.values.dtype == w.values.dtype
        assert g.values.tobytes() == w.values.tobytes()
    flat_new = JO.flatten_params(new)
    for applied in (apply_delta(base, want), JO.apply_delta(base, got)):
        assert sorted(applied) == sorted(flat_new)
        for key in flat_new:
            assert applied[key].tobytes() == flat_new[key].tobytes()
    full = TO.full_update(3, new)
    assert full.new_digest == JO.full_update(3, new).new_digest
    assert full.payload_bytes == JO.full_update(3, new).payload_bytes


def test_encoder_and_policy_decisions_equal_the_jax_package():
    """The same cuts through both packages' encoders and policies give the
    same update kinds and payloads."""
    rng = np.random.default_rng(8)
    p = {"w": rng.normal(size=256).astype(np.float32),
         "b": np.float32(0.0)}
    policy = dict(publish_every=1, full_every=3, full_ratio=0.5)
    enc, jenc = DeltaEncoder(StalenessPolicy(**policy)), \
        JO.DeltaEncoder(JO.StalenessPolicy(**policy))
    stats, jstats = PublishStats(), JO.PublishStats()
    for step in range(1, 9):
        p = {"w": p["w"].copy(), "b": p["b"]}
        touched = rng.integers(0, 256, size=4 if step % 4 else 200)
        p["w"][touched] += np.float32(0.5)
        got, want = enc.encode(step, p, stats), jenc.encode(step, p, jstats)
        assert type(got).__name__ == type(want).__name__
        assert got.new_digest == want.new_digest
        assert got.payload_bytes == want.payload_bytes
        enc.ack()
        jenc.ack()
        for st in (stats, jstats):
            st.publishes += 1


# -- the serving-side publish protocol ---------------------------------------

def test_publish_swaps_generation_and_serves_published_bits():
    endpoint = _lr_endpoint()
    feats = _lr_table(seed=5).drop("label")
    try:
        gen0 = endpoint.registry.current("default").generation
        pub, enc, p = _publish_chain(endpoint, [1, 2, 3])
        assert endpoint.registry.current("default").generation == gen0 + 3
        assert _served_w(endpoint).tobytes() == p["w"].tobytes()
        out = endpoint.predict(feats.take(4), timeout=JOIN_S)
        np.testing.assert_array_equal(
            out["rawPrediction"],
            _lr_from_weights(p["w"], p["b"]).transform(feats.take(4))[0][
                "rawPrediction"])
        assert pub.stats.deltas >= 1
        assert pub._name == "default"
    finally:
        endpoint.close()


def test_publish_builds_one_kernel_a_generation_and_loads_no_library(
        monkeypatch):
    """The port's analogue of the zero-lowering test: after warm-up, each
    publish builds the new generation's kernel once (the rebind's bind,
    on the publishing thread), each request runs one segment and asks for
    no kernel, and nothing loads a kernel library."""
    from flink_ml_tpu_torch.api import chain as TC
    from flink_ml_tpu_torch.kernels import build

    model = _fit_lr(_lr_table())
    feats = _lr_table(seed=5).drop("label")
    endpoint = _lr_endpoint(model, max_batch_rows=64)
    plans = []
    real_kernel = type(model).transform_kernel
    monkeypatch.setattr(type(model), "transform_kernel",
                        lambda self, schema: plans.append(schema)
                        or real_kernel(self, schema))

    def no_load(name):
        raise AssertionError(f"library {name} loaded in steady state")

    monkeypatch.setattr(build, "load_library", no_load)
    try:
        pub = endpoint.delta_publisher()
        enc = DeltaEncoder()
        p = params_of_model(model)
        pub.apply(enc.encode(1, p, pub.stats))
        enc.ack()
        for step in range(2, 12):
            p = {"w": p["w"] + np.float32(0.01), "b": p["b"]}
            pub.apply(enc.encode(step, p, pub.stats))
            enc.ack()
            before = TC.dispatch_count()
            endpoint.predict(feats.take(1 + step % 32), timeout=JOIN_S)
            assert TC.dispatch_count() == before + 1
        assert len(plans) == 11                 # one bind a publish
        assert endpoint.registry.current("default").generation >= 11
    finally:
        endpoint.close()


def test_publish_replay_is_idempotent_and_stale_steps_skip():
    endpoint = _lr_endpoint()
    try:
        pub, enc, p = _publish_chain(endpoint, [4, 8])
        gen = endpoint.registry.current("default").generation
        r = pub.apply(DeltaEncoder().encode(8, p, pub.stats))
        assert r.mode == "noop"
        assert endpoint.registry.current("default").generation == gen
        older = {"w": np.zeros_like(p["w"]), "b": p["b"]}
        r = pub.apply(DeltaEncoder().encode(4, older, pub.stats))
        assert r.mode == "noop"
        assert _served_w(endpoint).tobytes() == p["w"].tobytes()
    finally:
        endpoint.close()


def test_publish_replay_with_different_bits_is_determinism_violation():
    endpoint = _lr_endpoint()
    try:
        pub, enc, p = _publish_chain(endpoint, [4, 8])
        diverged = {"w": p["w"] + np.float32(1.0), "b": p["b"]}
        with pytest.raises(DeterminismViolation):
            pub.apply(DeltaEncoder().encode(8, diverged, pub.stats))
    finally:
        endpoint.close()


def test_stale_encoder_base_heals_with_full_reanchor():
    model = _fit_lr(_lr_table())
    endpoint = _lr_endpoint(model)
    try:
        pub = endpoint.delta_publisher()
        enc = DeltaEncoder()
        p0 = params_of_model(model)
        encode_and_publish(enc, pub, 1, p0)
        p1 = {"w": p0["w"] + np.float32(0.5), "b": p0["b"]}
        pub.apply(enc.encode(2, p1, pub.stats))    # landed, NOT acked
        p2 = {"w": p1["w"] + np.float32(0.5), "b": p1["b"]}
        enc._pending = None                        # simulate crashed ack
        r = encode_and_publish(enc, pub, 3, p2)
        assert r.mode == "full"
        assert _served_w(endpoint).tobytes() == p2["w"].tobytes()
    finally:
        endpoint.close()


def test_full_publish_with_changed_shape_refused_serving_unharmed():
    endpoint = _lr_endpoint()
    feats = _lr_table(seed=5).drop("label")
    try:
        pub = endpoint.delta_publisher()
        wrong = DeltaEncoder().encode(
            1, {"w": np.zeros(16, np.float32), "b": np.float32(0.0)},
            pub.stats)
        gen = endpoint.registry.current("default").generation
        with pytest.raises(DeltaShapeChanged, match="registry.deploy"):
            pub.apply(wrong)
        assert endpoint.registry.current("default").generation == gen
        assert endpoint.predict(feats.take(3), timeout=JOIN_S).num_rows == 3
    finally:
        endpoint.close()


def test_external_hot_swap_invalidates_publisher_base():
    model = _fit_lr(_lr_table())
    endpoint = _lr_endpoint(model)
    try:
        pub = endpoint.delta_publisher()
        enc = DeltaEncoder()
        p = params_of_model(model)
        encode_and_publish(enc, pub, 1, p)
        endpoint.hot_swap(_fit_lr(_lr_table(seed=9), iters=5))
        p2 = {"w": p["w"] + np.float32(0.25), "b": p["b"]}
        r = encode_and_publish(enc, pub, 2, p2)
        assert r.mode == "full"
        assert _served_w(endpoint).tobytes() == p2["w"].tobytes()
    finally:
        endpoint.close()


def test_publish_compare_and_swap_refuses_stale_generation():
    from flink_ml_tpu_torch.serving.registry import GenerationConflict

    endpoint = _lr_endpoint()
    try:
        live = endpoint.registry.current("default")
        rebound = live.servable.rebind(live.servable.model)
        endpoint.hot_swap(_fit_lr(_lr_table(seed=9), iters=5))
        with pytest.raises(GenerationConflict):
            endpoint.registry.publish_servable(
                "default", rebound, expected_generation=live.generation)
        endpoint.registry.publish_servable("default", rebound)
    finally:
        endpoint.close()


def test_generic_servable_refuses_rebind():
    from flink_ml_tpu_torch.serving.executor import ServableModel

    model = _fit_lr(_lr_table(), iters=2)
    servable = ServableModel(model, _lr_table().drop("label").take(1))
    assert not servable.rebind_safe
    with pytest.raises(TypeError, match="not rebind-safe"):
        servable.rebind(model)


def test_generic_family_publishes_through_a_warmed_redeploy():
    """A servable without ``rebind_safe`` publishes through the registry's
    deploy (warm, then swap) and still accounts the publish."""
    from flink_ml_tpu_torch.serving.executor import ServableModel

    model = _fit_lr(_lr_table())
    registry = ModelRegistry(servable_factory=ServableModel, device="cpu")
    registry.deploy("m", model, _lr_table().drop("label").take(2))
    pub = DeltaPublisher(registry, "m")
    p = params_of_model(model)
    p2 = {"w": p["w"] * np.float32(2.0), "b": p["b"]}
    res = pub.apply(DeltaEncoder().encode(1, p2, pub.stats))
    assert res.mode == "full-redeploy"
    live = registry.current("m")
    assert live.generation == 2 and live.servable.ready
    assert params_of_model(live.servable.model)["w"].tobytes() \
        == p2["w"].tobytes()


def test_staleness_metrics_and_policy_decisions():
    endpoint = _lr_endpoint()
    feats = _lr_table(seed=5).drop("label")
    try:
        _publish_chain(endpoint, [1, 2, 3])
        endpoint.predict(feats.take(2), timeout=JOIN_S)
        snap = endpoint.metrics.snapshot()
        assert snap["publishes_full"] >= 1
        assert snap["publishes_delta"] >= 1
        assert snap["model_staleness_seconds"] >= 0.0
        assert "publishes_per_sec" in snap and "last_publish_bytes" in snap
    finally:
        endpoint.close()
    policy = StalenessPolicy(publish_every=2, full_every=3)
    stats = PublishStats(publishes=1)
    assert policy.due(0, stats) and not policy.due(1, stats)
    assert policy.choose(95, 100, stats) == "full"
    assert policy.choose(10, 100, stats) == "delta"
    assert policy.choose(10, 100, PublishStats(publishes=3)) == "full"
    clock = [100.0]
    stale = StalenessPolicy(publish_every=4, max_staleness_s=5.0,
                            clock=lambda: clock[0])
    fresh = PublishStats(publishes=1, last_publish_at=98.0)
    assert not stale.due(1, fresh)
    clock[0] = 103.5
    assert stale.due(1, fresh)
    with pytest.raises(ValueError):
        StalenessPolicy(publish_every=0)
    with pytest.raises(ValueError):
        StalenessPolicy(full_ratio=0.0)


# -- the WAL window reader ---------------------------------------------------

def test_window_batch_reader_ragged_window_raises(tmp_path):
    log = WindowLog(iter([T.Table({"features": np.zeros((16, 4)),
                                   "label": np.zeros(16)}),
                          T.Table({"features": np.zeros((7, 4)),
                                   "label": np.zeros(7)})]),
                    str(tmp_path / "wal"))
    it = iter(WindowBatchReader(log, 16))
    next(it)
    with pytest.raises(ValueError, match="fixed window grid"):
        next(it)


def test_window_batch_reader_seek_rides_wal_cursor(tmp_path):
    d = str(tmp_path / "wal")
    for _ in WindowLog(_windows(0, 6), d):
        pass
    reader = WindowBatchReader(WindowLog(iter(()), d), 16)
    with pytest.raises(ValueError, match="window boundaries"):
        reader.seek(17)
    reader.seek(4 * 16)
    batches = list(reader)
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[0]["features"],
                                  np.asarray(next(_windows(4, 5))["features"]))


# -- the learner: served bits == the offline fit ------------------------------

def test_learner_publish_cadence_skips_cuts(tmp_path):
    windows = list(_windows(0, 16))
    endpoint = _lr_endpoint(_fit_lr(windows[0], iters=1), d=4)
    try:
        learner = _learner(endpoint, iter(windows), tmp_path,
                           policy=StalenessPolicy(publish_every=2))
        learner.run(max_windows=16)
        assert [r.step for r in learner.publish_log] == [8, 16]
        assert learner.publisher.stats.skips >= 2
        w_off, _ = _offline_fit(windows, 16, every=4)
        assert _served_w(endpoint).tobytes() == w_off.tobytes()
    finally:
        endpoint.close()


def test_train_while_serve_served_bits_match_offline_fit(tmp_path):
    windows = list(_windows(0, 20))
    endpoint = _lr_endpoint(_fit_lr(windows[0], iters=1), d=4)
    try:
        learner = _learner(endpoint, iter(windows), tmp_path)
        spy = _SpyPublisher(endpoint.registry, "default",
                            metrics=endpoint.metrics)
        learner.publisher = spy
        state, loss_log = learner.run(max_windows=20)
        assert len(loss_log) == 1
        assert [s for s, _, _ in spy.history] == [4, 8, 12, 16, 20]
        for step, _, flat in spy.history:
            w_off, b_off = _offline_fit(windows, step, every=4)
            assert flat["w"].tobytes() == w_off.tobytes(), step
            assert flat["b"].tobytes() == np.asarray(b_off).tobytes()
        w_final, _ = _offline_fit(windows, 20, every=4)
        assert _served_w(endpoint).tobytes() == w_final.tobytes()
        out = endpoint.predict(windows[3].drop("label"), timeout=JOIN_S)
        assert out.num_rows == 16
    finally:
        endpoint.close()


def test_learner_validates_its_arguments(tmp_path):
    endpoint = _lr_endpoint(d=4)
    try:
        with pytest.raises(ValueError, match="endpoint= or registry="):
            ContinuousLearner(loss_fn=LOSSES["logistic"], num_features=4,
                              source=iter(()), wal_dir=str(tmp_path),
                              batch_rows=16, checkpoint=CheckpointConfig(
                                  str(tmp_path / "ck")))
        with pytest.raises(ValueError, match="checkpoint="):
            ContinuousLearner(loss_fn=LOSSES["logistic"], num_features=4,
                              source=iter(()), wal_dir=str(tmp_path),
                              endpoint=endpoint, batch_rows=16)
        with pytest.raises(ValueError, match="publish_every_steps"):
            _learner(endpoint, iter(()), tmp_path, publish_every_steps=0)
        with pytest.raises(ValueError, match="single-pass"):
            _learner(endpoint, iter(()), tmp_path,
                     config=TS.SGDConfig(max_epochs=2))
    finally:
        endpoint.close()


# 2^14 slots: the smallest table the ELL kernels tile (128 rows of 128)
MX_D, MX_ND, MX_NC, MX_B = 1 << 14, 4, 6, 256


def _mixed_windows(n, pkg, seed=300):
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        dense = rng.normal(size=(MX_B, MX_ND)).astype(np.float32)
        cat = rng.integers(0, MX_D, size=(MX_B, MX_NC)).astype(np.int32)
        y = (dense[:, 0] + 0.5 * rng.normal(size=MX_B) > 0).astype(
            np.float32)
        cat[:, 1] = np.where(y == 1, 16, 17)
        yield pkg.Table({"features_dense": dense, "features_indices": cat,
                         "label": y})


MX_KEYS = dict(dense_key="features_dense", indices_key="features_indices")


def _mixed_run(pkg, tmp_path, n_windows=12, plan=None, crash=None):
    """One learner of ``pkg`` over the mixed windows, serving a zero-init
    LR; returns (spy history, served w, endpoint metrics snapshot)."""
    windows = list(_mixed_windows(n_windows, pkg))
    boot = _lr_from_weights(np.zeros(MX_D), 0.0, pkg=pkg)
    example = windows[0].drop("label").take(2)
    if pkg is T:
        endpoint = serve_model(boot, example, max_batch_rows=32,
                               max_wait_ms=0.5)
        spy_cls, cls, ck = _SpyPublisher, ContinuousLearner, CheckpointConfig
        kw = dict(device="cpu", loss_fn=LOSSES["logistic"])
    else:
        from flink_ml_tpu.iteration import CheckpointConfig as JCC
        from flink_ml_tpu.parallel.mesh import device_mesh
        import jax

        endpoint = j_serve_model(boot, example, max_batch_rows=32,
                                 max_wait_ms=0.5)

        class _JSpy(JO.DeltaPublisher):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.history = []

            def apply(self, update):
                result = super().apply(update)
                if result.mode != "noop":
                    self.history.append(
                        (result.step, result.mode,
                         {k: v.copy() for k, v in self._base.items()}))
                return result

        spy_cls, cls, ck = _JSpy, JO.ContinuousLearner, JCC
        kw = dict(loss_fn=j_logistic,
                  mesh=device_mesh({"data": 1}, devices=jax.devices()[:1]))
    try:
        learner = cls(num_features=MX_D, source=iter(windows),
                      wal_dir=str(tmp_path / f"wal-{pkg.__name__}"),
                      endpoint=endpoint, batch_rows=MX_B,
                      checkpoint=ck(str(tmp_path / f"ck-{pkg.__name__}")),
                      publish_every_steps=4,
                      config=(TS if pkg is T else JS).SGDConfig(
                          learning_rate=0.4, max_epochs=1, tol=0.0),
                      **MX_KEYS, **kw)
        learner.publisher = spy_cls(endpoint.registry, "default",
                                    metrics=endpoint.metrics)
        learner.run(max_windows=n_windows)
        served = np.asarray(endpoint.registry.current("default")
                            .servable.model._state.coefficients, np.float32)
        return learner.publisher.history, served, windows
    finally:
        endpoint.close()


def test_mixed_learner_matches_the_jax_package(tmp_path, monkeypatch):
    """The whole slice on the mixed (Criteo-shaped) layout: both packages'
    learners publish at the same steps in the same modes, each
    generation's params within atol 1e-5 (the JAX plan forced to "ell",
    the port's B1/B2 route)."""
    monkeypatch.setattr(JS, "plan_mixed_impl", lambda *a, **k: "ell")
    got, got_w, _ = _mixed_run(T, tmp_path)
    want, want_w, _ = _mixed_run(J, tmp_path)
    assert [(s, m) for s, m, _ in got] == [(s, m) for s, m, _ in want]
    assert [s for s, _, _ in got] == [4, 8, 12]
    for (_, _, g), (_, _, w) in zip(got, want):
        np.testing.assert_allclose(g["w"], w["w"], atol=W_ATOL)
        assert abs(float(g["b"]) - float(w["b"])) <= W_ATOL
    np.testing.assert_allclose(got_w, want_w, atol=W_ATOL)


def test_mixed_learner_served_bits_equal_the_offline_fit(tmp_path):
    """Inside the port: after the cut at step T, the served generation is
    bit for bit the offline streamed fit over the first T windows (at the
    learner's chunk of 4 steps)."""
    history, served, windows = _mixed_run(T, tmp_path)
    for step, _, flat in history:
        def make_reader(upto=step):
            for w in windows[:upto]:
                yield w.to_dict()

        state, _ = TS.sgd_fit_outofcore(
            LOSSES["logistic"], make_reader, num_features=MX_D,
            config=TS.SGDConfig(learning_rate=0.4, max_epochs=1, tol=0.0),
            steps_per_dispatch=4, device="cpu", **MX_KEYS)
        assert state.planned_impl == "ell-stream"
        assert flat["w"].tobytes() == np.asarray(
            state.coefficients, np.float32).tobytes(), step
        assert flat["b"].tobytes() == np.float32(state.intercept).tobytes()
    assert served.tobytes() == history[-1][2]["w"].tobytes()


def test_mixed_learner_crash_and_resume_equals_uninterrupted(tmp_path):
    """A crash in the publish seam mid-run heals through resilient_fit:
    the replayed cut republishes as a no-op and the final served bits are
    the uninterrupted run's."""
    _, want, _ = _mixed_run(T, tmp_path / "a")
    windows = list(_mixed_windows(12, T))
    endpoint = serve_model(_lr_from_weights(np.zeros(MX_D), 0.0),
                           windows[0].drop("label").take(2),
                           max_batch_rows=32, max_wait_ms=0.5)
    try:
        learner = _learner(endpoint, iter(windows), tmp_path / "b",
                           num_features=MX_D, batch_rows=MX_B,
                           config=TS.SGDConfig(learning_rate=0.4,
                                               max_epochs=1, tol=0.0),
                           backoff=RetryPolicy(base_delay=0.0,
                                               sleep=lambda s: None),
                           **MX_KEYS)
        report = RecoveryReport()
        with FaultPlan().inject("serving.publish", at=1, kind="crash"):
            learner.run(max_windows=12, report=report)
        assert report.restarts == 1
        assert _served_w(endpoint).tobytes() == want.tobytes()
        assert learner.publish_log[-1].step == 12
    finally:
        endpoint.close()


# -- the hosted-iterate listener ---------------------------------------------

def test_hosted_iterate_listener_publishes_at_checkpoints(tmp_path):
    windows = list(_windows(0, 12))
    endpoint = _lr_endpoint(_fit_lr(windows[0], iters=1), d=4)
    try:
        listener = PublishingListener(
            endpoint.delta_publisher(),
            params_of=lambda s: {"w": s["w"], "b": s["b"]})

        def body(state, epoch, data):
            X, y = (torch.from_numpy(a) for a in data)
            margin = X @ state["w"] + state["b"]
            p = 1.0 / (1.0 + torch.exp(-margin))
            g = X.T @ (p - y) / X.shape[0]
            return IterationBodyResult({
                "w": state["w"] - 0.5 * g,
                "b": state["b"] - 0.5 * torch.mean(p - y)})

        state0 = {"w": torch.zeros(4), "b": torch.zeros(())}
        payloads = ((np.asarray(w["features"], np.float32),
                     np.asarray(w["label"], np.float32)) for w in windows)
        result = iterate(body, state0, payloads,
                         config=IterationConfig(mode="hosted"),
                         listeners=[listener],
                         checkpoint=CheckpointConfig(str(tmp_path / "ck"),
                                                     interval=4))
        assert [r.step for r in listener.publish_log] == [4, 8, 12]
        final_w = result.state["w"].numpy()
        assert _served_w(endpoint).tobytes() == final_w.tobytes()
    finally:
        endpoint.close()


def test_publishing_listener_validates():
    pub = DeltaPublisher(ModelRegistry(device="cpu"), "x")
    with pytest.raises(ValueError, match="publish_on"):
        PublishingListener(pub, publish_on="never")
    with pytest.raises(ValueError, match="every"):
        PublishingListener(pub, every=0)


OK_K, OK_D, OK_ROWS = 8, 4, 128


def _okm_windows(n=8, seed=40):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(OK_K, OK_D)) * 4.0
    for _ in range(n):
        X = centers[rng.integers(0, OK_K, size=OK_ROWS)] \
            + rng.normal(size=(OK_ROWS, OK_D))
        yield X.astype(np.float32)


def test_publishing_listener_over_online_kmeans_matches_the_jax_package():
    """A hosted iterate of the OnlineKMeans decayed update publishes each
    watermark's centroids into a live KMeans endpoint in both packages:
    the published generations agree within rtol 1e-5, atol 1e-6, and the
    port's endpoint serves each generation's offline transform."""
    import jax.numpy as jnp
    from flink_ml_tpu.iteration import IterationBodyResult as JBody
    from flink_ml_tpu.iteration import IterationConfig as JConfig
    from flink_ml_tpu.iteration import iterate as j_iterate
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.models.clustering.online_kmeans import (
        decayed_update)
    from flink_ml_tpu_torch.utils.convert import kmeans_model_from_jax

    windows = list(_okm_windows())
    init = windows[0][:OK_K].copy()
    alpha = 0.9
    example = T.Table({"features": windows[0][:2].astype(np.float64)})

    # the port
    boot = kmeans_model_from_jax(init, device="cpu")
    endpoint = serve_model(boot, example, max_batch_rows=32,
                           max_wait_ms=0.5)
    measure = DistanceMeasure.get_instance("euclidean")
    try:
        listener = _capturing(PublishingListener)(
            endpoint.delta_publisher(), publish_on="epoch",
            params_of=lambda s: {"centroids": s[0]})

        def body(state, epoch, X):
            return IterationBodyResult(decayed_update(
                measure, OK_K, alpha, state[0], state[1],
                torch.from_numpy(X)))

        iterate(body, (torch.from_numpy(init), torch.zeros(OK_K)),
                iter(windows), config=IterationConfig(mode="hosted"),
                listeners=[listener])
        got = [(r.step, r.mode) for r in listener.publish_log]
        gens = listener.captured
        served = endpoint.predict(example, timeout=JOIN_S)
        model = endpoint.registry.current("default").servable.model
        np.testing.assert_array_equal(
            served["prediction"], model.transform(example)[0]["prediction"])
    finally:
        endpoint.close()

    # the JAX package
    from flink_ml_tpu.models import KMeansModel as JKMeansModel

    jboot = JKMeansModel()
    jboot.set_model_data(J.Table({"centroids": init[None]}))
    jendpoint = j_serve_model(jboot, J.Table({"features": np.asarray(
        example["features"])}), max_batch_rows=32, max_wait_ms=0.5)
    try:
        jlistener = _capturing(JO.PublishingListener)(
            jendpoint.delta_publisher(), publish_on="epoch",
            params_of=lambda s: {"centroids": s[0]})

        def jbody(state, epoch, X):
            centroids, weights = state
            X = jnp.asarray(X)
            d2 = jnp.sum((X[:, None, :] - centroids[None]) ** 2, axis=-1)
            onehot = jnp.eye(OK_K, dtype=jnp.float32)[jnp.argmin(d2, 1)]
            counts = onehot.sum(0)
            sums = onehot.T @ X
            decayed = weights * alpha
            denom = decayed + counts
            new_c = jnp.where(counts[:, None] > 0,
                              (centroids * decayed[:, None] + sums)
                              / jnp.maximum(denom, 1e-12)[:, None],
                              centroids)
            return JBody((new_c, denom))

        j_iterate(jbody, (jnp.asarray(init), jnp.zeros(OK_K, jnp.float32)),
                  iter(windows), config=JConfig(mode="hosted", jit=False),
                  listeners=[jlistener])
        want = [(r.step, r.mode) for r in jlistener.publish_log]
        jgens = jlistener.captured
    finally:
        jendpoint.close()
    assert got == want and len(got) == len(windows)
    for g, w in zip(gens, jgens):
        np.testing.assert_allclose(g, w, **C_TOL)


def _capturing(cls):
    """``cls`` (either package's PublishingListener) recording every
    published generation's centroids."""
    class Capturing(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.captured = []

        def _publish(self, epoch, context):
            before = len(self.publish_log)
            super()._publish(epoch, context)
            if len(self.publish_log) > before:
                self.captured.append(
                    np.array(self.publisher._base["centroids"]))

    return Capturing


# -- publishes into the kernel servables --------------------------------------

def _wd_model(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(96, 3))
    table = T.Table({"denseFeatures": X,
                     "catFeatures": rng.integers(0, 6, size=(96, 2)),
                     "label": (X[:, 0] > 0) * 1.0})
    model = (T.WideDeep(device="cpu").set_vocab_sizes([6, 6])
             .set(T.WideDeep.EMBEDDING_DIM, 4)
             .set(T.WideDeep.HIDDEN_UNITS, [8]).set_max_iter(1).fit(table))
    return model, table.drop("label")


@pytest.mark.parametrize("emb_cache", [False, True])
def test_widedeep_table_delta_serves_the_offline_transform(emb_cache):
    """A sparse update of embedding rows publishes as a delta (only the
    touched rows on the wire); every response afterwards equals the
    offline transform of the published model bit for bit, and the cached
    servable starts a fresh row cache."""
    model, feats = _wd_model()
    kw = dict(emb_cache=True, cache_block_rows=2,
              cache_capacity_blocks=4) if emb_cache else {}
    endpoint = serve_model(model, feats.take(2), max_batch_rows=32,
                           max_wait_ms=0.5, **kw)
    try:
        endpoint.predict(feats.take(8), timeout=JOIN_S)
        pub = endpoint.delta_publisher()
        enc = DeltaEncoder()
        p = params_of_model(model)
        encode_and_publish(enc, pub, 1, p)
        old = endpoint.registry.current("default").servable
        p2 = unflatten_params(p, flatten_params(p))
        p2["emb"] = p2["emb"].copy()
        p2["emb"][[1, 7]] += np.float32(0.5)
        res = encode_and_publish(enc, pub, 2, p2)
        assert res.mode == "delta"
        assert res.payload_bytes == 2 * 4 * (8 + 4)
        live = endpoint.registry.current("default").servable
        published = live.model
        assert flatten_params(params_of_model(published))["emb"].tobytes() \
            == p2["emb"].tobytes()
        out = endpoint.predict(feats.take(12), timeout=JOIN_S)
        want = published.transform(feats.take(12))[0]
        np.testing.assert_array_equal(out["rawPrediction"],
                                      want["rawPrediction"])
        if emb_cache:
            assert live.cache is not old.cache
    finally:
        endpoint.close()


def test_kmeans_delta_publish_serves_the_offline_transform():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(64, 5))
    table = T.Table({"features": X})
    model = T.KMeans(device="cpu").set_k(4).set_max_iter(3).fit(table)
    endpoint = serve_model(model, table.take(2), max_batch_rows=32,
                           max_wait_ms=0.5)
    try:
        pub = endpoint.delta_publisher()
        enc = DeltaEncoder()
        p = params_of_model(model)
        encode_and_publish(enc, pub, 1, p)
        p2 = {"centroids": p["centroids"].copy()}
        p2["centroids"][2] = p2["centroids"][0] + 0.01
        assert encode_and_publish(enc, pub, 2, p2).mode in ("delta", "full")
        served = endpoint.predict(table.take(20), timeout=JOIN_S)
        ref = TO.model_with_params(model, p2).transform(table.take(20))[0]
        np.testing.assert_array_equal(served["prediction"],
                                      ref["prediction"])
    finally:
        endpoint.close()


# -- train-while-serve chaos (tests/test_faults.py's cases) ------------------

def _ctl_windows(lo, hi, rows=16, d=4):
    return _windows(lo, hi, rows=rows, d=d, seed=2000)


def _ctl_offline_w(n_windows, every=4):
    return _offline_fit(list(_ctl_windows(0, n_windows)), n_windows,
                        every)[0]


def _ctl_endpoint():
    boot_window = next(_ctl_windows(0, 1))
    return serve_model(_fit_lr(boot_window, iters=1),
                       boot_window.drop("label").take(2),
                       max_batch_rows=32, max_wait_ms=0.5)


def _ctl_learner(endpoint, source, tmp_path, **kw):
    return _learner(endpoint, source, tmp_path,
                    backoff=RetryPolicy(base_delay=0.0,
                                        sleep=lambda s: None), **kw)


def test_continuous_crash_mid_delta_publish_resumes_served_bitexact(
        tmp_path):
    endpoint = _ctl_endpoint()
    try:
        plan = FaultPlan().inject("serving.publish", at=1, kind="crash")
        learner = _ctl_learner(endpoint, _ctl_windows(0, 24), tmp_path)
        report = RecoveryReport()
        with plan:
            learner.run(max_windows=24, report=report)
        assert report.restarts == 1
        assert _served_w(endpoint).tobytes() \
            == _ctl_offline_w(24).tobytes()
        assert learner.publish_log[-1].step == 24
    finally:
        endpoint.close()


def test_continuous_torn_wal_tail_resumes_served_bitexact(tmp_path):
    endpoint = _ctl_endpoint()
    try:
        plan = FaultPlan().inject("source.pull", at=10, kind="crash")
        learner1 = _ctl_learner(
            endpoint, plan.wrap_source(_ctl_windows(0, 24)), tmp_path,
            max_restarts=0)
        with plan, pytest.raises(InjectedCrash):
            learner1.run(max_windows=24)
        wal_dir = str(tmp_path / "wal")
        logged = sorted(f for f in os.listdir(wal_dir)
                        if f.startswith("win-"))
        assert logged[-1] == "win-00000009.npz"
        corrupt_file(os.path.join(wal_dir, logged[-1]), mode="torn")
        learner2 = _ctl_learner(endpoint, _ctl_windows(9, 24), tmp_path)
        learner2.run(max_windows=24)
        assert _served_w(endpoint).tobytes() \
            == _ctl_offline_w(24).tobytes()
    finally:
        endpoint.close()


def test_zero_dropped_requests_during_continuous_publishes():
    endpoint = _ctl_endpoint()
    try:
        feats = next(_ctl_windows(5, 6)).drop("label")
        pub = endpoint.delta_publisher()
        enc = DeltaEncoder()
        p = params_of_model(
            endpoint.registry.current("default").servable.model)
        pub.apply(enc.encode(1, p, pub.stats))
        enc.ack()
        gen0 = endpoint.registry.current("default").generation
        published = {gen0: dict(p)}
        results, errors = [], []
        lock = threading.Lock()

        def client(worker):
            try:
                for i in range(20):
                    req = feats.take(1 + (i % 8))
                    out = endpoint.predict(req, timeout=JOIN_S)
                    with lock:
                        results.append((req, out))
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in clients:
            t.start()
        for step in range(2, 30):
            p = {"w": p["w"] + np.float32(0.01), "b": p["b"]}
            res = pub.apply(enc.encode(step, p, pub.stats))
            enc.ack()
            published[res.generation] = dict(p)
        for t in clients:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in clients)
        assert not errors, f"dropped/failed requests: {errors[:3]}"
        assert len(results) == 4 * 20
        assert endpoint.registry.current("default").generation >= gen0 + 20
        assert endpoint.metrics.shed.value == 0
        # every response is exactly one published generation's bits
        models = [_lr_from_weights(q["w"], q["b"])
                  for q in published.values()]
        for req, out in results:
            raw = np.asarray(out["rawPrediction"])
            assert sum(np.array_equal(
                raw, m.transform(req)[0]["rawPrediction"])
                for m in models) >= 1
    finally:
        endpoint.close()


def test_delta_publish_to_int8_tenant_recalibrates_and_swaps_atomically():
    from flink_ml_tpu_torch.kernels.quantize import quantize_channelwise

    boot_window = next(_ctl_windows(0, 1))
    endpoint = serve_model(_fit_lr(boot_window, iters=1),
                           boot_window.drop("label").take(2),
                           max_batch_rows=32, max_wait_ms=0.5,
                           precision="int8")
    try:
        feats = next(_ctl_windows(5, 6)).drop("label")
        live0 = endpoint.registry.current("default")
        old_servable = live0.servable
        assert old_servable.precision == "int8"
        scales0 = np.asarray(old_servable._kernel.params["w"]["s"])
        old_a = np.asarray(endpoint.predict(feats)["rawPrediction"])
        np.testing.assert_array_equal(
            old_a, np.asarray(endpoint.predict(feats)["rawPrediction"]))
        pub = endpoint.delta_publisher()
        enc = DeltaEncoder()
        p = params_of_model(old_servable.model)
        p2 = {"w": (p["w"] * np.float32(1.5)).astype(np.float32),
              "b": p["b"]}
        pub.apply(enc.encode(1, p2, pub.stats))
        enc.ack()
        live1 = endpoint.registry.current("default")
        assert live1.generation > live0.generation
        assert live1.servable.precision == "int8"
        scales1 = np.asarray(live1.servable._kernel.params["w"]["s"])
        assert scales1.tobytes() != scales0.tobytes()
        exp_q, exp_s = quantize_channelwise(p2["w"])
        np.testing.assert_array_equal(
            np.asarray(live1.servable._kernel.params["w"]["q"]), exp_q)
        np.testing.assert_array_equal(scales1, exp_s)
        new_a = np.asarray(endpoint.predict(feats)["rawPrediction"])
        np.testing.assert_array_equal(
            new_a, np.asarray(endpoint.predict(feats)["rawPrediction"]))
        assert new_a.tobytes() != old_a.tobytes()
        np.testing.assert_array_equal(
            np.asarray(old_servable.predict(feats)["rawPrediction"]), old_a)
    finally:
        endpoint.close()


# -- index tenants (tests/test_retrieval.py's, tests/test_faults.py's) -------

def _gaussian(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


def test_publish_adapters_round_trip_index_params():
    idx = T.IVFIndex.build(_gaussian(120, 8, 24), nlist=4, k=5, seed=11,
                           drift_threshold=None, device="cpu")
    params = params_of_model(idx)
    assert set(params) == set(idx.params)
    _, nxt = idx.updated(inserts=_gaussian(2, 8, 25))
    rebound = TO.model_with_params(idx, params_of_model(nxt))
    assert isinstance(rebound, T.IVFIndex)
    q = _gaussian(6, 8, 26)
    np.testing.assert_array_equal(rebound.search(q)[0], nxt.search(q)[0])
    assert rebound.params is not idx.params


def test_index_delta_publish_swaps_generations_atomically():
    """Insert-as-delta: the generation advances, the swapped lists serve
    the inserted vectors, the previous generation's servable still
    answers the old lists, and the delta ships only the touched rows."""
    idx = T.IVFIndex.build(_gaussian(240, 16, 30), nlist=8, k=5, nprobe=8,
                           seed=3, drift_threshold=None, device="cpu")
    q = T.Table({"query": _gaussian(8, 16, 31)})
    s = SharedScheduler(max_batch_rows=64, max_wait_ms=0.5,
                        queue_capacity=1024)
    s.add_tenant("retr", idx, q.take(2), slo=SLO_INTERACTIVE)
    s.start()
    try:
        ref_old = s.predict("retr", q, timeout=JOIN_S)["neighbors"]
        live0 = s.registry.current("retr")
        mode, nxt = idx.updated(inserts=np.asarray(q["query"]))
        assert mode == "delta"
        pub = s.delta_publisher("retr")
        assert pub._name == "retr"
        enc = DeltaEncoder()
        res0 = TO.driver.publish_index_update(enc, pub, 1, "delta", idx)
        assert res0.mode == "full"          # the first publish anchors
        res1 = TO.driver.publish_index_update(enc, pub, 2, mode, nxt)
        assert res1.mode == "delta" and res1.generation == 3
        assert res1.payload_bytes < sum(
            a.nbytes for a in nxt.params.values()) // 4
        got = s.predict("retr", q, timeout=JOIN_S)
        np.testing.assert_array_equal(np.asarray(got["neighbors"])[:, 0],
                                      np.arange(240, 248))
        want_nn, want_d = nxt.search(np.asarray(q["query"]))
        np.testing.assert_array_equal(got["neighbors"], want_nn)
        assert np.asarray(got["distances"]).tobytes() == want_d.tobytes()
        np.testing.assert_array_equal(
            live0.servable.predict(q)["neighbors"], ref_old)
        assert s.registry.current("retr").servable is not live0.servable
    finally:
        s.close()


def test_index_reanchor_publishes_whole_or_redeploys():
    """A re-anchor ships the rebuilt params as a full update on the
    rebind path when the shapes held, and through a warmed redeploy when
    the block grew; each generation serves its index's search."""
    X = _gaussian(120, 8, 40)
    idx = T.IVFIndex.build(X, nlist=4, k=5, nprobe=4, seed=1,
                           drift_threshold=None, device="cpu")
    q = T.Table({"query": _gaussian(6, 8, 41)})
    endpoint = serve_model(idx, q.take(2), max_batch_rows=16,
                           max_wait_ms=0.5)
    try:
        pub, enc = endpoint.delta_publisher(), DeltaEncoder()
        TO.driver.publish_index_update(enc, pub, 1, "delta", idx)
        same = idx._rebuilt(dict(idx._store))
        assert same.block == idx.block
        res = TO.driver.publish_index_update(enc, pub, 2, "reanchor", same)
        assert res.mode == "full"
        grown = np.concatenate([X, _gaussian(400, 8, 42)])
        mode, big = idx.updated(inserts=grown[120:],
                                insert_ids=np.arange(120, 520))
        assert mode == "reanchor" and big.block != idx.block
        res = TO.driver.publish_index_update(enc, pub, 3, mode, big)
        assert res.mode == "full-redeploy"
        live = endpoint.registry.current("default")
        assert live.servable.ready and live.generation == res.generation
        out = endpoint.predict(q, timeout=JOIN_S)
        np.testing.assert_array_equal(out["neighbors"],
                                      big.search(np.asarray(q["query"]))[0])
        assert pub.stats.fulls == 3
        # a replay of the redeployed step is a no-op
        assert pub.redeploy(3, big).mode == "noop"
        with pytest.raises(ValueError, match="mode"):
            TO.driver.publish_index_update(enc, pub, 4, "rebuild", big)
    finally:
        endpoint.close()


def test_crash_mid_index_delta_publish_heals_idempotently():
    rng = np.random.default_rng(190)
    X = rng.normal(size=(240, 16)).astype(np.float32)
    idx = T.IVFIndex.build(X, nlist=8, k=5, nprobe=8, seed=1,
                           drift_threshold=None, device="cpu")
    q = T.Table({"query": rng.normal(size=(8, 16)).astype(np.float32)})
    endpoint = serve_model(idx, q.take(2), max_batch_rows=32,
                           max_wait_ms=0.5)
    try:
        old_a = np.asarray(endpoint.predict(q, timeout=JOIN_S)["neighbors"])
        gen0 = endpoint.registry.current("default").generation
        mode, nxt = idx.updated(inserts=np.asarray(q["query"]))
        assert mode == "delta"
        pub = endpoint.delta_publisher()
        enc = DeltaEncoder()
        with FaultPlan().inject("serving.publish", at=0, kind="crash"), \
                pytest.raises(InjectedCrash):
            pub.apply(enc.encode(1, nxt.params, pub.stats))
        assert endpoint.registry.current("default").generation == gen0
        np.testing.assert_array_equal(
            np.asarray(endpoint.predict(q, timeout=JOIN_S)["neighbors"]),
            old_a)
        res = pub.apply(enc.encode(1, nxt.params, pub.stats))
        enc.ack()
        assert res.generation == gen0 + 1
        new_a = np.asarray(endpoint.predict(q, timeout=JOIN_S)["neighbors"])
        np.testing.assert_array_equal(
            new_a,
            np.asarray(endpoint.predict(q, timeout=JOIN_S)["neighbors"]))
        np.testing.assert_array_equal(new_a[:, 0], np.arange(240, 248))
    finally:
        endpoint.close()


def test_recall_probe_publishes_to_the_tenant_gauge():
    from flink_ml_tpu_torch.retrieval.metrics import RecallProbe

    X = _gaussian(512, 16, 32)
    idx = T.IVFIndex.build(X, nlist=8, k=5, nprobe=8, seed=4,
                           device="cpu")
    q = T.Table({"query": X[:16] + 0.01})
    s = SharedScheduler(max_batch_rows=64, max_wait_ms=0.5)
    tenant = s.add_tenant("retr", idx, q.take(2), slo=SLO_INTERACTIVE)
    s.start()
    try:
        out = s.predict("retr", q, timeout=JOIN_S)
        probe = RecallProbe(idx, sample=1.0)
        assert probe.observe(np.asarray(q["query"]),
                             neighbors=np.asarray(out["neighbors"])) == 1.0
        assert probe.publish(tenant.metrics) == 1.0
        snap = s.snapshot()
        assert snap["tenants.retr.recall_probe"] == 1.0
    finally:
        s.close()


# -- tenant isolation (tests/test_scheduler.py's case) -----------------------

def test_delta_publish_to_one_tenant_leaves_others_untouched():
    rng = np.random.default_rng(21)
    d = 8
    a1 = _lr_from_weights(rng.normal(size=d), 0.0)
    a2 = _lr_from_weights(rng.normal(size=d) + 2.0, -0.5)
    model_b = _lr_from_weights(rng.normal(size=d) - 1.0, 0.3)
    feats = T.Table({"features": rng.normal(size=(256, d))})
    s = SharedScheduler(max_batch_rows=64, max_wait_ms=0.5,
                        queue_capacity=8192)
    s.add_tenant("a", a1, feats.take(2), slo=SLO_STANDARD)
    s.add_tenant("b", model_b, feats.take(2), slo=SLO_STANDARD)
    s.start()
    ref_b = model_b.transform(feats)[0]["rawPrediction"]
    ref_a = [m.transform(feats)[0]["rawPrediction"] for m in (a1, a2)]
    stop = threading.Event()
    publishes = [0]
    errors = []

    def publisher():
        pub = s.delta_publisher("a")
        enc = DeltaEncoder()
        try:
            while not stop.is_set():
                nxt = (a1, a2)[(publishes[0] + 1) % 2]
                encode_and_publish(enc, pub, publishes[0] + 1,
                                   params_of_model(nxt))
                publishes[0] += 1
                stop.wait(0.002)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    def client(name, worker):
        crng = np.random.default_rng(worker)
        try:
            for _ in range(30):
                start = int(crng.integers(0, 200))
                rows = int(crng.integers(1, 6))
                raw = s.predict(name, feats.slice(start, start + rows),
                                timeout=JOIN_S)["rawPrediction"]
                if name == "a":
                    assert any(np.array_equal(raw, r[start:start + rows])
                               for r in ref_a), "mixed-generation response"
                else:
                    np.testing.assert_array_equal(
                        raw, ref_b[start:start + rows])
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    try:
        pub = threading.Thread(target=publisher)
        clients = [threading.Thread(target=client, args=("b", w))
                   for w in range(3)]
        clients += [threading.Thread(target=client, args=("a", 10 + w))
                    for w in range(2)]
        pub.start()
        for t in clients:
            t.start()
        for t in clients:
            t.join(60)
        stop.set()
        pub.join(10)
        assert not any(t.is_alive() for t in clients + [pub])
        assert not errors, errors[:3]
        assert publishes[0] > 0
        b_metrics = s.tenant("b").metrics
        snap = b_metrics.group.snapshot()
        assert snap["model_generation"] == 1
        assert b_metrics.latency.count == snap["requests"] == 90
        assert snap["publishes_delta"] == 0 and snap["publishes_full"] == 0
        assert s.registry.generation("a") == publishes[0] + 1
    finally:
        s.close()


# -- the trace chain (tests/test_obs.py's case) -------------------------------

def test_trace_correlates_wal_cut_publish_and_request(tmp_path):
    windows = list(_windows(0, 8))
    endpoint = _lr_endpoint(_fit_lr(windows[0], iters=1), d=4)
    tracer = trace_mod.tracer
    try:
        tracer.enable()
        _learner(endpoint, iter(windows), tmp_path).run(max_windows=8)
        assert endpoint.predict(windows[3].drop("label"),
                                timeout=JOIN_S).num_rows == 16
        tracer.disable()
        wal = sorted(s.ids["window"] for s in tracer.find("wal_append"))
        assert wal == list(range(8))
        cuts = {s.ids["step"] for s in tracer.find("checkpoint_write")}
        assert {4, 8} <= cuts
        pub_by_step = {s.ids["step"]: s for s in tracer.find("delta_publish")}
        assert {4, 8} <= set(pub_by_step)
        for step, span in pub_by_step.items():
            assert step in cuts
            assert "generation" in span.ids
        live_gen = pub_by_step[8].ids["generation"]
        served = [s for s in tracer.find("request")
                  if s.ids.get("generation") == live_gen]
        assert served and all("request_id" in s.ids for s in served)
        assert any(tracer.find("train_chunk"))
        path = str(tmp_path / "trace.json")
        n = tracer.export_chrome(path)
        events = json.load(open(path))["traceEvents"]
        assert len(events) == n
        pub_ev = [e for e in events if e["name"] == "delta_publish"
                  and e["args"].get("step") == 8]
        assert pub_ev and pub_ev[0]["args"]["generation"] == live_gen
    finally:
        tracer.disable()
        tracer.clear()
        endpoint.close()
