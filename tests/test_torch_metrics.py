"""The port's metrics surfaces (``utils/metrics.py``, ``obs/tree.py``,
``serving/metrics.py``) against the JAX package's, on the CPU: for the
same providers the tree snapshots and the Prometheus text are identical;
the sampler's JSONL survives a torn tail and refuses mid-series
corruption; the ``kernels`` provider is the port's own dispatch and
launch counters, re-exported by ``ServingMetrics`` only when they move;
``IterationMetricsListener`` over the port's hosted ``iterate``."""

import json
import math
import re
import time

import numpy as np
import pytest

from flink_ml_tpu.obs import tree as JT
from flink_ml_tpu.serving.metrics import ServingMetrics as JServingMetrics
from flink_ml_tpu.utils.metrics import MetricGroup as JMetricGroup
from flink_ml_tpu_torch.obs import tree as TT
from flink_ml_tpu_torch.serving.metrics import (LatencyTracker,
                                                ServingMetrics)
from flink_ml_tpu_torch.utils.metrics import (IterationMetricsListener,
                                              MetricGroup)


def _group(cls):
    g = cls("root")
    g.counter("records").inc(5)
    g.gauge("rate").set(12.5)
    g.gauge("label").set("SERVING")
    sub = g.add_group("epoch")
    sub.counter("n").inc()
    sub.add_group("deep").gauge("nan").set(float("nan"))
    sub.add_group("deep").gauge("arr").set(np.arange(3))
    return g


def _drive(m, t0=1000.0):
    m.on_batch(n_requests=2, rows=3, bucket=8, latencies_s=[0.01, 0.02],
               queue_depth=1, generation=1)
    m.on_shed(4, generation=1)
    m.on_publish(2, mode="delta", payload_bytes=128, now=t0)
    m.on_publish(3, mode="full", now=t0 + 2.0)
    m.touch_staleness(now=t0 + 2.5)
    m.on_requeue(2)
    m.on_rollback()


def test_metric_group_snapshot_equals_jax():
    assert _group(MetricGroup).snapshot().keys() == \
        _group(JMetricGroup).snapshot().keys()
    a, b = _group(MetricGroup).snapshot(), _group(JMetricGroup).snapshot()
    for k in a:
        if isinstance(a[k], float) and math.isnan(a[k]):
            assert math.isnan(b[k])
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def _trees(providers):
    trees = []
    for mod in (TT, JT):
        tree = mod.MetricsTree()
        for name, make in providers.items():
            tree.register(name, make(mod))
        trees.append(tree)
    return trees


@pytest.mark.parametrize("case", ["groups", "dicts", "serving"])
def test_tree_snapshot_and_prometheus_text_equal_jax(case):
    if case == "groups":
        providers = {
            "g": lambda mod: _group(MetricGroup if mod is TT
                                    else JMetricGroup),
            "fn": lambda mod: (lambda: {"a": np.int64(3), "b": [1, 2],
                                        "c": {"d": 0.5, "e": True}}),
            "absent": lambda mod: (lambda: None),
        }
    elif case == "dicts":
        live = {"impl": "dense-stream", "loss": np.asarray([1.0, 0.5]),
                "epoch_s": np.float32(0.25), "inf": float("inf"),
                "1st": 7, "a.b": {"c-d": 2}}
        providers = {"training": lambda mod: live,
                     "ref": lambda mod: {"b": np.int64(2)}}
    else:
        def serving(mod):
            m = ServingMetrics() if mod is TT else JServingMetrics()
            _drive(m)
            # the kernels.* re-export is each package's own dispatch
            # surface; the rest of the bundle must be the same
            return lambda: {k: v for k, v in m.snapshot().items()
                            if not k.startswith("kernels.")}
        providers = {"serving": serving}
    port, jax_tree = _trees(providers)
    a, b = port.snapshot(), jax_tree.snapshot()
    assert json.dumps(a, sort_keys=True, default=str) == \
        json.dumps(b, sort_keys=True, default=str)
    assert TT.prometheus_text(a) == JT.prometheus_text(b)
    assert port.names() == jax_tree.names()


def test_metrics_tree_provider_kinds_and_none():
    tree = TT.MetricsTree()
    tree.register("fn", lambda: {"a": 1})
    tree.register("ref", {"b": np.int64(2)})
    tree.register("absent", lambda: None)
    assert tree.snapshot() == {"fn": {"a": 1}, "ref": {"b": 2}}
    tree.unregister("ref")
    assert tree.names() == ["absent", "fn"]
    with pytest.raises(TypeError, match="unsnapshotable"):
        tree.register("bad", 42)


_PROM_LINE = re.compile(
    r"^(?:# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* gauge"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]* -?[0-9.eE+-]+(?:\.[0-9]+)?)$")


def test_default_tree_kernels_provider_and_exposition_parses():
    """``default_tree``'s ``kernels`` provider is the port's dispatch and
    launch counters; every exposition line parses; NaN staleness is
    absent and strings are skipped."""
    from flink_ml_tpu_torch.ops import kmeans

    m = ServingMetrics()
    m.on_batch(n_requests=1, rows=1, bucket=8, latencies_s=[0.005],
               queue_depth=0, generation=2)
    snap = TT.default_tree(serving=m).snapshot()
    assert set(snap) == {"kernels", "serving"}
    assert snap["kernels"] == TT.kernel_stats()
    assert set(snap["kernels"]["launches"]) >= set(kmeans.LAUNCHES)
    text = TT.prometheus_text(snap)
    for line in text.strip().split("\n"):
        assert _PROM_LINE.match(line), f"unparseable line: {line!r}"
    assert re.search(r"^flink_ml_tpu_serving_requests 1$", text, re.M)
    assert "flink_ml_tpu_kernels_launches_kmeans_assign_reduce" in text
    assert "SERVING" not in text
    assert "model_staleness_seconds" not in text
    json.dumps(snap)


def test_kernel_gauges_republish_only_when_counters_move():
    """The ``kernels.*`` re-export refreshes only when a dispatch or a
    launch count moved: an idle endpoint's tick re-walks nothing."""
    from flink_ml_tpu_torch.api import chain
    from flink_ml_tpu_torch.data.table import Table

    m = ServingMetrics()
    m.publish()
    sentinel = object()
    gauge = m.group.add_group("kernels").gauge("dispatches")
    gauge.set(sentinel)
    m.publish()                            # counters unchanged -> skipped
    assert gauge.value is sentinel
    kernel = chain.StageKernel(fn=_double_fn, static=(), params={},
                               consumes=("obs_col",), produces=("obs_out",),
                               device="cpu")
    chain.run_kernel(kernel, Table({"obs_col": np.ones((4,), np.float32)}))
    m.publish()                            # dispatches moved -> refreshed
    assert gauge.value == chain.dispatch_count()


def _double_fn(static, params, cols):
    return {"obs_out": cols["obs_col"] * 2.0}


def test_staleness_sentinel_never_exports_negative():
    m = ServingMetrics()
    m.touch_staleness()
    assert math.isnan(m.staleness_seconds)
    text = TT.prometheus_text({"serving": m.group.snapshot()})
    assert "model_staleness_seconds" not in text
    assert "-1" not in text.split()
    m.on_publish(1, mode="delta", now=1000.0)
    m.touch_staleness(now=1002.5)
    assert m.staleness_seconds == pytest.approx(2.5)
    text = TT.prometheus_text({"serving": m.group.snapshot()})
    assert re.search(
        r"^flink_ml_tpu_serving_model_staleness_seconds 2\.5$", text, re.M)


def test_publishes_per_sec_ewma_first_publish():
    m = ServingMetrics()
    m.on_publish(1, mode="delta", now=1000.0)
    assert m.snapshot()["publishes_per_sec"] is None
    m.on_publish(2, mode="delta", now=1002.0)
    assert m.snapshot()["publishes_per_sec"] == pytest.approx(0.5)
    m.on_publish(3, mode="delta", now=1004.0)
    assert m.snapshot()["publishes_per_sec"] == pytest.approx(0.5)


def test_latency_ring_quantiles_at_wraparound():
    tracker = LatencyTracker(window=8)
    for v in range(1, 13):                 # 12 records, window 8
        tracker.record(float(v))
    assert tracker.count == 12
    newest = np.asarray([5.0, 6, 7, 8, 9, 10, 11, 12])
    p50, p99 = tracker.quantiles((0.5, 0.99))
    assert p50 == pytest.approx(float(np.quantile(newest, 0.5)))
    assert p99 == pytest.approx(float(np.quantile(newest, 0.99)))
    with pytest.raises(ValueError):
        LatencyTracker(window=0)


# -- the sampler ----------------------------------------------------------------

def test_sampler_appends_and_survives_torn_tail(tmp_path):
    path = str(tmp_path / "series.jsonl")
    tree = TT.MetricsTree().register("x", lambda: {"v": 1})
    clock = iter([10.0, 11.0]).__next__
    sampler = TT.ObsSampler(tree, path, interval_s=60.0, clock=clock)
    sampler.sample()
    sampler.sample()
    with open(path, "a") as f:             # crash mid-append
        f.write('{"t": 12.0, "x": {"v"')
    samples = TT.read_samples(path)
    assert [s["t"] for s in samples] == [10.0, 11.0]
    assert samples == JT.read_samples(path)
    assert samples[0]["x"] == {"v": 1}
    assert sampler.samples_written == 2
    assert TT.read_samples(str(tmp_path / "missing.jsonl")) == []


def test_sampler_mid_series_corruption_raises(tmp_path):
    path = str(tmp_path / "series.jsonl")
    with open(path, "w") as f:
        f.write('{"t": 1}\nGARBAGE\n{"t": 2}\n')
    with pytest.raises(ValueError, match="not the tail"):
        TT.read_samples(path)


def test_sampler_background_thread_ticks(tmp_path):
    path = str(tmp_path / "bg.jsonl")
    tree = TT.MetricsTree().register("x", lambda: {"v": 2})
    sampler = TT.ObsSampler(tree, path, interval_s=0.01).start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            sampler.start()
        deadline = time.time() + 5.0
        while sampler.samples_written < 2 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        sampler.stop(timeout=5.0)
    assert sampler._thread is None
    assert len(TT.read_samples(path)) >= 3      # ticks + the final sample
    with pytest.raises(ValueError, match="interval_s"):
        TT.ObsSampler(tree, path, interval_s=0.0)


# -- the iteration listener ------------------------------------------------------

def test_iteration_metrics_listener_over_hosted_iterate():
    """The listener on the port's hosted loop counts epochs and records,
    keeps each scalar epoch output and the total seconds."""
    import torch

    from flink_ml_tpu_torch.iteration import (IterationConfig,
                                              IterationBodyResult, iterate)

    listener = IterationMetricsListener(records_per_epoch=10, log_every=2)

    def body(state, epoch, data):
        new = state + data
        return IterationBodyResult(new, outputs=new.sum())

    iterate(body, torch.zeros(2), torch.ones(2),
            config=IterationConfig(max_epochs=4, mode="hosted"),
            listeners=[listener])
    snap = listener.group.snapshot()
    assert snap["epochs"] == 4 and snap["records"] == 40
    assert snap["records_per_sec"] > 0
    assert listener.epoch_metrics == [2.0, 4.0, 6.0, 8.0]
    assert snap["total_seconds"] == pytest.approx(
        sum(listener.epoch_seconds))
