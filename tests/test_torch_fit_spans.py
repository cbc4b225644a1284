"""The spans of the two in-memory fits (``WideDeep.fit``, ``KMeans.fit``)
on the process-wide tracer (``obs/trace.py``), on the CPU at tiny sizes:
their nesting and order, nothing recorded and no CUDA event made off the
recording path, and the same spans as ``user_annotation`` ranges of a
``torch.profiler`` session with the tracer disabled."""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

import flink_ml_tpu_torch as T
from flink_ml_tpu_torch.obs import trace as trace_mod
from flink_ml_tpu_torch.obs.trace import Span, null_span, tracer

VOCAB = [20, 10, 5]
N_WD, BATCH, EPOCHS = 512, 128, 2
STEPS = N_WD // BATCH
# at or above KMeans' kernel plan (``_KERNEL_MIN_ROWS``): the rounds call
# ``ops.kmeans.kmeans_update_stats`` (its plain twin on the CPU)
N_KM, ROUNDS = 1 << 16, 3

WD_CHILDREN = ["widedeep.validate", "widedeep.layout", "widedeep.copy_in",
               "widedeep.route", "widedeep.init",
               "widedeep.params_to_device", "widedeep.epochs",
               "widedeep.copy_out"]
KM_CHILDREN = ["kmeans.points", "kmeans.copy_in", "kmeans.init",
               "kmeans.rounds", "kmeans.copy_out"]
STEP_PARTS = {"gather": ["wd_step.rows", "wd_step.grad", "wd_step.fold",
                         "wd_step.adam"],
              "off": ["wd_step.grad", "wd_step.adam"],
              "lazy": ["wd_step.grad", "wd_step.adam"]}
EPS = 1e-9


@pytest.fixture
def ring():
    """The process-wide tracer, empty and disabled, left so after."""
    tracer.disable()
    tracer.clear()
    yield tracer
    tracer.disable()
    tracer.clear()


def _wd_fit(mode="gather"):
    rng = np.random.default_rng(0)
    cat = np.stack([rng.integers(0, v, size=N_WD) for v in VOCAB], 1)
    dense = rng.normal(size=(N_WD, 4)).astype(np.float32)
    y = (rng.random(N_WD) < 0.3).astype(np.int64)
    est = (T.WideDeep(device="cpu").set_vocab_sizes(VOCAB)
           .set_max_iter(EPOCHS).set_global_batch_size(BATCH).set_seed(1))
    est.set(T.WideDeep.LAZY_EMB_OPT, mode == "lazy")
    est.set(T.WideDeep.ROUTED_EMB_GRAD, "on" if mode == "gather" else "off")
    est.fit(T.Table({"denseFeatures": dense, "catFeatures": cat,
                     "label": y}))
    if mode == "gather":
        assert est.route_info["placement"] == "gather"


def _km_fit():
    x = np.random.default_rng(2).normal(size=(N_KM, 4))
    est = T.KMeans(device="cpu").set_k(4).set_max_iter(ROUNDS).set_seed(1)
    est.fit(T.Table({"features": x}))


FITS = {"widedeep": _wd_fit, "kmeans": _km_fit}


def _end(s):
    return s.t0 + s.dur


def _inside(child, parent):
    return child.t0 >= parent.t0 - EPS and _end(child) <= _end(parent) + EPS


def _in_order(spans):
    return all(_end(a) <= b.t0 + EPS for a, b in zip(spans, spans[1:]))


def _children(spans, parent, names):
    return sorted((s for s in spans if s.name in names and _inside(s, parent)),
                  key=lambda s: s.t0)


@pytest.mark.parametrize("mode", ["gather", "off", "lazy"])
def test_widedeep_fit_spans_nest_in_order(ring, mode):
    ring.enable()
    _wd_fit(mode)
    ring.disable()
    spans = ring.spans()
    (fit,) = [s for s in spans if s.name == "widedeep.fit"]
    assert all(s.cat == "train" for s in spans)
    expect = [c for c in WD_CHILDREN if mode == "gather"
              or c != "widedeep.route"]
    children = _children(spans, fit, set(WD_CHILDREN))
    assert [c.name for c in children] == expect
    assert _in_order(children)
    (epochs,) = [c for c in children if c.name == "widedeep.epochs"]
    per_epoch = _children(spans, epochs, {"iterate.epoch"})
    assert [s.ids["epoch"] for s in per_epoch] == list(range(EPOCHS))
    assert _in_order(per_epoch)
    steps = sorted((s for s in spans if s.name == "wd_step"),
                   key=lambda s: s.t0)
    assert [s.ids["step"] for s in steps] == list(range(STEPS * EPOCHS))
    for e, epoch in enumerate(per_epoch):
        mine = _children(spans, epoch, {"wd_step"})
        assert [s.ids["step"] for s in mine] == list(
            range(e * STEPS, (e + 1) * STEPS))
    parts = set(STEP_PARTS["gather"])
    for step in steps:
        got = _children(spans, step, parts)
        assert [p.name for p in got] == STEP_PARTS[mode]
        assert _in_order(got)
    assert Counter(s.name for s in spans if s.name in parts) == {
        p: STEPS * EPOCHS for p in STEP_PARTS[mode]}
    assert all(s.stream_s is None for s in spans)     # a CPU fit


def test_kmeans_fit_spans_nest_in_order(ring):
    ring.enable()
    _km_fit()
    ring.disable()
    spans = ring.spans()
    (fit,) = [s for s in spans if s.name == "kmeans.fit"]
    children = _children(spans, fit, set(KM_CHILDREN))
    assert [c.name for c in children] == KM_CHILDREN
    assert _in_order(children)
    rounds = children[KM_CHILDREN.index("kmeans.rounds")]
    per_epoch = _children(spans, rounds, {"iterate.epoch"})
    assert [s.ids["epoch"] for s in per_epoch] == list(range(ROUNDS))
    for epoch in per_epoch:
        (stats,) = _children(spans, epoch, {"kmeans.stats"})
        assert stats.ids == {"op": "plain"}
    assert sum(s.name == "kmeans.stats" for s in spans) == ROUNDS


def test_off_path_records_nothing_and_makes_no_event(ring, monkeypatch):
    made = []

    class CountedEvent:
        def __init__(self, *a, **kw):
            made.append(1)

    monkeypatch.setattr(torch.cuda, "Event", CountedEvent)
    assert not ring.recording
    assert ring.recorder() is null_span
    for fit in FITS.values():
        fit()
    assert ring.count == 0 and ring.spans() == [] and made == []
    # recording on the CPU: spans, still no event
    ring.enable()
    _wd_fit()
    assert ring.count > 0 and made == []


@pytest.mark.parametrize("fit", sorted(FITS))
def test_spans_are_profiler_annotations(ring, fit, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    assert not ring.enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert ring.recording
        FITS[fit]()
    assert not ring.recording
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = ring.spans()
    assert any(s.name == f"{fit}.fit" for s in spans)
    names = {s.name for s in spans}
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] in names]
    assert Counter(e["name"] for e in marks) == Counter(
        s.name for s in spans)
    for name in names:
        ours = sorted((s for s in spans if s.name == name),
                      key=lambda s: s.t0)
        theirs = sorted((e for e in marks if e["name"] == name),
                        key=lambda e: float(e["ts"]))
        for s, e in zip(ours, theirs):
            dur = float(e["dur"]) * 1e-6
            assert abs(s.dur - dur) <= max(0.05 * dur, 1e-3), (name, s.dur,
                                                                dur)


class _FakeEvent:
    """A finished CUDA event's two calls, counted."""

    def __init__(self, ms):
        self.ms = ms
        self.waits = 0

    def synchronize(self):
        self.waits += 1

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_stream_time_resolves_at_read_and_exports(tmp_path):
    start, end = _FakeEvent(1.0), _FakeEvent(3.5)
    s = Span("wd_step.adam", "train", 0.0, 0.01, 1, "X", {"step": 3},
             (start, end))
    assert end.waits == 0                  # nothing waited at commit
    assert s.stream_s == pytest.approx(2.5e-3)
    assert s.stream_s == pytest.approx(2.5e-3) and end.waits == 1
    assert s.as_dict()["stream_s"] == pytest.approx(2.5e-3)
    host = Span("widedeep.init", "train", 0.0, 0.01, 1, "X", {})
    assert host.stream_s is None and "stream_s" not in host.as_dict()
    private = trace_mod.SpanTracer(capacity=4).enable()
    private._commit(s)
    private._commit(host)
    path = str(tmp_path / "spans.json")
    assert private.export_chrome(path) == 2
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert events[0]["args"] == {"step": 3, "stream_s": pytest.approx(
        2.5e-3)}
    assert events[1]["args"] == {}
    assert private.export_jsonl(str(tmp_path / "spans.jsonl")) == 2
    assert os.path.getsize(str(tmp_path / "spans.jsonl")) > 0
