"""The readers of the program's spans (``portbench/spans.py``): the busy
time under each annotation of a Chrome trace, the readers on the ring of
a tiny fit recorded on the CPU, and on a ring without the spans they
read; on the card, a traced run of each cell reports every metric it
lists, and the fit's readings agree with the outside timers."""

import json
import subprocess
import sys

import pytest
import torch

import tiny
from conftest import CELLS, ROOT
from portbench import harness, spans as span_mod
from portbench.jobs.seeds import data_seed, fit_seed

READERS = ("fit_host_s", "step_device_ms", "adam_fit_roofline_pct",
           "stats_fit_roofline_pct")
#: which readers find their spans in a cell's fit
READS = {"wd_criteo.fit": {"fit_host_s", "step_device_ms",
                           "adam_fit_roofline_pct"},
         "kmeans_sift1m.fit": {"fit_host_s", "stats_fit_roofline_pct"}}
#: the KMeans cut at the stats kernel's plan (65,536 rows and more), so
#: that its rounds record ``kmeans.stats``
KMEANS_ON_B4 = {"n": 1 << 16, "d": 8, "k": 16, "max_iter": 2}


@pytest.fixture
def tracer():
    from flink_ml_tpu_torch.obs.trace import tracer

    tracer.disable()
    tracer.clear()
    yield tracer
    tracer.disable()
    tracer.clear()


def tiny_run(cell):
    spec = harness.load_spec(ROOT, cell)
    tiny.shrink(spec)
    if cell == "kmeans_sift1m.fit":
        spec["config"].update(KMEANS_ON_B4)
    run = harness.Run(spec, 5, 1.0, True, torch.device("cpu"))
    run.columns = run.job.make_inputs(data_seed(5))
    run.table = run.job.table(run.columns)
    return run


def read(name, run):
    return harness.load_reader(name).read(run)


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ph": "X", "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_busy_by_annotation_joins_device_work_to_its_launch():
    events = [
        _ev("user_annotation", "step", 0, 100),
        _ev("user_annotation", "step", 200, 100),
        _ev("user_annotation", "idle", 400, 50),
        # launched in the first step, run late and overlapping: a union
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        _ev("kernel", "a", 150, 40, corr=1),
        _ev("cuda_driver", "cuLaunchKernel", 20, 2, corr=2),
        _ev("kernel", "b", 170, 40, corr=2),
        # a copy of the second step; one launched between the steps
        _ev("cuda_runtime", "cudaMemcpyAsync", 250, 5, corr=3),
        _ev("gpu_memcpy", "Memcpy HtoD", 260, 7, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 2, corr=4),
        _ev("kernel", "c", 300, 9, corr=4),
        # a device event without its launch, and an annotation on the card
        _ev("kernel", "d", 210, 30, corr=99),
        _ev("gpu_user_annotation", "step", 150, 60),
    ]
    got = span_mod.busy_by_annotation(events)
    assert got == {"step": [pytest.approx(60e-6), pytest.approx(7e-6)],
                   "idle": [0.0]}


def test_busy_by_annotation_reads_a_profiler_trace(tracer, tmp_path):
    """The program's spans in a real (CPU) profiler trace: one number an
    instance, zero with no device event."""
    from torch.profiler import ProfilerActivity, profile

    run = tiny_run("wd_criteo.fit")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run.job.fit(run.table, fit_seed(5, 0), max_iter=1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        got = span_mod.busy_by_annotation(json.load(f)["traceEvents"])
    counts = {}
    for s in tracer.spans():
        counts[s.name] = counts.get(s.name, 0) + 1
    assert counts["wd_step"] == 8 and counts["widedeep.fit"] == 1
    for name, n in counts.items():
        assert got[name] == [0.0] * n


@pytest.mark.parametrize("cell", sorted(READS))
def test_readers_read_a_recorded_fit(tracer, cell):
    run = tiny_run(cell)
    tracer.enable()
    run.job.fit(run.table, fit_seed(5, 0))
    tracer.disable()
    spans = tracer.spans()
    fit = [s for s in spans if s.name.endswith(".fit")][0]
    (loop,) = [s for s in spans if s.name in ("widedeep.epochs",
                                              "kmeans.rounds")]
    # a CPU fit times nothing on the card: a stream time for the loop, and
    # busy times for every span (what a profiled fit gives on the card)
    loop._device = 0.5 * loop.dur
    busy = {}
    for s in spans:
        busy.setdefault(s.name, []).append(0.25 * s.dur)
    run._busy_by_span = busy
    got = {name: read(name, run) for name in READERS}
    assert {k for k, v in got.items() if v is not None} == READS[cell]
    assert got["fit_host_s"] == pytest.approx(fit.dur - 0.5 * loop.dur)
    for name in READS[cell] - {"fit_host_s"}:
        assert got[name] > 0
    if cell == "wd_criteo.fit":
        steps = busy["wd_step"]
        assert got["step_device_ms"] == pytest.approx(
            1e3 * sum(steps) / len(steps))


@pytest.mark.parametrize("cell", sorted(READS))
def test_readers_without_spans_read_nothing(tracer, cell):
    run = tiny_run(cell)
    assert all(read(name, run) is None for name in READERS)
    assert run._busy_by_span is None          # nothing was profiled
    # spans recorded, none timed on the card (a CPU fit)
    del run._busy_by_span
    tracer.enable()
    run.job.fit(run.table, fit_seed(5, 0))
    tracer.disable()
    assert all(read(name, run) is None for name in READERS)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_fit(cell, card):
    """A traced run reports every metric its cell lists; the readings
    inside the fit agree with the timers outside it."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "3000000457", "--seconds", "3", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, out.stderr[-3000:]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    listed = {x["name"] for x in harness.load_spec(ROOT, cell)["per_layer"]}
    assert listed <= set(m), listed - set(m)
    assert 0 < m["fit_host_s"] < result["device"]["window_s"]
    if cell == "kmeans_sift1m.fit":
        ratio = m["stats_fit_roofline_pct"] / m["stats_roofline_pct"]
        assert 0.9 <= ratio <= 1.1
    else:
        ratio = m["adam_fit_roofline_pct"] / m["adam_roofline_pct"]
        assert 1 / 1.5 <= ratio <= 1.5
        # the steps' busy time fits in the card's busy time of a fit
        c = harness.load_spec(ROOT, cell)["config"]
        steps = -(-int(c["rows"]) // int(c["global_batch_size"])) * int(
            c["max_iter"])
        assert 1e-3 * m["step_device_ms"] * steps <= result["device"][
            "busy_s"]
