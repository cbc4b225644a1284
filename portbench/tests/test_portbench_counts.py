"""The operations and bytes the readers count, against hand counts, and
the interval arithmetic of the trace reader."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import harness, peaks, profiling


def load(name):
    return harness.load_reader(name)


def test_adam_bytes_a_value():
    adam = load("adam_roofline_pct")
    shapes = {"emb": (10, 4), "wide_b": (), "mlp": [{"w": (3, 2),
                                                      "b": (2,)}]}
    assert adam.values(shapes) == 40 + 1 + 6 + 2
    assert adam.bound_s(shapes) == pytest.approx(28 * 49 / 3.35e12)


def test_widedeep_counts_at_the_cell_widths():
    spec = harness.load_spec(ROOT, "wd_criteo.fit")
    job = harness.Run(spec, 1, 1.0, False, torch.device("cpu")).job
    # 845 = 13 + 26 x 32; 845x1024 + 1024x512 + 512x256 + 256x1
    assert job.deep_in() == 845
    assert job.mlp_weights() == 865280 + 524288 + 131072 + 256 == 1520896
    assert job.rows_per_epoch() == 1 << 20
    assert job.flops_per_fit() == 6 * 1520896 * (1 << 20) * 8
    shapes = job.param_shapes()
    assert shapes["emb"] == (1048554, 32) and shapes["wide_cat"] == (1048554,)
    values = load("adam_roofline_pct").values(shapes)
    assert values == 1048554 * 33 + 13 + 1 + 1520896 + 1024 + 512 + 256 + 1


def test_kmeans_counts_at_the_cell_shape():
    stats = load("stats_roofline_pct")
    n, d, k = 1_000_000, 128, 4096
    assert stats.flops(n, d, k) == 2 * n * k * d
    assert stats.nbytes(n, d, k) == 4 * (n * d + 2 * k * d + k)
    # 1.048576e12 operations at 495 TFLOP/s outweigh 516 MB at 3.35 TB/s
    assert peaks.roofline_s(stats.flops(n, d, k), stats.nbytes(n, d, k)) \
        == pytest.approx(2 * n * k * d / 495e12)
    spec = harness.load_spec(ROOT, "kmeans_sift1m.fit")
    job = harness.Run(spec, 1, 1.0, False, torch.device("cpu")).job
    assert job.flops_per_fit() == 20 * 2 * n * k * d


def test_union_of_intervals():
    total, s, e = profiling.union_us(np.array([5.0, 0.0, 1.0, 10.0]),
                                     np.array([6.0, 2.0, 3.0, 10.5]))
    assert total == pytest.approx(1.0 + 3.0 + 0.5)
    assert list(s) == [0.0, 5.0, 10.0] and list(e) == [3.0, 6.0, 10.5]


def test_summary_of_a_trace():
    ev = [
        {"name": profiling.SPAN, "cat": "user_annotation", "ts": 0,
         "dur": 1000},
        {"name": "k1", "cat": "kernel", "ts": 100, "dur": 200},
        {"name": "k2", "cat": "kernel", "ts": 250, "dur": 150},
        {"name": "copy", "cat": "gpu_memcpy", "ts": 900, "dur": 200},
        {"name": "widedeep.emb_grad_route", "cat": "user_annotation",
         "ts": 400, "dur": 500},
        {"name": "aten::mm", "cat": "cpu_op", "ts": 850, "dur": 40},
    ]
    out = profiling.summarize(ev)
    # busy: [100, 400] and [900, 1000] (clipped to the span)
    assert out["busy_s"] == pytest.approx(400e-6)
    assert out["span_s"] == pytest.approx(1000e-6)
    assert dict(out["device_ops"]) == pytest.approx(
        {"k1": 200e-6, "k2": 150e-6, "copy": 100e-6})
    idle = dict(out["idle_gaps"])
    assert idle["widedeep.emb_grad_route"] == pytest.approx(500e-6)
    assert idle[profiling.NO_OP] == pytest.approx(100e-6)


def test_idle_share_reader():
    class R:
        profile = {"busy_s": 3.0, "span_s": 4.0}

    assert load("device_idle_pct").read(R()) == pytest.approx(25.0)
    R.profile = None
    assert load("device_idle_pct").read(R()) is None


def test_traffic_limits_name_numbers_of_their_job():
    for cell in ("wd_criteo.fit", "kmeans_sift1m.fit"):
        with open(os.path.join(ROOT, "portbench", "workloads",
                               cell + ".json")) as f:
            limits = json.load(f)["limits"]
        assert limits and all(0 < v < 10 for v in limits.values())
