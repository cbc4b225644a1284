"""A run's flow without a card: the result line, the refusals, and the
modules a run loads."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

import tiny
from conftest import CELLS, ROOT
from portbench import harness


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    result, run = harness.run(tiny.argv(cell), t0=time.perf_counter(),
                              require_card=False, device="cpu",
                              spec_hook=tiny.shrink)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == len(run.fit_walls) >= 1
    e2e = {m["name"] for m in run.spec["end_to_end"]}
    assert {"fit_s", "setup_s"} <= set(result["metrics"]) <= e2e
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert result["checks"] and all(
        set(c) == {"value", "limit"} for c in result["checks"].values())
    kinds = {name.split("@")[0].split(".")[0]
             for name in result["checks"]}
    limits = {key.split(".")[0] for key in run.traffic["limits"]}
    assert kinds == limits


def _python(code, cwd, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{ROOT!r}, {os.path.dirname(__file__)!r}]\n"
        "from portbench.cachedirs import configure\n"
        f"configure({str(tmp_path)!r})\n"
        "from portbench import harness\n"
        "import tiny\n"
        "harness.run(tiny.argv('wd_criteo.fit'), t0=time.perf_counter(),\n"
        "            require_card=False, device='cpu', spec_hook=tiny.shrink)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([harness.forbidden_modules(), tops]))\n")
    out = _python(code, str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    found, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == []
    assert "flink_ml_tpu_torch" in tops and "flink_ml_tpu" not in tops


def test_without_a_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", *tiny.argv("wd_criteo.fit")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmark_files_is_no_run(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".kcache", "__pycache__"))
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r},"
        f" {str(tmp_path / 'portbench' / 'tests')!r}]\n"
        "from portbench import harness\n"
        "import tiny\n"
        "print(harness.run(tiny.argv('kmeans_sift1m.fit'),\n"
        "      t0=time.perf_counter(), require_card=False, device='cpu',\n"
        f"      spec_hook=tiny.shrink, root={str(tmp_path)!r}))\n")
    out = _python(code, str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "flink_ml_tpu_torch" in out.stderr
