"""On the card only: each cell's run at a short window, and the control
(the reference in the program's place, one precision down) refused by
the cell's own check at the cell's own size.  Run with
``python -m pytest portbench/tests -m cuda`` on a machine with a card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    from portbench import calibrate

    checks = calibrate.control_checks(cell, 3_000_000_123)
    assert checks
    assert any(value > limit for _, value, limit in checks), checks


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_is_correct(cell, card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "3000000321", "--seconds", "3", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, out.stderr[-3000:]
    assert list(result)[-1] == "checks"
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert len(result["breakdown"]["device_ops"]) <= 10
    for name in ("step_mfu_pct", "device_idle_pct", "kernel_dispatches"):
        assert name in result["metrics"]
    assert os.path.isdir(os.path.join(ROOT, "portbench", ".kcache"))
