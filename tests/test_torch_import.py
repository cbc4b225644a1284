"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points refuse to run on the CPU unless asked, and
``chip_smoke.py`` fails without a card."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import flink_ml_tpu_torch as T
from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES
from flink_ml_tpu_torch.utils.convert import params_from_jax
from flink_ml_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "flink_ml_tpu_torch")


def _forbidden(name: str) -> bool:
    # exact package names: flink_ml_tpu_torch itself starts with the
    # JAX package's name
    return name.split(".")[0] in ("jax", "jaxlib", "flink_ml_tpu")


def test_import_leaves_jax_out():
    code = ("import sys, flink_ml_tpu_torch, flink_ml_tpu_torch.utils.convert,"
            " flink_ml_tpu_torch.kernels.build; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=300).stdout.split()
    assert "flink_ml_tpu_torch" in out
    assert [m for m in out if _forbidden(m)] == []


def _py_files(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", [
    *sorted(os.path.relpath(p, REPO) for p in _py_files(PKG)),
    "chip_smoke.py"])
def test_no_jax_import_in_source(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    table = T.Table({"features_dense": rng.normal(size=(8, 2)),
                     "features_indices": rng.integers(2, 128 * 128,
                                                      size=(8, 3)),
                     "label": np.zeros(8)})
    with pytest.raises(RuntimeError, match="no GPU"):
        T.LogisticRegression().set_num_features(128 * 128).fit(table)
    with pytest.raises(RuntimeError, match="no GPU"):
        TS.sgd_fit_mixed(LOSSES["logistic"], table["features_dense"],
                         table["features_indices"], table["label"], None,
                         128 * 128, TS.SGDConfig())
    with pytest.raises(RuntimeError, match="no GPU"):
        params_from_jax({"w": np.zeros(4), "b": np.zeros(())})
    model = T.LogisticRegression(device="cpu").set_num_features(
        128 * 128).set_max_iter(1).fit(table)
    model.device = "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        model.transform(table)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; chip_smoke.py runs for real")
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
