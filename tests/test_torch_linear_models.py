"""The port's linear estimators (``flink_ml_tpu_torch.models``) against the
JAX package's on a mixed dense + hashed Table: fit, transform, save and
load, and a model directory saved by the JAX package loaded by the port."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax

import flink_ml_tpu as J
import flink_ml_tpu.models as JM
import flink_ml_tpu_torch as T
from flink_ml_tpu.parallel.mesh import device_mesh, use_mesh
from flink_ml_tpu_torch.utils.convert import model_from_jax_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 128 * 128
_ESTIMATORS = ["LogisticRegression", "LinearRegression", "LinearSVC"]


def _columns(n=960, nd=13, nc=26, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, nd)).astype(np.float32)
    cat = rng.integers(32, D, size=(n, nc)).astype(np.int32)
    y = rng.integers(0, 2, size=n).astype(np.float64)
    cat[:, 0] = np.where(y == 1, 16, 17)
    return {"features_dense": dense, "features_indices": cat, "label": y}


def _configure(est, gbs=320):
    return (est.set_num_features(D).set_global_batch_size(gbs)
            .set_max_iter(3).set_tol(0).set_learning_rate(0.3))


def _jax_fit(name, cols):
    with use_mesh(device_mesh({"data": 1}, devices=jax.devices()[:1])):
        return _configure(getattr(JM, name)()).fit(J.Table(cols))


def _assert_same_outputs(name, jmodel, tmodel, test):
    """Classifier predictions equal; raw predictions (and a regressor's
    predictions, which are its margins) within f32 rounding."""
    (jout,) = jmodel.transform(J.Table(test))
    (tout,) = tmodel.transform(T.Table(test))
    if name == "LinearRegression":
        np.testing.assert_allclose(tout["prediction"], jout["prediction"],
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(tout["prediction"], jout["prediction"])
    np.testing.assert_allclose(tout["rawPrediction"], jout["rawPrediction"],
                               atol=1e-5)


@pytest.mark.parametrize("name", _ESTIMATORS)
def test_estimator_fit_transform_matches_jax(name):
    cols = _columns()
    jmodel = _jax_fit(name, cols)
    tmodel = _configure(getattr(T, name)(device="cpu")).fit(T.Table(cols))
    assert tmodel.planned_impl == "ell"
    # the hinge's kink amplifies f32 summation-order differences a little
    np.testing.assert_allclose(tmodel.loss_log, jmodel.loss_log, atol=1e-5)
    _assert_same_outputs(name, jmodel, tmodel, _columns(n=300, seed=1))


@pytest.mark.parametrize("name", _ESTIMATORS)
def test_transform_from_jax_weights_matches_jax(name):
    """Both packages scoring the same weights, carried over by
    ``model_from_jax_state``."""
    rng = np.random.default_rng(3)
    coef, icpt = rng.normal(size=D), 0.25
    jmodel = getattr(JM, name + "Model")().set_model_data(J.Table({
        "coefficients": coef[None, :], "intercept": np.array([icpt])}))
    tmodel = model_from_jax_state(coef, icpt, getattr(T, name + "Model"),
                                  device="cpu")
    _assert_same_outputs(name, jmodel, tmodel, _columns(n=257, seed=4))


def test_save_load_and_pipeline_roundtrip(tmp_path):
    cols = _columns(seed=5)
    est = _configure(T.LogisticRegression(device="cpu"))
    model = T.Pipeline([est]).fit(T.Table(cols))
    (want,) = model.transform(T.Table(cols))
    model.save(str(tmp_path / "pm"))
    loaded = T.PipelineModel.load(str(tmp_path / "pm"))
    for stage in loaded.stages:
        stage.device = "cpu"
    (got,) = loaded.transform(T.Table(cols))
    np.testing.assert_array_equal(got["rawPrediction"], want["rawPrediction"])
    est.save(str(tmp_path / "est"))
    est2 = T.LogisticRegression.load(str(tmp_path / "est"), device="cpu")
    assert est2.get_global_batch_size() == 320 and est2.device == "cpu"


def test_jax_saved_model_loads_without_jax(tmp_path):
    cols = _columns(seed=6)
    jmodel = _jax_fit("LogisticRegression", cols)
    path = str(tmp_path / "jax_lr")
    jmodel.save(path)
    test = _columns(n=100, seed=7)
    np.savez(str(tmp_path / "test.npz"), **test)
    (jout,) = jmodel.transform(J.Table(test))
    script = f"""
import sys
import numpy as np
from flink_ml_tpu_torch import LogisticRegressionModel, Table
m = LogisticRegressionModel.load({path!r}, device="cpu")
cols = dict(np.load({str(tmp_path / 'test.npz')!r}))
(out,) = m.transform(Table(cols))
np.save({str(tmp_path / 'raw.npy')!r}, out["rawPrediction"])
bad = [k for k in sys.modules
       if k == "jax" or k.startswith("jax.") or k == "flink_ml_tpu"
       or k.startswith("flink_ml_tpu.")]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", script], check=True, env=env,
                   cwd=str(tmp_path), timeout=300)
    np.testing.assert_allclose(np.load(str(tmp_path / "raw.npy")),
                               jout["rawPrediction"], atol=1e-5)


def test_unported_layouts_raise():
    rng = np.random.default_rng(8)
    dense_table = T.Table({"features": rng.normal(size=(16, 3)),
                           "label": np.zeros(16)})
    with pytest.raises(NotImplementedError, match="queue A2"):
        T.LogisticRegression(device="cpu").set_num_features(3).fit(
            dense_table)
    model = model_from_jax_state(np.zeros(3), 0.0,
                                 T.LogisticRegressionModel, device="cpu")
    with pytest.raises(NotImplementedError, match="queue A2"):
        model.transform(dense_table)
    with pytest.raises(ValueError, match="numFeatures"):
        T.LogisticRegression(device="cpu").fit(T.Table(_columns(n=32)))
