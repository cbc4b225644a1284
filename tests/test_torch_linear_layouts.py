"""The port's linear family on the dense and sparse feature layouts
(``flink_ml_tpu_torch``) against the JAX package on the same seeded
inputs: the sparse (indices, values) fit through the ELL value paths and
the direct gather/scatter, the dense fit with a vector and a matrix
``w``, the estimators on ``SparseVector``, pair and dense columns,
SoftmaxRegression, models carried across packages, and
``ell_layout_device``.

Tolerances: weights within atol 1e-5 and loss logs within atol 1e-6 of
the JAX fit (f32 summation order only), as ``tests/test_torch_sgd.py``
holds the mixed fit; predicted probabilities and margins within 1e-5;
device layouts field for field equal (f32 value sums within 1e-6)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flink_ml_tpu as J
import flink_ml_tpu.models as JM
import flink_ml_tpu_torch as T
from flink_ml_tpu.models.classification import softmaxregression as JSM
from flink_ml_tpu.models.common import sgd as JS
from flink_ml_tpu.models.common.losses import LOSSES as JL
from flink_ml_tpu.ops.ell_scatter import ell_layout as j_ell_layout
from flink_ml_tpu.ops.ell_scatter import ell_layout_device as j_layout_device
from flink_ml_tpu.parallel.mesh import device_mesh, use_mesh
from flink_ml_tpu_torch.models.classification import softmaxregression as TSM
from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES as TL
from flink_ml_tpu_torch.ops import ell_scatter as TE
from flink_ml_tpu_torch.utils.convert import (model_from_jax_state,
                                              softmax_model_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 128 * 128
_ESTIMATORS = ["LogisticRegression", "LinearRegression", "LinearSVC"]
_CFGS = {
    "plain": dict(learning_rate=0.4, max_epochs=3, tol=0),
    "elastic": dict(learning_rate=0.3, max_epochs=2, tol=0, reg=0.02,
                    elastic_net=0.4, seed=5),
    "weighted": dict(learning_rate=0.4, max_epochs=3, tol=0, reg=0.01),
}


def _mesh1():
    return device_mesh({"data": 1}, devices=jax.devices()[:1])


def _pair_rows(n=1200, d=D, seed=0):
    """The bench's pair encoding of Criteo-shaped rows
    (``bench.py:100-130``): indices 0-12 carry 13 N(0,1) dense values,
    the 26 hashed slots carry 1.0, marker slot 13 in {16, 17} drives the
    label.  At batch 600 the 13 dense indices are heavy (600 > 512 slots
    a step, f32 value sums) and the two markers overflow table row 0."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 13)).astype(np.float32)
    cat = rng.integers(32, d, size=(n, 26)).astype(np.int32)
    y = rng.integers(0, 2, size=n).astype(np.float64)
    cat[:, 0] = np.where(y == 1, 16, 17)
    idx = np.concatenate([np.broadcast_to(np.arange(13, dtype=np.int32),
                                          (n, 13)), cat], axis=1)
    vals = np.concatenate([dense, np.ones((n, 26), np.float32)], axis=1)
    return idx, vals, y


def _random_rows(n=1000, d=D, nnz=9, seed=1):
    """N(0,1) values on every slot; slot 0 is index 777 in every row (a
    heavy hitter at batch >= 513) and slot 1 crowds table row 5."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, nnz)).astype(np.int32)
    idx[:, 0] = 777
    idx[:, 1] = 128 * 5 + np.arange(n) % 3
    vals = rng.normal(size=(n, nnz)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float64)
    return idx, vals, y


def _jax_sparse(monkeypatch, impl, loss, idx, vals, y, w, d, cfg):
    if impl is not None:
        monkeypatch.setattr(JS, "plan_mixed_impl", lambda *a, **k: impl)
    return JS.sgd_fit_sparse(JL[loss], idx, vals, y, w, d,
                             JS.SGDConfig(**cfg), mesh=_mesh1())


def _assert_fit_close(got, got_log, want, want_log):
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               atol=1e-5)
    np.testing.assert_allclose(got.intercept, want.intercept, atol=1e-5)
    np.testing.assert_allclose(got_log, want_log, atol=1e-6)


@pytest.mark.parametrize("jax_impl", ["ell", "xla"])
@pytest.mark.parametrize("cfg", sorted(_CFGS))
@pytest.mark.parametrize("rows", ["pair", "random"])
def test_sparse_fit_matches_jax(monkeypatch, rows, cfg, jax_impl):
    """The port's sparse fit plans the ELL value paths by shape; it agrees
    with the JAX fit planned "ell" (forced: off a TPU the JAX rule plans
    "xla") and with the JAX fit on its direct scatter."""
    idx, vals, y = (_pair_rows() if rows == "pair" else _random_rows())
    n = len(y)
    weights = (np.random.default_rng(2).uniform(0.5, 2.0, size=n)
               if cfg == "weighted" else None)
    config = dict(_CFGS[cfg], global_batch_size=600)
    want, want_log = _jax_sparse(monkeypatch, None if jax_impl == "xla"
                                 else "ell", "logistic", idx, vals, y,
                                 weights, D, config)
    assert want.planned_impl == jax_impl
    got, got_log = TS.sgd_fit_sparse(TL["logistic"], idx, vals, y, weights,
                                     D, TS.SGDConfig(**config), device="cpu")
    assert got.planned_impl == "ell"
    _assert_fit_close(got, got_log, want, want_log)
    assert got_log[-1] < got_log[0]


def test_sparse_fit_layout_reaches_every_leg():
    """The pair rows at batch 600 route through all three legs of the
    value layout: in-grid slots, overflow and heavy value sums."""
    idx, vals, y = _pair_rows()
    perm = np.random.default_rng(0).permutation(len(y))
    lay = TE.ell_layout(TS.prepare_epoch_tensor(idx, perm, 2, 600), D,
                        values=TS.prepare_epoch_tensor(vals, perm, 2, 600))
    assert lay.heavy_cnt.dtype == np.float32
    assert int(lay.need_heavy.min()) == 13 and int(lay.need_ovf.min()) > 0
    np.testing.assert_array_equal(np.sort(lay.heavy_idx[0]), np.arange(13))


@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_sparse_fit_off_the_kernel_plan_matches_jax(monkeypatch, loss):
    """A width that does not tile into 128-lane rows plans the direct
    gather/scatter ("plain"), as the JAX package plans "xla"."""
    d = 1000
    idx, vals, y = _random_rows(d=d, seed=3)
    cfg = dict(learning_rate=0.2, max_epochs=3, global_batch_size=256,
               tol=0, reg=0.02, elastic_net=0.5)
    want, want_log = _jax_sparse(monkeypatch, None, loss, idx, vals, y,
                                 None, d, cfg)
    got, got_log = TS.sgd_fit_sparse(TL[loss], idx, vals, y, None, d,
                                     TS.SGDConfig(**cfg), device="cpu")
    assert got.planned_impl == "plain" and want.planned_impl == "xla"
    _assert_fit_close(got, got_log, want, want_log)


def test_sparse_ell_step_matches_jax():
    """One ELL step of the value layout from the same weights."""
    idx, vals, y = _random_rows(n=600, seed=4)
    cat, v = idx[None], vals[None]
    wb = np.ones(600, np.float32)
    wb[-9:] = 0.0
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=D).astype(np.float32),
              "b": np.float32(-0.2)}
    config = dict(learning_rate=0.4, reg=0.05, elastic_net=0.3, tol=0)
    jlay = j_ell_layout(cat, D, values=v, device=False)
    jupd = JS._sparse_update_ell(JL["logistic"], JS.SGDConfig(**config),
                                 backend="xla")
    want, want_loss = jupd(
        {k: jnp.asarray(a) for k, a in params.items()},
        *(jnp.asarray(getattr(jlay, f)[0]) for f in (
            "src", "pos", "mask", "val", "ovf_idx", "ovf_src", "ovf_val",
            "heavy_idx", "heavy_cnt")),
        jnp.asarray(y, jnp.float32), jnp.asarray(wb))
    lay = TE.ell_layout(cat, D, values=v).to("cpu")
    assert int(lay.need_heavy[0]) == 1 and int(lay.need_ovf[0]) > 0
    route = TS._StepRouting(lay, 600, 1)
    tupd = TS._sparse_update_ell(TL["logistic"], TS.SGDConfig(**config))
    got, got_loss = tupd(
        {k: torch.as_tensor(a) for k, a in params.items()}, route[0],
        *(getattr(lay, f)[0] for f in (
            "src", "pos", "mask", "val", "ovf_idx", "ovf_src", "ovf_val",
            "heavy_idx", "heavy_cnt")),
        torch.as_tensor(y, dtype=torch.float32), torch.from_numpy(wb))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               atol=1e-5)
    np.testing.assert_allclose(got["b"].item(), float(want["b"]), rtol=1e-5)


def test_sparse_planning_matches_jax():
    """The sparse fit sizes its auto batch and plans with 16 bytes a slot
    a step, as the JAX package does; with values a routing entry takes 8
    bytes."""
    for n, d in ((1 << 20, 1 << 20), (5000, D), (1 << 22, 1 << 17)):
        assert (TS.resolve_global_batch_size(TS.SGDConfig(), n, d, 16)
                == JS.resolve_global_batch_size(JS.SGDConfig(), n, d, 16))
    assert TS.plan_mixed_impl(1 << 20, 128, 16) == "ell"
    assert TS.plan_mixed_impl(1 << 20, 129, 16) == "plain"
    per = TS._ROUTE_BUDGET_BYTES // 8
    assert TS.routing_chunk_steps(9, per, entry_bytes=8) == 1
    assert TS.routing_chunk_steps(9, per // 3, entry_bytes=8) == 3


def test_sparse_routing_chunks_carry_values(monkeypatch):
    """Built per chunk of steps, the routing hands each step its
    (route_w, route_val) pair; the fit ends bit for bit on the
    whole-routing fit."""
    idx, vals, y = _random_rows(n=1200, seed=6)
    cfg = TS.SGDConfig(learning_rate=0.3, max_epochs=2, tol=0,
                       global_batch_size=300)
    whole, whole_log = TS.sgd_fit_sparse(TL["logistic"], idx, vals, y, None,
                                         D, cfg, device="cpu")
    monkeypatch.setattr(TS, "_ROUTE_BUDGET_BYTES", 300 * 9 * 8)
    got, got_log = TS.sgd_fit_sparse(TL["logistic"], idx, vals, y, None, D,
                                     cfg, device="cpu")
    np.testing.assert_array_equal(got.coefficients, whole.coefficients)
    assert got_log == whole_log


def _dense_rows(n=900, d=7, seed=11, classes=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if classes:
        y = np.argmax(X[:, :classes] + 0.3 * rng.normal(size=(n, classes)),
                      axis=1).astype(np.float64)
    else:
        y = (X @ rng.normal(size=d) + 0.2 * rng.normal(size=n) > 0).astype(
            np.float64)
    return X, y


@pytest.mark.parametrize("cfg", sorted(_CFGS))
@pytest.mark.parametrize("loss", ["logistic", "squared", "hinge"])
def test_dense_fit_matches_jax(loss, cfg):
    """Vector ``w``: the autograd step with the l2 term in the gradient
    (the elastic case tells it apart from a decay before the step)."""
    X, y = _dense_rows()
    weights = (np.random.default_rng(3).uniform(0.5, 2.0, size=len(y))
               if cfg == "weighted" else None)
    config = dict(_CFGS[cfg], global_batch_size=64)
    want, want_log = JS.sgd_fit(JL[loss], X, y, weights,
                                JS.SGDConfig(**config), mesh=_mesh1())
    got, got_log = TS.sgd_fit(TL[loss], X, y, weights,
                              TS.SGDConfig(**config), device="cpu")
    assert got.planned_impl == want.planned_impl == "dense"
    _assert_fit_close(got, got_log, want, want_log)


def test_dense_fit_auto_batch_and_tol_match_jax():
    """Auto batch (32) and the tol rule stop both fits at the same
    epoch."""
    X, y = _dense_rows(n=640, seed=12)
    config = dict(learning_rate=0.1, max_epochs=20, tol=0.02)
    want, want_log = JS.sgd_fit(JL["logistic"], X, y, None,
                                JS.SGDConfig(**config), mesh=_mesh1())
    got, got_log = TS.sgd_fit(TL["logistic"], X, y, None,
                              TS.SGDConfig(**config), device="cpu")
    assert 1 < len(got_log) == len(want_log) < 20
    _assert_fit_close(got, got_log, want, want_log)


@pytest.mark.parametrize("cfg", ["plain", "weighted"])
def test_matrix_fit_matches_jax(cfg):
    """``(d, classes)`` matrix ``w`` with the softmax cross-entropy."""
    X, y = _dense_rows(classes=4, seed=13)
    d, c = X.shape[1], 4
    weights = (np.random.default_rng(4).uniform(0.5, 2.0, size=len(y))
               if cfg == "weighted" else None)
    config = dict(_CFGS[cfg], global_batch_size=50)
    want, want_log = JS.sgd_fit_params(
        JSM.softmax_xent_loss, X, y, weights, JS.SGDConfig(**config),
        mesh=_mesh1(), init_params={"w": jnp.zeros((d, c), jnp.float32),
                                    "b": jnp.zeros((c,), jnp.float32)})
    got, got_log = TS.sgd_fit_params(
        TSM.softmax_xent_loss, X, y, weights, TS.SGDConfig(**config), "cpu",
        init_params={"w": np.zeros((d, c), np.float32),
                     "b": np.zeros((c,), np.float32)})
    assert got["w"].shape == (d, c) and got["b"].shape == (c,)
    np.testing.assert_allclose(got["w"], np.asarray(want["w"]), atol=1e-5)
    np.testing.assert_allclose(got["b"], np.asarray(want["b"]), atol=1e-5)
    np.testing.assert_allclose(got_log, want_log, atol=1e-6)


def _sparse_vectors(idx, vals, d, cls):
    """A column of ``cls`` SparseVectors holding the rows' distinct
    indices (ragged: the duplicates of a row merged)."""
    col = np.empty(len(idx), dtype=object)
    for i, (ix, vx) in enumerate(zip(idx, vals)):
        u, inv = np.unique(ix, return_inverse=True)
        col[i] = cls(d, u, np.bincount(inv, weights=vx))
    return col


def _columns(layout, n, seed):
    if layout == "dense":
        X, y = _dense_rows(n=n, seed=seed)
        return {"features": X, "label": y}
    idx, vals, y = _random_rows(n=n, seed=seed)
    if layout == "pair":
        return {"features_indices": idx, "features_values": vals, "label": y}
    return {"sv": (idx, vals), "label": y}


def _tables(layout, cols):
    if layout != "sparse_vector":
        return J.Table(cols), T.Table(cols)
    idx, vals = cols["sv"]
    return (J.Table({"features": _sparse_vectors(idx, vals, D,
                                                 J.SparseVector),
                     "label": cols["label"]}),
            T.Table({"features": _sparse_vectors(idx, vals, D,
                                                 T.SparseVector),
                     "label": cols["label"]}))


def _configure(est, layout):
    est = (est.set_global_batch_size(300).set_max_iter(3).set_tol(0)
           .set_learning_rate(0.3))
    return est.set_num_features(D) if layout == "pair" else est


def _assert_same_outputs(name, jout, tout):
    if name == "LinearRegression":
        np.testing.assert_allclose(tout["prediction"], jout["prediction"],
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(tout["prediction"], jout["prediction"])
    np.testing.assert_allclose(tout["rawPrediction"], jout["rawPrediction"],
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["dense", "pair", "sparse_vector"])
@pytest.mark.parametrize("name", _ESTIMATORS)
def test_estimator_fit_transform_matches_jax(name, layout):
    jtab, ttab = _tables(layout, _columns(layout, 900, 20))
    with use_mesh(_mesh1()):
        jmodel = _configure(getattr(JM, name)(), layout).fit(jtab)
    tmodel = _configure(getattr(T, name)(device="cpu"), layout).fit(ttab)
    assert tmodel.planned_impl == ("dense" if layout == "dense" else "ell")
    np.testing.assert_allclose(tmodel.loss_log, jmodel.loss_log, atol=1e-5)
    np.testing.assert_allclose(
        tmodel.get_model_data()[0]["coefficients"],
        jmodel.get_model_data()[0]["coefficients"], atol=1e-5)
    jtest, ttest = _tables(layout, _columns(layout, 257, 21))
    (jout,) = jmodel.transform(jtest)
    (tout,) = tmodel.transform(ttest)
    _assert_same_outputs(name, jout, tout)


@pytest.mark.parametrize("layout", ["dense", "pair"])
@pytest.mark.parametrize("name", _ESTIMATORS)
def test_transform_from_jax_weights_matches_jax(name, layout):
    """Both packages scoring the same weights, carried over by
    ``model_from_jax_state``."""
    rng = np.random.default_rng(30)
    d = 7 if layout == "dense" else D
    coef, icpt = rng.normal(size=d), -0.4
    jmodel = getattr(JM, name + "Model")().set_model_data(J.Table({
        "coefficients": coef[None, :], "intercept": np.array([icpt])}))
    tmodel = model_from_jax_state(coef, icpt, getattr(T, name + "Model"),
                                  device="cpu")
    jtest, ttest = _tables(layout, _columns(layout, 300, 31))
    _assert_same_outputs(name, jmodel.transform(jtest)[0],
                         tmodel.transform(ttest)[0])


def _softmax_table(n, seed, classes=("a", "b", "c", "d")):
    X, y = _dense_rows(n=n, seed=seed, classes=len(classes))
    return X, np.asarray(classes)[y.astype(int)]


def test_softmax_regression_matches_jax():
    X, labels = _softmax_table(800, 40)
    cols = {"features": X, "label": labels}

    def configure(est):
        return (est.set_global_batch_size(64).set_max_iter(4).set_tol(0)
                .set_learning_rate(0.3).set_reg(0.01))

    with use_mesh(_mesh1()):
        jmodel = configure(JM.SoftmaxRegression()).fit(J.Table(cols))
    tmodel = configure(T.SoftmaxRegression(device="cpu")).fit(T.Table(cols))
    (jd,), (td,) = jmodel.get_model_data(), tmodel.get_model_data()
    np.testing.assert_allclose(td["coefficients"], jd["coefficients"],
                               atol=1e-5)
    np.testing.assert_allclose(td["intercepts"], jd["intercepts"],
                               atol=1e-5)
    np.testing.assert_array_equal(td["labels"], jd["labels"])
    assert len(tmodel.loss_log) == 4
    assert tmodel.loss_log[-1] < tmodel.loss_log[0]
    Xt, _ = _softmax_table(300, 41)
    (jout,) = jmodel.transform(J.Table({"features": Xt}))
    (tout,) = tmodel.transform(T.Table({"features": Xt}))
    np.testing.assert_array_equal(tout["prediction"], jout["prediction"])
    np.testing.assert_allclose(tout["rawPrediction"], jout["rawPrediction"],
                               atol=1e-5)
    carried = softmax_model_from_jax(jd["coefficients"][0],
                                     jd["intercepts"][0], jd["labels"][0],
                                     device="cpu")
    np.testing.assert_allclose(
        carried.transform(T.Table({"features": Xt}))[0]["rawPrediction"],
        jout["rawPrediction"], atol=1e-5)
    with pytest.raises(ValueError, match=">= 2 distinct"):
        T.SoftmaxRegression(device="cpu").fit(T.Table({
            "features": X[:5], "label": np.zeros(5)}))


def _run_without_jax(tmp_path, script):
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", script + """
bad = [k for k in sys.modules
       if k == "jax" or k.startswith("jax.") or k == "flink_ml_tpu"
       or k.startswith("flink_ml_tpu.")]
assert not bad, bad
"""], check=True, env=env, cwd=str(tmp_path), timeout=300)


def test_jax_saved_models_load_without_jax(tmp_path):
    """A dense LinearSVC and a SoftmaxRegression saved by the JAX package
    load and transform in the port in a process without JAX."""
    X, y = _dense_rows(n=400, seed=50)
    Xs, labels = _softmax_table(400, 51)
    with use_mesh(_mesh1()):
        svc = JM.LinearSVC().set_max_iter(2).fit(J.Table(
            {"features": X, "label": y}))
        smx = JM.SoftmaxRegression().set_max_iter(2).fit(J.Table(
            {"features": Xs, "label": labels}))
    svc.save(str(tmp_path / "svc"))
    smx.save(str(tmp_path / "smx"))
    np.save(str(tmp_path / "X.npy"), X)
    np.save(str(tmp_path / "Xs.npy"), Xs)
    _run_without_jax(tmp_path, f"""
import sys
import numpy as np
from flink_ml_tpu_torch import LinearSVCModel, SoftmaxRegressionModel, Table
svc = LinearSVCModel.load("svc", device="cpu")
smx = SoftmaxRegressionModel.load("smx", device="cpu")
(a,) = svc.transform(Table({{"features": np.load("X.npy")}}))
(b,) = smx.transform(Table({{"features": np.load("Xs.npy")}}))
np.save("svc_raw.npy", a["rawPrediction"])
np.save("smx_raw.npy", b["rawPrediction"])
np.save("smx_pred.npy", b["prediction"])
""")
    np.testing.assert_allclose(
        np.load(str(tmp_path / "svc_raw.npy")),
        svc.transform(J.Table({"features": X}))[0]["rawPrediction"],
        atol=1e-5)
    (jout,) = smx.transform(J.Table({"features": Xs}))
    np.testing.assert_allclose(np.load(str(tmp_path / "smx_raw.npy")),
                               jout["rawPrediction"], atol=1e-5)
    np.testing.assert_array_equal(np.load(str(tmp_path / "smx_pred.npy")),
                                  jout["prediction"])


def test_port_saved_softmax_model_loads_in_jax(tmp_path):
    """The port's save layout is the JAX package's: pointed at the JAX
    class, the JAX loader reads the port's files as they are."""
    X, labels = _softmax_table(300, 52)
    tmodel = T.SoftmaxRegression(device="cpu").set_max_iter(2).fit(
        T.Table({"features": X, "label": labels}))
    tmodel.save(str(tmp_path / "port"))
    meta = json.loads((tmp_path / "port" / "metadata").read_text())
    assert meta["className"] == ("flink_ml_tpu_torch.models.classification."
                                 "softmaxregression.SoftmaxRegressionModel")
    shutil.copytree(tmp_path / "port", tmp_path / "for_jax")
    meta["className"] = ("flink_ml_tpu.models.classification."
                         "softmaxregression.SoftmaxRegressionModel")
    (tmp_path / "for_jax" / "metadata").write_text(json.dumps(meta))
    jmodel = JSM.SoftmaxRegressionModel.load(str(tmp_path / "for_jax"))
    (jout,) = jmodel.transform(J.Table({"features": X}))
    (tout,) = tmodel.transform(T.Table({"features": X}))
    np.testing.assert_array_equal(tout["prediction"], jout["prediction"])
    np.testing.assert_allclose(tout["rawPrediction"], jout["rawPrediction"],
                               atol=1e-5)
    again = T.SoftmaxRegressionModel.load(str(tmp_path / "port"),
                                          device="cpu")
    np.testing.assert_array_equal(
        again.transform(T.Table({"features": X}))[0]["rawPrediction"],
        tout["rawPrediction"])


@pytest.mark.parametrize("with_values", [False, True])
def test_ell_layout_device_matches_jax(with_values):
    """Field by field against the JAX package's device builder, with a
    heavy index, a crowded table row and padding (index 0, value 0.0) as
    ``stack_sparse_vectors`` pads; and its layout scores like the host
    layout."""
    rng = np.random.default_rng(60)
    d, batch, nnz = D, 700, 6
    cat = rng.integers(0, d, size=(3, batch, nnz)).astype(np.int32)
    cat[:, :, 0] = 12345
    cat[:, :600, 1] = 777
    cat[:, :, 2] = 128 * 5 + np.arange(batch) % 3
    vals = rng.normal(size=cat.shape).astype(np.float32)
    cat[:, 100:, 5] = 0
    vals[:, 100:, 5] = 0.0
    v = vals if with_values else None
    want = j_layout_device(jnp.asarray(cat), d, ovf_cap=2048,
                           values=None if v is None else jnp.asarray(v))
    got = TE.ell_layout_device(torch.from_numpy(cat), d, ovf_cap=2048,
                               values=None if v is None
                               else torch.from_numpy(v))
    for f in ("src", "pos", "mask", "ovf_idx", "ovf_src", "heavy_idx",
              "need_ovf", "need_heavy", "val", "ovf_val", "heavy_cnt"):
        a, b = getattr(want, f), getattr(got, f)
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f == "heavy_cnt" and with_values:
            np.testing.assert_allclose(b, a, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    assert int(got.need_heavy.max()) == 3      # 12345, 777 and the pad 0
    host = TE.ell_layout(cat, d, values=v).to("cpu")
    w = torch.from_numpy(rng.normal(size=d).astype(np.float32))
    for s in range(3):
        for lay in (host, got):
            rw, rv = TE.sample_routing(lay.src[s], lay.pos[s], lay.mask[s],
                                       batch, val=None if v is None
                                       else lay.val[s])
            m = TS._ell_margin(w, batch, rw, lay.ovf_idx[s], lay.ovf_src[s],
                               lay.heavy_idx[s], lay.heavy_cnt[s],
                               route_val=rv, ovf_val=None if v is None
                               else lay.ovf_val[s])
            if lay is host:
                ref = m
        np.testing.assert_allclose(m.numpy(), ref.numpy(), atol=1e-5)


def test_ell_layout_device_capacity_errors():
    """The device builder drops slots past its static caps; the need
    records and ``assert_capacities`` make that loud (the JAX package's
    ``tests/test_ell_scatter.py`` cases)."""
    rng = np.random.default_rng(61)
    d, batch, nnz = D, 64, 4
    cat = torch.from_numpy(rng.integers(0, d, size=(2, batch, nnz)).astype(
        np.int32))
    ok = TE.ell_layout_device(cat, d, ovf_cap=1024)
    assert ok.assert_capacities() is ok
    crowded = torch.from_numpy(rng.integers(0, 128, size=(2, batch, nnz))
                               .astype(np.int32))
    need = TE.ell_layout_device(crowded, d, ovf_cap=4096)
    worst = int(need.need_ovf.max())
    assert worst >= batch * nnz - 128
    assert need.trim_overflow().ovf_idx.shape[1] < 4096
    starved = TE.ell_layout_device(crowded, d, ovf_cap=worst - 1)
    with pytest.raises(ValueError, match="raise ovf_cap"):
        starved.assert_capacities()
    two_heavy = np.zeros((1, 600, 2), np.int32)
    two_heavy[..., 1] = 777
    starved_h = TE.ell_layout_device(torch.from_numpy(two_heavy), d,
                                     heavy_cap=1)
    with pytest.raises(ValueError, match="raise heavy_cap"):
        starved_h.assert_capacities()
    with pytest.raises(ValueError, match="must lie in"):
        TE.ell_layout_device(torch.full((1, 4, 2), d, dtype=torch.int32), d)
    with pytest.raises(ValueError, match="heavy_threshold"):
        TE.ell_layout_device(cat, d, heavy_threshold=64)
