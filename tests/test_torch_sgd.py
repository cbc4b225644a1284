"""The port's SGD trainer (``flink_ml_tpu_torch/models/common/sgd.py``)
against the JAX package's on the same seeded inputs: one ELL step from the
same weights, and whole fits on a one-device CPU mesh."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu.models.common import sgd as JS
from flink_ml_tpu.models.common.losses import LOSSES as JL
from flink_ml_tpu.ops.ell_scatter import ell_layout as j_ell_layout
from flink_ml_tpu.parallel.mesh import device_mesh
from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES as TL
from flink_ml_tpu_torch.ops import ell_scatter as TE
from flink_ml_tpu_torch.utils.convert import params_from_jax

_CFGS = {
    "plain": dict(learning_rate=0.4, tol=0),
    "elastic": dict(learning_rate=0.4, reg=0.05, elastic_net=0.3, tol=0),
    "l2": dict(learning_rate=0.4, reg=0.02, tol=0),
}


def _step_data(d, seed=3, batch=400, nnz=6, nd=13):
    """One batch with a heavy index (2*batch slots) and an overflowing
    table row, so every leg of the ELL step runs."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(batch, nd)).astype(np.float32)
    cat = rng.integers(nd, d, size=(1, batch, nnz)).astype(np.int32)
    cat[0, :, 0] = 777
    cat[0, :, 1] = 777
    cat[0, :, 2] = 128 * 5 + np.arange(batch) % 3
    y = rng.integers(0, 2, size=batch).astype(np.float32)
    wb = np.ones(batch, np.float32)
    wb[-7:] = 0.0                      # padding rows
    params = {"w": rng.normal(size=d).astype(np.float32),
              "b": np.float32(0.1)}
    return dense, cat, y, wb, params


@pytest.mark.parametrize("d", [128 * 128, 128 * 129],
                         ids=["fused", "pair"])
@pytest.mark.parametrize("cfg", sorted(_CFGS))
@pytest.mark.parametrize("loss", ["logistic", "hinge", "squared"])
def test_ell_step_matches_jax(d, cfg, loss):
    dense, cat, y, wb, params = _step_data(d)
    config = dict(_CFGS[cfg])
    jlay = j_ell_layout(cat, d, device=False)
    jupd = JS._mixed_update_ell(JL[loss], JS.SGDConfig(**config),
                                backend="xla")
    want, want_loss = jupd(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(dense),
        *(jnp.asarray(getattr(jlay, f)[0]) for f in (
            "src", "pos", "mask", "ovf_idx", "ovf_src", "heavy_idx",
            "heavy_cnt")),
        jnp.asarray(y), jnp.asarray(wb))

    lay = TE.ell_layout(cat, d).to("cpu")
    assert int(lay.need_heavy.max()) >= 1 and int(lay.need_ovf.max()) >= 1
    tupd = TS._mixed_update_ell(TL[loss], TS.SGDConfig(**config))
    got, got_loss = tupd(
        params_from_jax(params, device="cpu"), torch.from_numpy(dense),
        lay.src[0], lay.pos[0], lay.mask[0], lay.ovf_idx[0],
        lay.ovf_src[0], lay.heavy_idx[0], lay.heavy_cnt[0],
        torch.from_numpy(y), torch.from_numpy(wb))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               atol=1e-5)
    np.testing.assert_allclose(got["b"].item(), float(want["b"]), rtol=1e-5)


def _fit_data(n=1200, nd=13, nc=26, d=128 * 128, seed=0):
    """Criteo-shaped rows: marker slot 0 in {16, 17} drives the label."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, nd)).astype(np.float32)
    cat = rng.integers(32, d, size=(n, nc)).astype(np.int32)
    y = rng.integers(0, 2, size=n).astype(np.float64)
    cat[:, 0] = np.where(y == 1, 16, 17)
    return dense, cat, y


def _jax_fit(monkeypatch, impl, dense, cat, y, d, cfg, weights=None):
    if impl is not None:
        monkeypatch.setattr(JS, "plan_mixed_impl", lambda *a, **k: impl)
    mesh1 = device_mesh({"data": 1}, devices=jax.devices()[:1])
    return JS.sgd_fit_mixed(JL["logistic"], dense, cat, y, weights, d,
                            JS.SGDConfig(**cfg), mesh=mesh1)


@pytest.mark.parametrize("cfg", [
    dict(learning_rate=0.5, max_epochs=3, global_batch_size=400, tol=0),
    dict(learning_rate=0.3, max_epochs=2, global_batch_size=256, tol=0,
         reg=0.01, elastic_net=0.5, seed=5),
], ids=["plain", "elastic"])
def test_fit_matches_jax_ell_plan(monkeypatch, cfg):
    d = 128 * 128
    dense, cat, y = _fit_data(d=d)
    want, want_log = _jax_fit(monkeypatch, "ell", dense, cat, y, d, cfg)
    assert want.planned_impl == "ell"
    got, got_log = TS.sgd_fit_mixed(TL["logistic"], dense, cat, y, None, d,
                                    TS.SGDConfig(**cfg), device="cpu")
    assert got.planned_impl == "ell"
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               atol=1e-5)
    np.testing.assert_allclose(got.intercept, want.intercept, atol=1e-5)
    np.testing.assert_allclose(got_log, want_log, atol=1e-6)
    assert got_log[-1] < got_log[0]


def test_fit_matches_jax_xla_plan(monkeypatch):
    """Unpatched, the JAX planner takes its XLA gather/scatter path on the
    CPU; the port's ELL fit agrees with it too."""
    d = 128 * 128
    dense, cat, y = _fit_data(d=d, seed=1)
    weights = np.random.default_rng(2).uniform(0.5, 2.0, size=y.shape)
    cfg = dict(learning_rate=0.5, max_epochs=3, global_batch_size=400,
               tol=0)
    want, want_log = _jax_fit(monkeypatch, None, dense, cat, y, d, cfg,
                              weights)
    assert want.planned_impl == "xla"
    got, got_log = TS.sgd_fit_mixed(TL["logistic"], dense, cat, y, weights,
                                    d, TS.SGDConfig(**cfg), device="cpu")
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               atol=1e-5)
    np.testing.assert_allclose(got_log, want_log, atol=1e-6)


def test_unsupported_width_takes_plain_path(monkeypatch):
    d = 1000                            # not a whole number of 128-lane rows
    dense, cat, y = _fit_data(d=d, seed=3)
    cfg = dict(learning_rate=0.5, max_epochs=2, global_batch_size=300,
               tol=0)
    want, want_log = _jax_fit(monkeypatch, None, dense, cat, y, d, cfg)
    got, got_log = TS.sgd_fit_mixed(TL["logistic"], dense, cat, y, None, d,
                                    TS.SGDConfig(**cfg), device="cpu")
    assert got.planned_impl == "plain"
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               atol=1e-5)
    np.testing.assert_allclose(got_log, want_log, atol=1e-6)


def test_tol_stops_at_the_same_epoch(monkeypatch):
    d = 128 * 128
    dense, cat, y = _fit_data(n=800, d=d, seed=4)
    cfg = dict(learning_rate=0.5, max_epochs=20, global_batch_size=400,
               tol=0.02)
    _, want_log = _jax_fit(monkeypatch, "ell", dense, cat, y, d, cfg)
    _, got_log = TS.sgd_fit_mixed(TL["logistic"], dense, cat, y, None, d,
                                  TS.SGDConfig(**cfg), device="cpu")
    assert 1 < len(got_log) == len(want_log) < 20


def test_planning_matches_jax():
    for n, d, gbs in ((1 << 20, 1 << 20, None), (5000, 128 * 128, None),
                      (5000, 1 << 20, 2048)):
        jcfg = JS.SGDConfig(global_batch_size=gbs)
        tcfg = TS.SGDConfig(global_batch_size=gbs)
        assert (TS.resolve_global_batch_size(tcfg, n, d)
                == JS.resolve_global_batch_size(jcfg, n, d))
    steps, batch, perm = TS.plan_epoch_layout(1000, 300, 1, 7)
    jsteps, jbatch, jperm = JS.plan_epoch_layout(1000, 300, 1, 7)
    assert (steps, batch) == (jsteps, jbatch)
    np.testing.assert_array_equal(perm, jperm)
    assert TS.plan_mixed_impl(1 << 20, 32) == "ell"
    assert TS.plan_mixed_impl(1 << 20, 1 << 15) == "plain"  # over budget
    assert TS.plan_mixed_impl(128 * 64) == "plain"          # too few rows
    assert TS._ext_len(400) == JS._ext_len(400) == 512
    assert TS._ext_len(256) == 512
