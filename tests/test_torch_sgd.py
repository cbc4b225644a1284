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
    route_w, _ = TE.sample_routing(lay.src, lay.pos, lay.mask, lay.batch)
    tupd = TS._mixed_update_ell(TL[loss], TS.SGDConfig(**config))
    got, got_loss = tupd(
        params_from_jax(params, device="cpu"), torch.from_numpy(dense),
        route_w[0], lay.src[0], lay.pos[0], lay.mask[0], lay.ovf_idx[0],
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
    assert TS.plan_mixed_impl(1 << 20, 1 << 15) == "plain"  # budget
    assert TS.plan_mixed_impl(128 * 64, 1) == "plain"  # too few rows
    assert TS._ext_len(400) == JS._ext_len(400) == 512
    assert TS._ext_len(256) == 512


def test_planning_counts_the_sample_routing():
    """The margin's routing (4 bytes per categorical slot of a step) never
    vetoes the plan: a fit at the layout budget's edge plans the kernels
    whatever its routing, which is built whole where it fits its budget
    and per chunk of steps where it does not."""
    d, n, n_cat = 1 << 20, 1 << 20, 26
    batch = TS.resolve_global_batch_size(TS.SGDConfig(), n, d)
    steps = -(-n // batch)
    assert steps * d * 12 <= TS._ELL_LAYOUT_BUDGET_BYTES < (
        (steps + 1) * d * 12)
    assert TS.plan_mixed_impl(d, steps) == "ell"
    assert TS.routing_chunk_steps(steps, batch * n_cat) == steps
    over = TS._ROUTE_BUDGET_BYTES // (4 * steps) + 1
    assert TS.routing_chunk_steps(steps, over - 1) == steps
    assert TS.routing_chunk_steps(steps, over) == steps - 1
    assert TS.routing_chunk_steps(steps, TS._ROUTE_BUDGET_BYTES) == 1


def _reference_rule(num_features, steps):
    """The JAX package's ``plan_mixed_impl`` on its accelerator, written
    out (off a TPU the function itself returns ``"xla"``)."""
    from flink_ml_tpu.ops.ell_scatter import supported

    return ("ell" if supported(num_features)
            and steps * num_features * 12 <= JS._ELL_LAYOUT_BUDGET_BYTES
            else "plain")


@pytest.mark.parametrize("n,d,n_cat,gbs", [
    (1 << 24, 1 << 17, 26, None),    # the routing past its budget
    (1 << 24, 1 << 20, 26, None),
    (1 << 20, 1 << 20, 26, None),
    (1 << 22, 1 << 16, 39, None),
    (1 << 20, 1 << 20, 26, 32),      # the layout past its budget
    (5000, 128 * 128, 26, None),
    (5000, 128 * 127, 26, None),     # too few rows
    (5000, 1000, 26, None),          # not whole 128-lane rows
    (1 << 24, 1 << 17, 26, 1 << 14),
])
def test_plan_equals_the_reference_rule(n, d, n_cat, gbs):
    """The port plans the ELL kernels exactly where the JAX package's rule
    does, at the auto batch or a given one; arithmetic only, nothing is
    allocated.  Where the whole routing outgrows its budget it is chunked,
    never vetoed."""
    cfg = TS.SGDConfig(global_batch_size=gbs)
    batch = TS.resolve_global_batch_size(cfg, n, d)
    assert batch == JS.resolve_global_batch_size(
        JS.SGDConfig(global_batch_size=gbs), n, d)
    steps = -(-n // batch)
    assert TS.plan_mixed_impl(d, steps) == _reference_rule(d, steps)
    chunk = TS.routing_chunk_steps(steps, batch * n_cat)
    assert 1 <= chunk <= steps
    assert chunk * batch * n_cat * 4 <= max(TS._ROUTE_BUDGET_BYTES,
                                            batch * n_cat * 4)
    if (n, d, n_cat, gbs) == (1 << 24, 1 << 17, 26, None):
        assert TS.plan_mixed_impl(d, steps) == "ell"
        assert steps * batch * n_cat * 4 > TS._ROUTE_BUDGET_BYTES
        assert chunk < steps


class _CountedRouting(TS._StepRouting):
    made = []

    def __init__(self, *a):
        super().__init__(*a)
        self.made.append(self)


@pytest.mark.parametrize("budget", [4, "two_steps"])
def test_chunked_routing_fit_is_bit_identical(monkeypatch, budget):
    """A fit whose routing budget is below one step's routing (chunks of
    one step), or holds two steps, rebuilds its chunks every epoch and
    ends bit for bit on the fit with the whole routing, which agrees with
    the JAX package's fit as the ELL parity test does."""
    d = 128 * 128
    dense, cat, y = _fit_data(d=d, seed=7)
    cfg = dict(learning_rate=0.5, max_epochs=3, global_batch_size=256,
               tol=0)
    steps = -(-dense.shape[0] // 256)
    monkeypatch.setattr(TS, "_StepRouting", _CountedRouting)
    _CountedRouting.made = []
    whole, whole_log = TS.sgd_fit_mixed(TL["logistic"], dense, cat, y, None,
                                        d, TS.SGDConfig(**cfg), device="cpu")
    assert _CountedRouting.made[-1].builds == 1
    per_step = 256 * cat.shape[1] * 4
    monkeypatch.setattr(TS, "_ROUTE_BUDGET_BYTES",
                        4 if budget == 4 else 2 * per_step)
    chunk = 1 if budget == 4 else 2
    got, got_log = TS.sgd_fit_mixed(TL["logistic"], dense, cat, y, None, d,
                                    TS.SGDConfig(**cfg), device="cpu")
    assert got.planned_impl == whole.planned_impl == "ell"
    assert _CountedRouting.made[-1].chunk == chunk
    assert _CountedRouting.made[-1].builds == 3 * -(-steps // chunk)
    np.testing.assert_array_equal(got.coefficients, whole.coefficients)
    assert got.intercept == whole.intercept
    assert got_log == whole_log
    want, want_log = _jax_fit(monkeypatch, "ell", dense, cat, y, d, cfg)
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               atol=1e-5)
    np.testing.assert_allclose(got.intercept, want.intercept, atol=1e-5)
    np.testing.assert_allclose(got_log, want_log, atol=1e-6)


def test_fit_auto_batch_matches_jax(monkeypatch):
    """A default-config fit at n = d = 2^20 with 26 categorical slots runs
    the JAX package's auto batch and plans the kernels: the fit is
    stopped once it has planned, before any layout is built."""
    n, d, n_cat = 1 << 20, 1 << 20, 26
    seen = {}

    class Planned(Exception):
        pass

    real_plan = TS.plan_mixed_impl

    def stop(num_features, steps):
        seen["plan"] = (steps, real_plan(num_features, steps))
        raise Planned

    monkeypatch.setattr(TS, "plan_mixed_impl", stop)
    with pytest.raises(Planned):
        TS.sgd_fit_mixed(TL["logistic"], np.zeros((n, 1), np.float32),
                         np.zeros((n, n_cat), np.int32),
                         np.zeros(n, np.float32), None, d, TS.SGDConfig(),
                         device="cpu")
    jbatch = JS.resolve_global_batch_size(JS.SGDConfig(), n, d)
    steps, impl = seen["plan"]
    assert steps == -(-n // jbatch)
    assert steps * d * 12 <= JS._ELL_LAYOUT_BUDGET_BYTES
    assert impl == "ell"
