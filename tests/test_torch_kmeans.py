"""The port's KMeans (``flink_ml_tpu_torch.models.clustering.kmeans``) against
the JAX package's on seeded numpy data: the BSP fit below and at the kernel
threshold, the kernel body, the workset fit and body, transform, save and
load, and the weights carried across.  The port runs on the CPU (its
kernel wrappers take their plain versions there); the JAX package on its
CPU XLA body, or its Pallas body in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu.distance import DistanceMeasure as JDistance
from flink_ml_tpu.models.clustering import kmeans as JKM
from flink_ml_tpu.parallel.mesh import device_mesh, use_mesh
from flink_ml_tpu_torch.distance import DistanceMeasure as TDistance
from flink_ml_tpu_torch.iteration import (FnListener, IterationBodyResult,
                                          IterationConfig, iterate)
from flink_ml_tpu_torch.models.clustering import kmeans as TKM
from flink_ml_tpu_torch.utils.convert import kmeans_model_from_jax

# BASELINE.md:22, the fixture of KMeansTest.java:58-66
SIX = np.array([[0.0, 0.0], [0.0, 0.3], [0.3, 0.0],
                [9.0, 0.0], [9.0, 0.6], [9.6, 0.0]])
EXPECTED = {
    frozenset({(0.0, 0.0), (0.0, 0.3), (0.3, 0.0)}),
    frozenset({(9.0, 0.0), (9.0, 0.6), (9.6, 0.0)}),
}


def _blobs(n, d=16, k=5, seed=0, spread=8.0, noise=0.4):
    """``tests/test_kmeans.py::_blob_table``'s data."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * spread
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(size=(n, d)) * noise).astype(
        np.float32)


def _one_device():
    return use_mesh(device_mesh({"data": 1}, devices=jax.devices()[:1]))


def _jax_fit(X, k, max_iter=20, seed=7, workset=False, measure="euclidean"):
    est = (JKM.KMeans().set_k(k).set_max_iter(max_iter).set_seed(seed)
           .set_workset(workset).set_distance_measure(measure))
    with _one_device():
        return est, est.fit(J.Table({"features": X}))


def _port_fit(X, k, max_iter=20, seed=7, workset=False, tie="first",
              measure="euclidean"):
    est = (T.KMeans(device="cpu").set_k(k).set_max_iter(max_iter)
           .set_seed(seed).set_workset(workset).set_tie_policy(tie)
           .set_distance_measure(measure))
    return est, est.fit(T.Table({"features": X}))


def _centroids(model):
    return model.get_model_data()[0]["centroids"][0]


def _predict(model, X, table_cls):
    return model.transform(table_cls({"features": X}))[0]["prediction"]


@pytest.mark.parametrize("workset,measure", [
    (False, "euclidean"), (True, "euclidean"), (False, "manhattan")])
def test_fit_below_kernel_threshold_matches_jax(workset, measure):
    """Plain body on both sides: centroids within 1e-5 (f32 rounding of
    the same expression), predictions equal.  (The workset fit is
    euclidean only, in both packages.)"""
    X = _blobs(3000, seed=3)
    _, jm = _jax_fit(X, 5, workset=workset, measure=measure)
    est, tm = _port_fit(X, 5, workset=workset, measure=measure)
    assert est.planned_impl == "plain"
    np.testing.assert_allclose(_centroids(tm), _centroids(jm), rtol=1e-5,
                               atol=1e-5)
    test = _blobs(500, seed=4)
    np.testing.assert_array_equal(_predict(tm, test, T.Table),
                                  _predict(jm, test, J.Table))


@pytest.mark.parametrize("workset", [False, True])
def test_fit_on_kernel_plan_matches_jax(workset):
    """At 65536 rows the port plans its kernels (here their plain
    versions); the JAX package runs its CPU XLA body.  The kernel scores
    drop |p|^2 and the root, so a near tie may round apart; init seed 6
    draws one point of each blob, so the fit has none and the centroids
    agree within 1e-4 (summation order over ~13k rows a cluster)."""
    X = _blobs(65536, seed=5)
    _, jm = _jax_fit(X, 5, max_iter=10, seed=6, workset=workset)
    est, tm = _port_fit(X, 5, max_iter=10, seed=6, workset=workset)
    assert est.planned_impl == ("kernel_ws" if workset else "kernel")
    assert tm.planned_impl == est.planned_impl
    np.testing.assert_allclose(_centroids(tm), _centroids(jm), rtol=1e-4,
                               atol=1e-4)


def _padded_problem(duplicated):
    """``tests/test_kmeans.py::test_pallas_epoch_step_matches_xla_step``'s
    data: 245 rows and 11 zero pad rows; optionally a duplicated
    centroid, so the tie policies differ."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(256 - 11, 4)).astype(np.float32)
    padded = np.concatenate([pts, np.zeros((11, 4), np.float32)])
    mask = np.concatenate([np.ones(len(pts)), np.zeros(11)]).astype(
        np.float32)
    cents = pts[:5].copy()
    if duplicated:
        cents[4] = cents[1]
    return padded, mask, cents


@pytest.mark.parametrize("duplicated", [False, True])
@pytest.mark.parametrize("tie", ["first", "fast", "split"])
def test_kernel_body_matches_pallas_body(tie, duplicated):
    """One step of the port's kernel body against the JAX package's
    ``kmeans_epoch_step_pallas`` in interpret mode: same pad correction,
    same fractional-count division; within 1e-5 (summation order)."""
    padded, mask, cents = _padded_problem(duplicated)
    jbody = JKM.kmeans_epoch_step_pallas(5, block_n=128, tie_policy=tie,
                                         interpret=True)
    want = np.asarray(jbody(jnp.asarray(cents), 0,
                            (jnp.asarray(padded), jnp.asarray(mask)))
                      .feedback)
    tbody = TKM.kmeans_epoch_step_kernel(5, tie_policy=tie)
    got = tbody(torch.from_numpy(cents), 0,
                (torch.from_numpy(padded), torch.from_numpy(mask))).feedback
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("tie", ["first", "fast", "split"])
@pytest.mark.parametrize("n", [4096, 4003])
def test_workset_fit_bitexact_vs_bsp(tie, n):
    """The counterpart of ``tests/test_kmeans.py``'s workset acceptance:
    the bound-filtered fit's centroids are bit-identical to the BSP fit's
    (plain body; tiePolicy does not apply below the kernel threshold), the
    loop exits before maxIter, and the points scored per round fall below
    20% of n before convergence."""
    k, max_iter = 5, 60
    X = _blobs(n, k=k, seed=3)
    _, bsp = _port_fit(X, k, max_iter=max_iter, tie=tie)
    est, wk = _port_fit(X, k, max_iter=max_iter, tie=tie, workset=True)
    np.testing.assert_array_equal(_centroids(bsp), _centroids(wk))
    rep = est.last_workset_report
    assert rep["rounds"] < max_iter
    assert rep["rounds"] == len(rep["active_fraction"])
    assert rep["n_points"] == n
    scored = rep["points_scored"]
    assert scored[0] == n
    assert scored[:-1].min() < 0.2 * n
    assert rep["active_fraction"][-1] == 0.0


def test_workset_body_matches_jax_per_round():
    """The port's workset body against the JAX package's XLA body, round by
    round from the same state: masks and assignments equal, centroids
    within 1e-5, bounds within 1e-5 absolute plus 1e-5 relative (root
    distances of up to ~15, rounded apart by the two matrix products)."""
    rng = np.random.default_rng(12)
    n, d, k = 256, 6, 3
    pts = rng.normal(size=(n, d)).astype(np.float32)
    pts[:n // 3] += 4.0
    pts[n // 3: 2 * n // 3] -= 4.0
    mask = np.ones(n, np.float32)
    init = pts[:k].copy()
    jbody = JKM.kmeans_workset_epoch_step(
        JDistance.get_instance("euclidean"), k)
    tbody = TKM.kmeans_workset_epoch_step(
        TDistance.get_instance("euclidean"), k)
    jplan = JKM.FitPlan("xla", None, 1, "first_row", k, d)
    tplan = TKM.FitPlan("plain", k, d)
    jstate = (jnp.asarray(init), jplan.init_workset(jnp.asarray(mask)))
    tstate = (torch.from_numpy(init),
              tplan.init_workset(torch.from_numpy(mask)))
    jdata = (jnp.asarray(pts), jnp.asarray(mask))
    tdata = (torch.from_numpy(pts), torch.from_numpy(mask))
    for epoch in range(40):
        jstate = jbody(*jstate, epoch, jdata).feedback
        tstate = tbody(*tstate, epoch, tdata).feedback
        (jc, jws), (tc, tws) = jstate, tstate
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_array_equal(tws.mask.numpy(), np.asarray(jws.mask))
        np.testing.assert_array_equal(tws.bounds["assign"].numpy(),
                                      np.asarray(jws.bounds["assign"]))
        for key in ("upper", "lower"):
            np.testing.assert_allclose(tws.bounds[key].numpy(),
                                       np.asarray(jws.bounds[key]),
                                       rtol=1e-5, atol=1e-5)
        if not tws.mask.any():
            break
    assert not tws.mask.any() and epoch < 39


def _clusters(X, pred):
    groups = {}
    for row, c in zip(X, pred):
        groups.setdefault(int(c), set()).add(tuple(row.tolist()))
    return set(frozenset(v) for v in groups.values())


@pytest.mark.parametrize("workset", [False, True])
def test_six_point_membership_anchor(workset):
    """BASELINE.md:22: k=2 on the six fixed points gives exactly the two
    reference clusters."""
    est = T.KMeans(device="cpu").set_max_iter(10).set_workset(workset)
    model = est.fit(T.Table({"features": SIX}))
    assert _clusters(SIX, _predict(model, SIX, T.Table)) == EXPECTED
    assert _predict(model, SIX, T.Table).dtype == np.int64


def test_jax_saved_model_loads_and_transforms_identically(tmp_path):
    X = _blobs(2000, seed=8)
    _, jm = _jax_fit(X, 5)
    path = str(tmp_path / "jax_km")
    jm.save(path)
    tm = T.KMeansModel.load(path, device="cpu")
    np.testing.assert_array_equal(_centroids(tm), _centroids(jm))
    test = _blobs(700, seed=9)
    np.testing.assert_array_equal(_predict(tm, test, T.Table),
                                  _predict(jm, test, J.Table))
    # and the port's own save round-trips
    tm.save(str(tmp_path / "port_km"))
    again = T.KMeansModel.load(str(tmp_path / "port_km"), device="cpu")
    np.testing.assert_array_equal(_centroids(again), _centroids(jm))
    assert again.get_prediction_col() == jm.get_prediction_col()


def test_weights_across_from_jax():
    """``kmeans_model_from_jax``: a JAX-fitted model's centroids, carried
    across, give identical predictions in the port."""
    X = _blobs(2500, d=8, k=4, seed=10)
    _, jm = _jax_fit(X, 4)
    tm = kmeans_model_from_jax(_centroids(jm), device="cpu")
    test = _blobs(900, d=8, k=4, seed=11)
    np.testing.assert_array_equal(_predict(tm, test, T.Table),
                                  _predict(jm, test, J.Table))
    np.testing.assert_array_equal(_centroids(tm), _centroids(jm))
    with pytest.raises(ValueError, match=r"\(k, d\)"):
        kmeans_model_from_jax(np.zeros(3), device="cpu")


def test_estimator_params_and_save_load(tmp_path):
    est = T.KMeans(device="cpu")
    assert (est.get_k(), est.get_max_iter(), est.get_init_mode(),
            est.get_tie_policy(), est.get_workset()) == (2, 20, "random",
                                                         "first", False)
    assert est.get_distance_measure() == "euclidean"
    with pytest.raises(Exception):
        T.KMeans().set_k(1)
    est.set_k(7).set_tie_policy("split").set_workset(True)
    est.save(str(tmp_path / "est"))
    loaded = T.KMeans.load(str(tmp_path / "est"), device="cpu")
    assert (loaded.get_k(), loaded.get_tie_policy(), loaded.get_workset(),
            loaded.device) == (7, "split", True, "cpu")
    # a JAX-saved estimator loads too
    (JKM.KMeans().set_k(4).set_seed(3)).save(str(tmp_path / "jest"))
    jl = T.KMeans.load(str(tmp_path / "jest"), device="cpu")
    assert isinstance(jl, T.KMeans) and jl.get_k() == 4


def test_select_random_centroids_matches_jax():
    X = _blobs(300, seed=12)
    np.testing.assert_array_equal(TKM.select_random_centroids(X, 6, 5),
                                  JKM.select_random_centroids(X, 6, 5))
    with pytest.raises(ValueError, match="at least k"):
        TKM.select_random_centroids(X[:3], 6, 5)


def test_unported_paths_raise():
    X = _blobs(64, seed=13)
    # k-means++ is ported (tests/test_torch_kmeanspp.py), and so is the
    # streamed fit over ranks (tests/test_torch_widedeep_ranks.py), whose
    # mesh must be a process group's
    est = T.KMeans(device="cpu").set_init_mode("k-means++").set_k(3)
    assert _centroids(est.fit(T.Table({"features": X}))).shape == (3, 16)
    with pytest.raises(TypeError, match="Mesh"):
        T.KMeans(device="cpu").fit_outofcore(lambda: iter(()),
                                             mesh=object())
    # the chain terminal is ported: a kernel for a numeric column only
    model = kmeans_model_from_jax(X[:2], device="cpu")
    kernel = model.transform_kernel(T.Table({"features": X}).schema())
    assert kernel.post is not None and kernel.consumes == ("features",)
    assert model.transform_kernel({}) is None
    with pytest.raises(ValueError, match="euclidean"):
        TKM.kmeans_workset_epoch_step(TDistance.get_instance("cosine"), 2)


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = T.Table({"features": SIX})
    with pytest.raises(RuntimeError, match="no GPU"):
        T.KMeans().fit(table)
    with pytest.raises(RuntimeError, match="no GPU"):
        kmeans_model_from_jax(SIX[:2])
    model = T.KMeans(device="cpu").fit(table)
    model.device = "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        model.transform(table)


def test_iterate_loop_semantics():
    """Fixed epochs stack outputs; in the fused mode the KMeans fits use,
    a vote ends the loop and leaves a trace; the hosted mode (listeners,
    checkpoints) runs the same epochs."""
    def body(state, epoch):
        return IterationBodyResult(state + 1, outputs=state * 2)

    res = iterate(body, torch.zeros(()), max_epochs=4)
    assert res.num_epochs == 4 and float(res.state) == 4
    np.testing.assert_array_equal(res.outputs.numpy(), [0, 2, 4, 6])

    def voting(state, epoch, data):
        return IterationBodyResult(state + data, termination=state + data < 3)

    res = iterate(voting, torch.zeros(()), torch.ones(()), max_epochs=10,
                  config=IterationConfig(mode="fused"))
    assert res.num_epochs == 3 and float(res.state) == 3
    np.testing.assert_array_equal(res.side["epoch_trace"]["termination"],
                                  [1, 1, 0])
    assert np.isnan(res.side["epoch_trace"]["active_fraction"]).all()
    seen = []
    for kw in ({"listeners": [FnListener(lambda e, ctx: seen.append(e))]},
               {"config": IterationConfig(mode="hosted")}):
        res = iterate(body, torch.zeros(()), max_epochs=2, **kw)
        assert res.num_epochs == 2 and float(res.state) == 2
        assert [float(o) for o in res.outputs] == [0, 2]
    assert seen == [0, 1]
