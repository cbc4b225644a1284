"""The port's ALS (``flink_ml_tpu_torch.models.recommendation.als``)
against the JAX package's on the same seeded numpy inputs, both on the
CPU.

Tolerances: the normal equations of either form within ``rtol 1e-4, atol
1e-4`` of the JAX package's (the JAX package's own sorted-vs-scatter
tolerance; f32 sums in another order); the NeqPlan arrays equal; fits
within ``5e-3`` of the JAX fits (the JAX package's sorted-vs-scatter fit
tolerance); the workset fit's rounds within 1 of the JAX fit's (a
movement near ``tol`` may cross it in another f32 summation order);
recommendation lists from the same factors equal; ranking metrics
equal."""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flink_ml_tpu as J
import flink_ml_tpu.models.recommendation.als as JA
import flink_ml_tpu_torch as T
import flink_ml_tpu_torch.models.recommendation.als as TA
from flink_ml_tpu.models.evaluation import RankingEvaluator as JRank
from flink_ml_tpu.models.recommendation import ALS as JALS
from flink_ml_tpu.models.recommendation import ALSModel as JALSModel
from flink_ml_tpu_torch.models import ALS, ALSModel
from flink_ml_tpu_torch.models.evaluation import RankingEvaluator
from flink_ml_tpu_torch.utils import persist as TP
from flink_ml_tpu_torch.utils.convert import (model_data_from_jax,
                                              pipeline_model_from_jax)

NEQ = dict(rtol=1e-4, atol=1e-4)
FIT = dict(rtol=5e-3, atol=5e-3)


def _for_jax(tmp_path, name, src):
    """A copy of the port-saved directory ``src`` whose metadata names the
    JAX package's classes."""
    dst = tmp_path / name
    shutil.copytree(src, dst)
    for meta_path in dst.rglob("metadata"):
        meta = json.loads(meta_path.read_text())
        assert meta["className"].startswith("flink_ml_tpu_torch.")
        meta["className"] = "flink_ml_tpu." + \
            meta["className"][len("flink_ml_tpu_torch."):]
        meta_path.write_text(json.dumps(meta))
    return str(dst)


def _factors(model):
    data = model.get_model_data()[0]
    return (np.asarray(data["userFactors"][0]),
            np.asarray(data["itemFactors"][0]))


def _pred(model, table):
    return np.asarray(model.transform(table)[0]["prediction"])


def _synthetic(n_users=40, n_items=30, rank=4, density=0.5, seed=0,
               noise=0.0):
    """``tests/test_als.py``'s low-rank fixture: (columns, full matrix)."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, rank)) / np.sqrt(rank)
    V = rng.normal(size=(n_items, rank)) / np.sqrt(rank)
    full = U @ V.T
    mask = rng.random((n_users, n_items)) < density
    u, i = np.nonzero(mask)
    r = full[u, i] + noise * rng.normal(size=len(u))
    return {"user": u.astype(np.int64), "item": i.astype(np.int64),
            "rating": r.astype(np.float64)}, full


def _ratings(implicit, n=1500, seed=42):
    """``tests/test_als.py``'s fit fixture: 40 users x 25 items x 1500
    ratings (|r| for implicit)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 40, n).astype(np.int64)
    items = rng.integers(0, 25, n).astype(np.int64)
    ratings = (np.sin(users * 0.3) + np.cos(items * 0.5)
               + 0.05 * rng.normal(size=n)).astype(np.float32)
    return {"user": users, "item": items,
            "rating": np.abs(ratings) if implicit else ratings}


def _neq_fixture():
    """``tests/test_als.py:235-273``: a heavy group crossing chunks at
    chunk 128, 10% zero weights."""
    rng = np.random.default_rng(41)
    n_groups, n_other, nnz, rank = 12, 9, 700, 5
    g = rng.integers(0, n_groups, size=nnz)
    g[:300] = 3
    o = rng.integers(0, n_other, size=nnz).astype(np.int32)
    r = rng.normal(size=nnz).astype(np.float32)
    w = np.where(rng.random(nnz) < 0.1, 0.0, 1.0).astype(np.float32)
    factors = rng.normal(size=(n_other, rank)).astype(np.float32)
    return n_groups, g, o, r, w, factors


# ------------------------------------------------------- normal equations


@pytest.mark.parametrize("implicit", [False, True])
def test_normal_equations_match_jax(implicit, monkeypatch):
    n_groups, g, o, r, w, factors = _neq_fixture()
    rr = np.abs(r) if implicit else r
    want = JA._normal_equations(
        jnp.asarray(factors), jnp.asarray(g, jnp.int32), jnp.asarray(o),
        jnp.asarray(rr), jnp.asarray(w), n_groups, implicit, 0.7)
    want = [np.asarray(x) for x in want]
    jplan = JA.NeqPlan(g, chunk=128)
    want_sorted = JA._normal_equations_sorted(
        jnp.asarray(factors), jnp.asarray(jplan.sort_pad(o)),
        jnp.asarray(jplan.sort_pad(rr)), jnp.asarray(jplan.sort_pad(w)),
        jnp.asarray(jplan.local_rank), jnp.asarray(jplan.g_lo), n_groups,
        jplan.span, jplan.chunk, implicit, 0.7)

    f = torch.from_numpy(factors)
    # the scatter form in chunks of 128 too, so its loop crosses chunks
    monkeypatch.setattr(TA, "_CHUNK", 128)
    got = TA._normal_equations(
        f, torch.from_numpy(g.astype(np.int64)),
        torch.from_numpy(o.astype(np.int64)), torch.from_numpy(rr),
        torch.from_numpy(w), n_groups, implicit, 0.7)
    plan = TA.NeqPlan(g, chunk=128)
    o_s, r_s, w_s, lr_s = plan.side_data(o, rr, w, "cpu")
    got_sorted = TA._normal_equations_sorted(
        f, o_s, r_s, w_s, lr_s, plan.g_lo, n_groups, plan.span, plan.chunk,
        implicit, 0.7)
    for a, b, c, d in zip(got, want, got_sorted, want_sorted):
        assert a.shape == b.shape == c.shape
        np.testing.assert_allclose(a.numpy(), b, **NEQ)
        np.testing.assert_allclose(c.numpy(), np.asarray(d), **NEQ)
        np.testing.assert_allclose(c.numpy(), b, **NEQ)


def test_implicit_fractional_weights_consistent():
    """Duplicating a rating equals doubling its weight (A and b weighted
    alike), as in the JAX package's test."""
    rng = np.random.default_rng(0)
    V = torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32))
    prev = torch.zeros((2, 2))
    u = torch.tensor([0, 0, 1])
    i = torch.tensor([0, 1, 2])
    r = torch.tensor([1.0, 2.0, 1.5])
    dup = TA._solve_side(prev, V, torch.cat([u, u[:1]]),
                         torch.cat([i, i[:1]]), torch.cat([r, r[:1]]),
                         torch.ones(4), 2, 0.1, True, 2.0)
    wt = TA._solve_side(prev, V, u, i, r, torch.tensor([2.0, 1.0, 1.0]), 2,
                        0.1, True, 2.0)
    np.testing.assert_allclose(dup.numpy(), wt.numpy(), atol=1e-5)


@pytest.mark.parametrize("implicit", [False, True])
def test_solve_keeps_prev_for_singular_and_unobserved(implicit):
    """Group 0: exactly singular (y = [1, 2, 0], reg 0); group 1: never
    observed; group 2: indefinite, whose failed factor holds finite values
    (``cholesky_ex``'s info masks it, where ``cho_factor`` gives NaN);
    group 3: a regular system.  Both packages keep ``prev`` for 0-2 and
    solve 3 alike."""
    A = np.zeros((4, 3, 3), np.float32)
    A[0] = np.outer([1.0, 2.0, 0.0], [1.0, 2.0, 0.0])
    A[2] = np.diag([1.0, -1.0, 1.0])
    A[3] = np.eye(3) * 2.0 + 0.1
    b = np.arange(12, dtype=np.float32).reshape(4, 3)
    cnt = np.array([1.0, 0.0, 2.0, 3.0], np.float32)
    prev = np.full((4, 3), 7.0, np.float32)
    factors = np.zeros((5, 3), np.float32) if implicit else \
        np.ones((5, 3), np.float32)
    want = np.asarray(JA._solve_from_neq(
        jnp.asarray(prev), jnp.asarray(factors), jnp.asarray(A),
        jnp.asarray(b), jnp.asarray(cnt), 0.0, implicit))
    got = TA._solve_from_neq(
        torch.from_numpy(prev), torch.from_numpy(factors),
        torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(cnt),
        0.0, implicit).numpy()
    np.testing.assert_array_equal(got[:3], prev[:3])
    np.testing.assert_array_equal(want[:3], prev[:3])
    assert not np.array_equal(got[3], prev[3])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)


def test_neq_plans_match_jax():
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(4):
        n_groups = int(rng.integers(1, 500))
        nnz = int(rng.integers(1, 5000))
        cases.append(rng.integers(0, n_groups, nnz))
        cases.append((rng.pareto(0.5, nnz) * 10).astype(np.int64)
                      % n_groups)
    cases += [np.zeros(300, np.int64), np.arange(300)]
    for g in cases:
        for chunk in (7, 64, 8192):
            got, want = TA.NeqPlan(g, chunk), JA.NeqPlan(g, chunk)
            assert TA._neq_plan_span(g, chunk) == got.span == want.span
            assert (got.chunk, got.nnz, got.pad) == \
                (want.chunk, want.nnz, want.pad)
            for name in ("order", "g_lo", "local_rank"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(want, name))
            np.testing.assert_array_equal(got.sort_pad(g), want.sort_pad(g))


# ------------------------------------------------------------------- fits


def _est(cls, implicit, form, **kw):
    est = (cls(**kw).set_rank(6).set_max_iter(4).set_seed(0)
           .set_implicit_prefs(implicit))
    if form == "workset":
        return est.set_workset_tol(1e-4)
    return est.set(cls.NEQ_IMPL, form)


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("form", ["sorted", "scatter", "workset"])
def test_fits_match_jax(form, implicit):
    cols = _ratings(implicit)
    jm = _est(JALS, implicit, form).fit(J.Table(cols))
    est = _est(ALS, implicit, form, device="cpu")
    tm = est.fit(T.Table(cols))
    assert est.planned_impl == form and tm.device == "cpu"
    assert (est.plan_spans is not None) == (form == "sorted")
    for got, want in zip(_factors(tm), _factors(jm)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, **FIT)
    np.testing.assert_allclose(_pred(tm, T.Table(cols)),
                               _pred(jm, J.Table(cols)), **FIT)


def test_auto_plans_sorted_and_falls_back_on_long_tail(monkeypatch):
    cols = _ratings(False)
    est = ALS(device="cpu").set_rank(4).set_max_iter(2)
    est.fit(T.Table(cols))
    assert est.planned_impl == "sorted"
    assert est.plan_spans == (40, 25)
    # every user one rating: the band spans the chunk; a cap of 8 falls
    # back to the scatter form, as the JAX package's 'auto' does
    rng = np.random.default_rng(43)
    tail = {"user": np.arange(600), "item": rng.integers(0, 20, 600),
            "rating": rng.normal(size=600)}
    monkeypatch.setattr(TA, "_NEQ_AUTO_SPAN_CAP", 8)
    monkeypatch.setattr(JA, "_NEQ_AUTO_SPAN_CAP", 8)
    tm = est.fit(T.Table(tail))
    assert est.planned_impl == "scatter" and est.plan_spans is None
    jm = JALS().set_rank(4).set_max_iter(2).fit(J.Table(tail))
    for got, want in zip(_factors(tm), _factors(jm)):
        np.testing.assert_allclose(got, want, **FIT)


def test_workset_fit_follows_jax():
    """``tests/test_als.py:355-386`` in both packages: an exit before
    maxIter, both masks drained, the skip rule shrinking the workset,
    predictions within 5e-3 of the BSP fit; rounds within 1 of JAX's."""
    cols, _ = _synthetic(noise=0.01, seed=2)

    def build(cls, **kw):
        return (cls(**kw).set_rank(4).set_max_iter(60).set_reg_param(1e-2)
                .set_seed(5))

    base = build(ALS, device="cpu").fit(T.Table(cols))
    est = build(ALS, device="cpu").set_workset_tol(1e-4)
    model = est.fit(T.Table(cols))
    jest = build(JALS).set_workset_tol(1e-4)
    jmodel = jest.fit(J.Table(cols))
    rep, jrep = est.last_workset_report, jest.last_workset_report
    assert rep["rounds"] < 60
    assert abs(rep["rounds"] - jrep["rounds"]) <= 1
    assert rep["rounds"] == len(rep["active_fraction"])
    assert rep["active_fraction"][-1] == 0.0
    assert np.any((rep["active_fraction"] > 0)
                  & (rep["active_fraction"] < 1))
    assert rep["n_groups"] == jrep["n_groups"]
    np.testing.assert_allclose(_pred(model, T.Table(cols)),
                               _pred(base, T.Table(cols)), atol=5e-3)
    np.testing.assert_allclose(_pred(model, T.Table(cols)),
                               _pred(jmodel, J.Table(cols)), atol=5e-3)
    # a BSP fit after a workset fit reports nothing
    build(ALS, device="cpu").fit(T.Table(cols))
    est.set_workset_tol(0.0).fit(T.Table(cols))
    assert est.last_workset_report is None


def test_explicit_recovers_low_rank_matrix():
    cols, full = _synthetic()
    model = (ALS(device="cpu").set_rank(6).set_max_iter(20)
             .set_reg_param(1e-3).set_seed(1).fit(T.Table(cols)))
    rmse = np.sqrt(np.mean((_pred(model, T.Table(cols))
                            - cols["rating"]) ** 2))
    assert rmse < 0.02, rmse
    uh, ih = np.meshgrid(np.arange(full.shape[0]), np.arange(full.shape[1]),
                         indexing="ij")
    held = _pred(model, T.Table({"user": uh.ravel(), "item": ih.ravel()}))
    assert np.sqrt(np.nanmean((held.reshape(full.shape) - full) ** 2)) < 0.15


@pytest.mark.parametrize("case", ["gaps", "zero_reg"])
def test_singular_fits_keep_factors_finite(case):
    """``tests/test_als.py:134`` (users with gaps) and ``:146`` (regParam
    0 with fewer ratings than rank) in both packages."""
    if case == "gaps":
        cols = {"user": np.array([0, 0, 5, 5]), "item": np.array([0, 1, 0, 1]),
                "rating": np.array([1.0, 2.0, 3.0, 4.0])}
        kw = dict(rank=2, reg=0.1)
    else:
        cols = {"user": np.array([0, 0, 1]), "item": np.array([0, 1, 0]),
                "rating": np.array([1.0, 2.0, 3.0])}
        kw = dict(rank=4, reg=0.0)

    def fit(cls, table, **dev):
        return (cls(**dev).set_rank(kw["rank"]).set_reg_param(kw["reg"])
                .set_max_iter(4).fit(table))

    tm = fit(ALS, T.Table(cols), device="cpu")
    jm = fit(JALS, J.Table(cols))
    for got, want in zip(_factors(tm), _factors(jm)):
        assert np.isfinite(got).all()
        if case == "gaps":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        # at reg 0 a user's rank-2 system of rank 4 factors or fails by
        # rounding (a pivot of ~1e-8 either sign), in either package, so
        # the values are not compared: only that they stay finite
    assert np.isfinite(_pred(tm, T.Table(cols))).all()


def test_cold_start_errors_and_params(tmp_path):
    cols, _ = _synthetic()
    model = ALS(device="cpu").set_rank(3).set_max_iter(3).fit(T.Table(cols))
    pred = _pred(model, T.Table({"user": np.array([0, 10**6]),
                                 "item": np.array([0, 0])}))
    assert np.isfinite(pred[0]) and np.isnan(pred[1])
    empty = T.Table({"user": np.array([], np.int64),
                     "item": np.array([], np.int64),
                     "rating": np.array([], np.float64)})
    with pytest.raises(ValueError, match="at least one rating"):
        ALS(device="cpu").fit(empty)
    with pytest.raises(ValueError, match="non-negative"):
        ALS(device="cpu").set_implicit_prefs(True).fit(T.Table({
            "user": np.array([0]), "item": np.array([0]),
            "rating": np.array([-1.0])}))
    with pytest.raises(RuntimeError, match="no model data"):
        ALSModel(device="cpu").transform(T.Table(cols))
    est, jest = ALS(), JALS()
    for name in ("rank", "reg_param", "implicit_prefs", "alpha",
                 "workset_tol", "user_col", "item_col", "rating_col",
                 "max_iter", "prediction_col"):
        assert getattr(est, f"get_{name}")() == \
            getattr(jest, f"get_{name}")()
    assert est.get(ALS.NEQ_IMPL) == "auto" and est.device == "cuda"
    for bad in (lambda: est.set_workset_tol(-1.0),
                lambda: est.set_rank(0), lambda: est.set_reg_param(-0.1),
                lambda: est.set(ALS.NEQ_IMPL, "dense")):
        with pytest.raises(Exception):
            bad()
    # the estimator's params survive a save in either package
    ALS().set_rank(7).set_implicit_prefs(True).set_alpha(2.5).save(
        str(tmp_path / "e"))
    back = JALS.load(_for_jax(tmp_path, "je", tmp_path / "e"))
    assert (back.get_rank(), back.get_implicit_prefs(), back.get_alpha()) \
        == (7, True, 2.5)
    loaded = ALS.load(str(tmp_path / "e"), device="cpu")
    assert loaded.get_rank() == 7 and loaded.device == "cpu"


def test_without_a_card_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cols, _ = _synthetic()
    with pytest.raises(RuntimeError, match="no GPU"):
        ALS().set_max_iter(1).fit(T.Table(cols))


# ------------------------------------------- recommendations and the flow


def _loved_fixture():
    """``tests/test_als.py``'s recommend fixture: user u loves item u % 5."""
    users = np.repeat(np.arange(8), 5)
    items = np.tile(np.arange(5), 8)
    ratings = np.where(items == (users % 5), 5.0, 1.0)
    return {"user": users, "item": items, "rating": ratings}


def _same_recs(got, want):
    assert list(got["user"]) == list(want["user"])
    for a, b in zip(got["recommendations"], want["recommendations"]):
        assert list(a) == list(b)
    for a, b in zip(got["scores"], want["scores"]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_recommend_for_users_matches_jax():
    cols = _loved_fixture()
    jm = (JALS().set_rank(4).set_max_iter(10).set_reg_param(0.05)
          .fit(J.Table(cols)))
    tm = model_data_from_jax(jm, device="cpu")
    assert isinstance(tm, ALSModel) and tm.device == "cpu"
    users = np.arange(8)
    _same_recs(tm.recommend_for_users(users, k=2),
               jm.recommend_for_users(users, k=2))
    for exclude in (cols, {"user": users, "item": users % 5}):
        _same_recs(tm.recommend_for_users(users, 5, T.Table(exclude)),
                   jm.recommend_for_users(users, 5, J.Table(exclude)))
    assert tm.recommend_for_users(users, 5, T.Table(cols))[
        "recommendations"][0] == []
    # repeated users and an unordered request
    req = np.array([3, 1, 3, 0])
    _same_recs(tm.recommend_for_users(req, 3, T.Table(cols).take(12)),
               jm.recommend_for_users(req, 3, J.Table(cols).take(12)))
    with pytest.raises(ValueError, match="unknown user"):
        tm.recommend_for_users([999], k=1)
    with pytest.raises(ValueError, match="positive"):
        tm.recommend_for_users([0], k=0)


def test_saves_load_across_packages_and_conversion(tmp_path):
    cols, _ = _synthetic(n_users=12, n_items=9)
    jm = JALS().set_rank(3).set_max_iter(5).set_seed(4).fit(J.Table(cols))
    tm = (ALS(device="cpu").set_rank(3).set_max_iter(5).set_seed(4)
          .fit(T.Table(cols)))
    jm.save(str(tmp_path / "jax"))
    loaded = TP.load_stage(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, ALSModel) and loaded.device == "cpu"
    np.testing.assert_allclose(_pred(loaded, T.Table(cols)),
                               _pred(jm, J.Table(cols)), rtol=1e-6)
    tm.save(str(tmp_path / "port"))
    back = JALSModel.load(_for_jax(tmp_path, "j2", tmp_path / "port"))
    np.testing.assert_allclose(_pred(back, J.Table(cols)),
                               _pred(tm, T.Table(cols)), rtol=1e-6)
    for got, want in zip(_factors(ALSModel.load(str(tmp_path / "port"),
                                                device="cpu")),
                         _factors(tm)):
        np.testing.assert_array_equal(got, want)
    conv = model_data_from_jax(jm, device="cpu")
    np.testing.assert_allclose(_pred(conv, T.Table(cols)),
                               _pred(jm, J.Table(cols)), rtol=1e-6)
    pm = pipeline_model_from_jax(J.PipelineModel([jm]), device="cpu")
    np.testing.assert_allclose(
        np.asarray(pm.transform(T.Table(cols))[0]["prediction"]),
        _pred(jm, J.Table(cols)), rtol=1e-6)


def _example_data():
    """``examples/recommender_example.py``'s data: two taste groups, 3
    liked items a user held out."""
    rng = np.random.default_rng(0)
    n_users, n_items = 120, 40
    rows = []
    for u in range(n_users):
        group = np.arange(n_items // 2) + (u % 2) * (n_items // 2)
        liked = rng.choice(group, size=10, replace=False)
        for it in liked:
            rows.append((u, int(it), float(rng.uniform(3.5, 5.0))))
        noise_pool = np.setdiff1d(np.arange(n_items), liked)
        for it in rng.choice(noise_pool, size=2, replace=False):
            rows.append((u, int(it), float(rng.uniform(1.0, 2.0))))
    users, items, ratings = map(np.asarray, zip(*rows))
    truth = np.empty(n_users, object)
    train_mask = np.ones(len(users), bool)
    for u in range(n_users):
        own = np.flatnonzero((users == u) & (ratings > 3.0))
        held = rng.choice(own, size=3, replace=False)
        truth[u] = items[held].tolist()
        train_mask[held] = False
    train = {"user": users[train_mask], "item": items[train_mask],
             "rating": ratings[train_mask]}
    return train, truth


def test_recommender_example_flow_matches_jax():
    """Fit, recommend with the training pairs excluded, score with
    RankingEvaluator: the same lists and metrics in both packages."""
    train, truth = _example_data()
    users = np.arange(len(truth))
    flows = []
    for pkg, als, rank_eval in ((J, JALS(), JRank()),
                                (T, ALS(device="cpu"), RankingEvaluator())):
        model = (als.set_rank(8).set_max_iter(12).set_reg_param(0.05)
                 .fit(pkg.Table(train)))
        recs = model.recommend_for_users(users, k=10,
                                         exclude=pkg.Table(train))
        metrics = rank_eval.set_k(10).transform(pkg.Table({
            "prediction": recs["recommendations"], "label": truth}))[0]
        flows.append((recs, metrics))
    (jrecs, jmet), (trecs, tmet) = flows
    for a, b in zip(trecs["recommendations"], jrecs["recommendations"]):
        assert list(a) == list(b)
    assert tmet.column_names == jmet.column_names
    for name in tmet.column_names:
        assert float(tmet[name][0]) == float(jmet[name][0])
    assert float(tmet["recallAtK"][0]) > 0.5
