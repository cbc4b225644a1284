"""The port's Swing, MinHashLSH and RankingEvaluator against the JAX
package's on the same seeded numpy inputs, both on the CPU.

Tolerances: Swing scores within ``rtol 1e-5`` of the JAX package's (f32
products summed in another order; ``torch.pow`` may differ from XLA's in
the last place), top-k lists equal where no two scores of an item lie
within 1e-6 relative of each other; MinHash signatures (exact integer
minima), query tables and ranking metrics equal."""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flink_ml_tpu as J
import flink_ml_tpu.models.feature.lsh as JL
import flink_ml_tpu.models.recommendation.swing as JS
import flink_ml_tpu_torch as T
import flink_ml_tpu_torch.models.feature.lsh as TL
import flink_ml_tpu_torch.models.recommendation.swing as TS
from flink_ml_tpu.models.evaluation import RankingEvaluator as JRank
from flink_ml_tpu.models.feature import MinHashLSH as JMinHash
from flink_ml_tpu.models.feature import MinHashLSHModel as JMinHashModel
from flink_ml_tpu.models.recommendation import Swing as JSwing
from flink_ml_tpu_torch.models.evaluation import RankingEvaluator
from flink_ml_tpu_torch.models.feature import MinHashLSH, MinHashLSHModel
from flink_ml_tpu_torch.models.recommendation import Swing
from flink_ml_tpu_torch.utils import persist as TP
from flink_ml_tpu_torch.utils.convert import model_data_from_jax

SCORES = dict(rtol=1e-5, atol=1e-7)


def _for_jax(tmp_path, name, src):
    """A copy of the port-saved directory ``src`` whose metadata names the
    JAX package's classes."""
    dst = tmp_path / name
    shutil.copytree(src, dst)
    for meta_path in dst.rglob("metadata"):
        meta = json.loads(meta_path.read_text())
        meta["className"] = "flink_ml_tpu." + \
            meta["className"][len("flink_ml_tpu_torch."):]
        meta_path.write_text(json.dumps(meta))
    return str(dst)


# ------------------------------------------------------------------ Swing


def test_swing_hand_computed_two_items():
    """u0:{i0,i1} u1:{i0,i1} u2:{i0}; alpha1 0, beta 1 -> w = 1/|I_u|;
    sim(i0, i1) = 0.5 * 0.5 / (1 + 2) = 1/12."""
    cols = {"user": np.asarray([0, 0, 1, 1, 2]),
            "item": np.asarray(["i0", "i1", "i0", "i1", "i0"])}
    outs = [(cls(**kw).set_min_user_behavior(1).set_alpha1(0).set_alpha2(1)
             .set_beta(1.0).transform(pkg.Table(cols))[0])
            for pkg, cls, kw in ((T, Swing, {"device": "cpu"}),
                                 (J, JSwing, {}))]
    for out in outs:
        i0 = int(np.flatnonzero(np.asarray(out["item"]) == "i0")[0])
        assert out["similar_items"][i0] == ["i1"]
        np.testing.assert_allclose(out["scores"][i0], [1.0 / 12.0],
                                   rtol=1e-6)
    assert list(outs[0]["item"]) == list(outs[1]["item"])


def _random_interactions(n_users=300, n_items=60, n=6000, seed=5):
    rng = np.random.default_rng(seed)
    return {"user": rng.integers(0, n_users, n),
            "item": rng.integers(0, n_items, n)}


def _near_ties(scores):
    """True where two of the row's positive scores lie within 1e-6
    relative of each other: there the rank order may differ."""
    s = np.sort(np.asarray(scores))
    return bool(np.any(np.diff(s) <= 1e-6 * np.abs(s[1:])))


@pytest.mark.parametrize("params", [
    dict(),                                        # defaults, k 100
    dict(k=5, alpha1=0, alpha2=1, beta=1.0, max_user_num_per_item=20,
         min_user_behavior=5, max_user_behavior=30, seed=3),
])
def test_swing_random_set_matches_jax(params):
    cols = _random_interactions()
    params = {"min_user_behavior": 10, **params}

    def run(cls, pkg, **kw):
        op = cls(**kw)
        for name, v in params.items():
            getattr(op, f"set_{name}")(v)
        return op.transform(pkg.Table(cols))[0]

    got, want = run(Swing, T, device="cpu"), run(JSwing, J)
    np.testing.assert_array_equal(got["item"], want["item"])
    compared = 0
    for g_items, w_items, g_s, w_s in zip(got["similar_items"],
                                          want["similar_items"],
                                          got["scores"], want["scores"]):
        assert len(g_items) == len(w_items)
        if not _near_ties(w_s):
            assert list(g_items) == list(w_items)
            np.testing.assert_allclose(g_s, w_s, **SCORES)
            compared += 1
    assert compared >= len(got["item"]) // 2
    # the whole score matrix, on the same B
    B = np.zeros((300, 60), np.float32)
    B[cols["user"], cols["item"]] = 1.0
    a1, a2, beta = (float(params.get(n, d)) for n, d in
                    (("alpha1", 15), ("alpha2", 0), ("beta", 0.3)))
    want_S = np.asarray(JS._swing_scores(jnp.asarray(B), jnp.float32(a1),
                                         jnp.float32(a2), jnp.float32(beta)))
    got_S = TS._swing_scores(torch.from_numpy(B), a1, a2, beta).numpy()
    np.testing.assert_allclose(got_S, want_S, **SCORES)
    assert np.count_nonzero(got_S) > 0.5 * got_S.size


def test_swing_chunked_equals_unchunked():
    """The user-chunked pair kernel gives the same scores whatever the
    chunk (non-dividing chunks too), in both packages."""
    rng = np.random.default_rng(3)
    B = (rng.random((37, 6)) < 0.3).astype(np.float32)
    full = TS._swing_scores(torch.from_numpy(B), 15.0, 0.0, 0.3, 64).numpy()
    want = np.asarray(JS._swing_scores(jnp.asarray(B), jnp.float32(15),
                                       jnp.float32(0), jnp.float32(0.3), 64))
    np.testing.assert_allclose(full, want, **SCORES)
    for chunk in (4, 16, 37):
        part = TS._swing_scores(torch.from_numpy(B), 15.0, 0.0, 0.3,
                                chunk).numpy()
        np.testing.assert_allclose(part, full, **SCORES)


def test_swing_params_and_errors():
    op, jop = Swing(), JSwing()
    assert op.device == "cuda"
    for name in ("k", "min_user_behavior", "max_user_behavior",
                 "max_user_num_per_item", "alpha1", "alpha2", "beta",
                 "user_col", "item_col", "seed"):
        assert getattr(op, f"get_{name}")() == getattr(jop, f"get_{name}")()
    with pytest.raises(Exception):
        Swing().set_alpha1(-2)
    with pytest.raises(Exception):
        Swing().set_alpha2(-1)
    with pytest.raises(Exception):
        Swing().set_beta(-0.5)
    out = Swing(device="cpu").set_min_user_behavior(1).transform(T.Table({
        "user": np.asarray([0, 1]), "item": np.asarray([0, 1])}))[0]
    assert out["similar_items"][0] == [] and out["similar_items"][1] == []


# ------------------------------------------------------------- MinHashLSH


def _binary_rows(n=200, d=40, p=0.2, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.random((n, d)) < p).astype(np.float64)
    X[np.arange(n), rng.integers(0, d, n)] = 1.0   # no empty row
    return X


def _models(tables=3, fns=2, seed=7):
    port = (MinHashLSH(device="cpu").set_num_hash_tables(tables)
            .set_num_hash_functions_per_table(fns).set_seed(seed)
            .fit(T.Table({"features": np.ones((1, 2))})))
    jax = (JMinHash().set_num_hash_tables(tables)
           .set_num_hash_functions_per_table(fns).set_seed(seed)
           .fit(J.Table({"features": np.ones((1, 2))})))
    return port, jax


def test_minhash_signatures_equal_jax(monkeypatch):
    X = _binary_rows()
    port, jax = _models()
    np.testing.assert_array_equal(port._coeff, jax._coeff)
    got = np.asarray(port.transform(T.Table({"features": X}))[0]["output"])
    want = np.asarray(jax.transform(J.Table({"features": X}))[0]["output"])
    assert got.shape == (200, 3, 2) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # a numpy int64 min over each row's active indices
    table = port.hash_table(X.shape[1]).astype(np.int64)
    ref = np.stack([table[X[i] > 0].min(axis=0) for i in range(len(X))])
    np.testing.assert_array_equal(got.reshape(len(X), -1), ref)
    # row chunks of 7 rows give the same minima
    monkeypatch.setattr(TL, "_MINHASH_CHUNK_ELEMS", 7 * 40 * 6)
    again = np.asarray(port.transform(T.Table({"features": X}))[0]["output"])
    np.testing.assert_array_equal(again, got)
    with pytest.raises(ValueError, match="nonzero"):
        port.transform(T.Table({"features": np.zeros((1, 40))}))


def test_minhash_queries_equal_jax():
    X = _binary_rows(n=120, d=24, p=0.3, seed=1)
    port, jax = _models(tables=5, fns=2, seed=3)
    ids = np.arange(len(X)) + 1000
    for key in (X[3], X[50] * 0 + (np.arange(24) < 6)):
        got = port.approx_nearest_neighbors(
            T.Table({"features": X, "id": ids}), key, k=10)
        want = jax.approx_nearest_neighbors(
            J.Table({"features": X, "id": ids}), key, k=10)
        np.testing.assert_array_equal(got["id"], want["id"])
        np.testing.assert_array_equal(got["distCol"], want["distCol"])
    Xb = _binary_rows(n=80, d=24, p=0.3, seed=2)
    got = port.approx_similarity_join(
        T.Table({"features": X, "id": ids}),
        T.Table({"features": Xb, "id": np.arange(80)}), 0.6, "id")
    want = jax.approx_similarity_join(
        J.Table({"features": X, "id": ids}),
        J.Table({"features": Xb, "id": np.arange(80)}), 0.6, "id")
    assert len(got["idA"]) > 0
    for col in ("idA", "idB", "distCol"):
        np.testing.assert_array_equal(got[col], want[col])


def test_minhash_saves_both_ways_and_conversion(tmp_path):
    X = _binary_rows(n=30, d=12, seed=4)
    port, jax = _models(tables=2, fns=3, seed=5)
    want = np.asarray(jax.transform(J.Table({"features": X}))[0]["output"])
    jax.save(str(tmp_path / "jax"))
    loaded = TP.load_stage(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, MinHashLSHModel) and loaded.device == "cpu"
    assert loaded.get_num_hash_functions_per_table() == 3
    np.testing.assert_array_equal(
        loaded.transform(T.Table({"features": X}))[0]["output"], want)
    port.save(str(tmp_path / "port"))
    back = JMinHashModel.load(_for_jax(tmp_path, "j2", tmp_path / "port"))
    np.testing.assert_array_equal(
        back.transform(J.Table({"features": X}))[0]["output"], want)
    again = MinHashLSHModel.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(
        again.transform(T.Table({"features": X}))[0]["output"], want)
    conv = model_data_from_jax(jax, device="cpu")
    assert isinstance(conv, MinHashLSHModel)
    np.testing.assert_array_equal(
        conv.transform(T.Table({"features": X}))[0]["output"], want)
    est = MinHashLSH(device="cpu").set_num_hash_tables(4)
    est.save(str(tmp_path / "est"))
    assert MinHashLSH.load(str(tmp_path / "est"), device="cpu") \
        .get_num_hash_tables() == 4
    with pytest.raises(RuntimeError, match="no model data"):
        MinHashLSHModel(device="cpu").transform(T.Table({"features": X}))


# -------------------------------------------------------- RankingEvaluator


def _lists(preds, labels):
    p = np.empty(len(preds), object)
    r = np.empty(len(labels), object)
    for i, (a, b) in enumerate(zip(preds, labels)):
        p[i] = list(a)
        r[i] = None if b is None else list(b)
    return {"prediction": p, "label": r}


# ``tests/test_ranking_evaluator.py``'s fixtures: (rows, k, metrics)
RANKING_CASES = [
    ([["a", "b", "c", "d"]], [["a", "c", "x"]], 4, None),
    ([["a", "b"], ["x", "y"]], [["a", "b"], ["a", "b"]], 2, None),
    ([["x", "y", "a"]], [["a"]], 2, None),
    ([["x", "y", "a"]], [["a"]], 3, None),
    ([["a"], ["b"]], [["a"], []], 1, None),
    ([["a"]], [["a"]], 1, ("ndcgAtK", "mapAtK")),
    ([[3, 1, 2]], [[2, 9]], 3, None),
    ([["a", "a"]], [["a"]], 2, None),
    ([["a"], ["b"]], [["a"], None], 1, None),
]


@pytest.mark.parametrize("preds,labels,k,metrics", RANKING_CASES)
def test_ranking_evaluator_matches_jax(preds, labels, k, metrics):
    cols = _lists(preds, labels)
    outs = []
    for pkg, cls in ((T, RankingEvaluator), (J, JRank)):
        ev = cls().set_k(k)
        if metrics:
            ev.set_metrics(*metrics)
        outs.append(ev.transform(pkg.Table(cols))[0])
    got, want = outs
    assert got.column_names == want.column_names
    for name in got.column_names:
        assert float(got[name][0]) == float(want[name][0])


def test_ranking_evaluator_errors():
    with pytest.raises(ValueError, match="no rows"):
        RankingEvaluator().transform(T.Table(_lists([["a"]], [[]])))
    with pytest.raises(ValueError, match="invalid value"):
        RankingEvaluator().set_metrics("nope")
    out = RankingEvaluator().set_k(4).transform(T.Table(_lists(
        [["a", "b", "c", "d"]], [["a", "c", "x"]])))[0]
    assert out["precisionAtK"][0] == pytest.approx(0.5)
    assert out["mapAtK"][0] == pytest.approx((1 + 2 / 3) / 3, rel=1e-6)
