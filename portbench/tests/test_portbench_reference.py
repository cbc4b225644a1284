"""The plain references against fits worked out independently: Lloyd's
rounds by hand on separated points, and two Adam steps of Wide&Deep from
a float64 numpy forward pass with finite-difference gradients."""

import numpy as np
import pytest
import torch

from portbench.reference import kmeans as ref_km
from portbench.reference import widedeep as ref_wd


def test_lloyd_by_hand():
    x = np.array([[0.0, 0], [1, 0], [10, 0], [11, 0]], np.float32)
    for seed in range(6):
        init = torch.from_numpy(ref_km.init_centroids(x, 2, seed))
        got = ref_km.lloyd(torch.from_numpy(x), init, 4, block=3).numpy()
        assert sorted(got[:, 0].tolist()) == [0.5, 10.5]
        assert np.all(got[:, 1] == 0)


def test_lloyd_keeps_an_empty_cluster_and_takes_the_first_tie():
    x = torch.tensor([[0.0], [2.0]])
    init = torch.tensor([[1.0], [5.0]])
    # both points tie at distance 1 from centroid 0 and are far from 1
    got = ref_km.lloyd(x, init, 1)
    assert got.tolist() == [[1.0], [5.0]]
    init = torch.tensor([[1.0], [1.0]])
    assert ref_km.lloyd(x, init, 1).tolist() == [[1.0], [1.0]]


def test_lloyd_stale_last_leaves_the_last_centroids():
    x = torch.tensor([[0.0], [1.0], [10.0], [11.0], [20.0]])
    init = torch.tensor([[0.0], [10.0], [19.0]])
    plain = ref_km.lloyd(x, init, 1)
    stale = ref_km.lloyd(x, init, 1, stale_last=1)
    assert plain.tolist() == [[0.5], [10.5], [20.0]]
    assert stale.tolist() == [[0.5], [10.5], [19.0]]


def test_near_ties_mark_every_centroid_a_tied_point_may_join():
    x = torch.tensor([[0.0], [2.0], [10.0]])
    c = torch.tensor([[1.0], [3.0], [20.0], [-5.0]])
    # 2.0 lies 1 from both 1.0 and 3.0; 0.0 and 10.0 have one nearest
    assert ref_km.near_ties(x, c).tolist() == [True, True, False, False]
    assert not ref_km.near_ties(x[[0, 2]], c).any()
    # within rel * (|x|^2 + |c|^2) = 1e-5 * 5 of a tie counts
    y = torch.tensor([[2.0 + 1e-6]], dtype=torch.float64)
    assert ref_km.near_ties(y, c.double()).tolist() == [True, True, False,
                                                       False]


def test_centroid_gaps_scale():
    ref = np.array([[3.0, 4.0], [0.0, 5.0]])
    got = ref + np.array([[0.5, 0.0], [0.0, 0.0]])
    assert ref_km.centroid_gaps(got, ref).tolist() == [0.1, 0.0]


# --- Wide&Deep -------------------------------------------------------------

DENSE, VOCAB, EMB, HIDDEN = 2, [3, 2], 2, [3]
LR, B1, B2, EPS = 1e-2, 0.9, 0.999, 1e-8


def _data(n=4):
    rng = np.random.default_rng(7)
    dense = rng.normal(size=(n, DENSE)).astype(np.float32)
    cat = np.stack([rng.integers(0, v, n) for v in VOCAB], 1)
    labels = np.array([0, 1, 1, 0], np.float32)[:n]
    return dense, cat.astype(np.int32), labels


def _loss64(p, dense, ids, y, w):
    wide = dense @ p["wide_dense"] + p["wide_cat"][ids].sum(1) + p["wide_b"]
    h = np.concatenate([dense, p["emb"][ids].reshape(len(dense), -1)], 1)
    h = np.maximum(h @ p["mlp.0.w"] + p["mlp.0.b"], 0.0)
    m = wide + (h @ p["mlp.1.w"] + p["mlp.1.b"])[:, 0]
    z = -(2 * y - 1) * m
    return float(np.sum(np.logaddexp(0.0, z) * w) / np.sum(w))


def _grad64(p, *batch, h=1e-6):
    g = {}
    for k, v in p.items():
        gk = np.zeros_like(v)
        for i in np.ndindex(v.shape):
            up = {**p, k: v.copy()}
            dn = {**p, k: v.copy()}
            up[k][i] += h
            dn[k][i] -= h
            gk[i] = (_loss64(up, *batch) - _loss64(dn, *batch)) / (2 * h)
        g[k] = gk
    return g


def test_widedeep_two_adam_steps_by_finite_differences():
    dense, cat, labels = _data()
    seed, batch = 11, 2
    got = ref_wd.fit(dense, cat, labels, vocab_sizes=VOCAB, emb_dim=EMB,
                     hidden=HIDDEN, lr=LR, batch=batch, epochs=1, seed=seed,
                     device=torch.device("cpu"))
    p = {k: np.asarray(v, np.float64) for k, v in ref_wd.leaves(
        ref_wd.init_params(seed, DENSE, VOCAB, EMB, HIDDEN)).items()}
    ids = cat + np.array([0, VOCAB[0]])
    perm = np.random.default_rng(seed).permutation(len(dense))
    mu = {k: np.zeros_like(v) for k, v in p.items()}
    nu = {k: np.zeros_like(v) for k, v in p.items()}
    losses = []
    for t, rows in enumerate(perm.reshape(-1, batch), start=1):
        b = (dense[rows].astype(np.float64), ids[rows],
             labels[rows].astype(np.float64), np.ones(batch))
        losses.append(_loss64(p, *b))
        g = _grad64(p, *b)
        for k in p:
            mu[k] = B1 * mu[k] + (1 - B1) * g[k]
            nu[k] = B2 * nu[k] + (1 - B2) * g[k] ** 2
            p[k] = np.asarray(p[k] - LR * (mu[k] / (1 - B1 ** t)) / (
                np.sqrt(nu[k] / (1 - B2 ** t)) + EPS))
    assert got["loss_log"][0] == pytest.approx(np.mean(losses), rel=1e-6)
    for k in p:
        np.testing.assert_allclose(got["params"][k], p[k], rtol=0,
                                   atol=2e-6, err_msg=k)
    assert got["grad0_norm"]["wide_b"] > 0


def test_widedeep_freeze_after_leaves_the_state_after_that_step():
    dense, cat, labels = _data()
    kw = dict(vocab_sizes=VOCAB, emb_dim=EMB, hidden=HIDDEN, lr=LR, batch=2,
              seed=11, device=torch.device("cpu"))

    def fit(epochs, **v):
        return ref_wd.fit(dense, cat, labels, epochs=epochs, **kw, **v)

    plain = fit(2)
    for k, v in fit(2, freeze_after=4)["params"].items():
        np.testing.assert_array_equal(v, plain["params"][k], err_msg=k)
    for k, v in fit(2, freeze_after=0)["params"].items():
        np.testing.assert_array_equal(v, plain["init"][k], err_msg=k)
    once, once_short = fit(2, freeze_after=1), fit(1, freeze_after=1)
    one_epoch = fit(1)
    for k, v in once["params"].items():
        np.testing.assert_array_equal(v, once_short["params"][k], err_msg=k)
    assert not np.array_equal(once["params"]["emb"], plain["init"]["emb"])
    assert not np.array_equal(once["params"]["emb"],
                              one_epoch["params"]["emb"])


def test_change_norm_gaps_leave_out_leaves_without_gradient():
    init = {"a": np.zeros(4), "b": np.zeros(4), "c": np.zeros(4)}
    ref = {"init": init,
           "params": {"a": np.ones(4), "b": 2 * np.ones(4),
                      "c": np.full(4, 1e-9)},
           "grad0_norm": {"a": 1.0, "b": 1.0, "c": 1e-9}}
    got = {"a": np.ones(4), "b": np.ones(4), "c": np.zeros(4)}
    gaps = ref_wd.change_norm_gaps(got, ref)
    assert set(gaps) == {"a", "b"}
    assert gaps["a"] == 0.0 and gaps["b"] == pytest.approx(0.5)
