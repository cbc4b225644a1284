"""k-means++ seeding of the port (``select_kmeanspp_centroids``, on the CPU)
against the JAX package's, by distribution: the JAX package draws from
``jax.random``, whose stream the port cannot reproduce, so the two are
held to the same law and the same costs, not to the same arrays.

- The second center of a seeding follows ``d2 / d2.sum()`` given the
  first (uniform): a chi-square test over a fixed set of seeds, for the
  port and for the JAX package alike.
- A center never repeats while unchosen mass remains.
- Over 32 seeds the mean initial cost and the mean cost of the fitted
  centroids (``KMeans(initMode="k-means++").fit``) agree with the JAX
  package's within the stated tolerances, and lie below random init's.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import stats

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu.models.clustering import kmeans as JKM
from flink_ml_tpu.parallel.mesh import device_mesh, use_mesh
from flink_ml_tpu_torch.models.clustering import kmeans as TKM

# six points whose squared distances span 0.25 to ~70: every (first,
# second) pair has a probability of at least ~1/600
SIX = np.array([[0.0, 0.0], [0.5, 0.0], [3.0, 1.0], [-2.0, 4.0],
                [5.0, -3.0], [1.0, 6.0]], np.float32)
CHI_SEEDS = 3000
CHI_P_MIN = 1e-3        # the fixed seeds' statistic must not be rarer
COST_SEEDS = 32
# 2-D, 16 well separated blobs: the two packages' 32-seed means differ by
# ~1 standard error of their difference (measured: 3.3% and 2.5% a mean
# for the initial and fitted costs); the tolerances are ~3 of them
INIT_RTOL, FIT_RTOL = 0.15, 0.08


def _seed_port(points, k, seed):
    gen = torch.Generator().manual_seed(seed)
    return TKM.select_kmeanspp_centroids(torch.from_numpy(points), k,
                                         generator=gen).numpy()


def _rows(points, centers):
    """Row index in ``points`` of each center."""
    hit = np.all(points[None, :, :] == centers[:, None, :], axis=-1)
    assert np.all(hit.sum(1) >= 1)
    return hit.argmax(1)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_second_center_follows_d2(which):
    """Pearson's chi-square of the (first, second) pair counts over
    ``CHI_SEEDS`` fixed seeds against ``(1/n) d2_i[j] / sum_j d2_i[j]``."""
    n = len(SIX)
    d2 = ((SIX[:, None, :].astype(np.float64) - SIX[None]) ** 2).sum(-1)
    want = d2 / d2.sum(1, keepdims=True) / n
    counts = np.zeros((n, n))
    for seed in range(CHI_SEEDS):
        c = (_seed_port(SIX, 2, seed) if which == "port"
             else JKM.select_kmeanspp_centroids(SIX, 2, seed))
        i, j = _rows(SIX, c)
        counts[i, j] += 1
    assert np.trace(counts) == 0          # the first never repeats
    off = ~np.eye(n, dtype=bool)
    expected = want[off] * CHI_SEEDS
    chi2 = float(((counts[off] - expected) ** 2 / expected).sum())
    p = stats.chi2.sf(chi2, df=off.sum() - 1)
    assert p > CHI_P_MIN, (chi2, p)


def test_no_center_repeats_while_mass_remains():
    """k = n draws every point once; with duplicated points each distinct
    value once (a duplicate's d2 is 0 once its twin is chosen)."""
    for seed in range(20):
        rows = _rows(SIX, _seed_port(SIX, len(SIX), seed))
        assert sorted(rows) == list(range(len(SIX)))
    dup = np.concatenate([SIX[:4], SIX[:2]])
    for seed in range(20):
        got = _seed_port(dup, 4, seed)
        assert len(np.unique(got, axis=0)) == 4
        assert sorted(_rows(SIX[:4], got)) == [0, 1, 2, 3]


def _blobs(n=2000, d=2, k=16, spread=10.0, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * spread
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)


def _cost(X, C):
    """Mean squared distance of the rows to their nearest center, f64."""
    X, C = X.astype(np.float64), np.asarray(C, np.float64)
    return float(((X[:, None, :] - C[None]) ** 2).sum(-1).min(1).mean())


def test_costs_match_jax_and_beat_random_init():
    X = _blobs()
    k, iters = 16, 10
    init = {"port": [], "jax": [], "random": []}
    fit = {"port": [], "jax": [], "random": []}
    with use_mesh(device_mesh({"data": 1}, devices=jax.devices()[:1])):
        for s in range(COST_SEEDS):
            init["port"].append(_cost(X, _seed_port(X, k, s)))
            init["jax"].append(_cost(X, JKM.select_kmeanspp_centroids(X, k,
                                                                      s)))
            init["random"].append(_cost(X, TKM.select_random_centroids(
                X, k, s)))
            jm = (JKM.KMeans().set_k(k).set_max_iter(iters).set_seed(s)
                  .set_init_mode("k-means++").fit(J.Table({"features": X})))
            fit["jax"].append(_cost(X, jm.get_model_data()[0]["centroids"][0]))
            for name, mode in (("port", "k-means++"), ("random", "random")):
                tm = (T.KMeans(device="cpu").set_k(k).set_max_iter(iters)
                      .set_seed(s).set_init_mode(mode)
                      .fit(T.Table({"features": X})))
                fit[name].append(_cost(
                    X, tm.get_model_data()[0]["centroids"][0]))
    mean = {w: {n: np.mean(v) for n, v in c.items()}
            for w, c in (("init", init), ("fit", fit))}
    np.testing.assert_allclose(mean["init"]["port"], mean["init"]["jax"],
                               rtol=INIT_RTOL)
    np.testing.assert_allclose(mean["fit"]["port"], mean["fit"]["jax"],
                               rtol=FIT_RTOL)
    for w in ("init", "fit"):
        assert max(mean[w]["port"], mean[w]["jax"]) < mean[w]["random"], mean


def test_too_few_points_raise_the_jax_message():
    X = SIX[:3]
    with pytest.raises(ValueError, match="Need at least k=5 points, got 3"):
        JKM.select_kmeanspp_centroids(X, 5, 0)
    with pytest.raises(ValueError, match="Need at least k=5 points, got 3"):
        _seed_port(X, 5, 0)
    with pytest.raises(ValueError, match="Need at least k=5 points, got 3"):
        (T.KMeans(device="cpu").set_k(5).set_init_mode("k-means++")
         .fit(T.Table({"features": X})))


def test_same_seed_same_centroids_and_init_mode_saved(tmp_path):
    """One seed on one device gives one seeding and one fit; another seed
    another seeding; save and load keep ``initMode``."""
    X = _blobs(n=600, seed=3)
    a = _seed_port(X, 8, 11)
    np.testing.assert_array_equal(a, _seed_port(X, 8, 11))
    assert not np.array_equal(a, _seed_port(X, 8, 12))
    est = (T.KMeans(device="cpu").set_k(8).set_max_iter(5).set_seed(11)
           .set_init_mode("k-means++"))
    c1 = est.fit(T.Table({"features": X})).get_model_data()[0]["centroids"]
    c2 = est.fit(T.Table({"features": X})).get_model_data()[0]["centroids"]
    np.testing.assert_array_equal(c1, c2)
    est.save(str(tmp_path / "est"))
    loaded = T.KMeans.load(str(tmp_path / "est"), device="cpu")
    assert loaded.get_init_mode() == "k-means++"
    assert loaded.get_seed() == 11
