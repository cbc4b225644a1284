"""The port's KMeans ops (``flink_ml_tpu_torch/ops/kmeans.py``, on the CPU
their plain versions) against the JAX package's Pallas kernels in interpret
mode, as ``tests/test_ops.py`` runs them: n = 512, d = 16, k = 8,
``block_n=128``, 17 trailing zero pad rows.  Also the port's distance
measures and padding helpers against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_ml_tpu import distance as JD
from flink_ml_tpu.models.clustering.kmeans import kmeans_workset_update_xla
from flink_ml_tpu.ops import kmeans_pallas as JK
from flink_ml_tpu.utils import padding as JP
from flink_ml_tpu_torch import distance as TD
from flink_ml_tpu_torch.ops import kmeans as TK
from flink_ml_tpu_torch.utils import padding as TP

N, D, K, N_PAD, BLOCK = 512, 16, 8, 17, 128


def _problem(centroids="distinct", seed=0):
    """Points with ``N_PAD`` trailing zero rows.  ``"duplicated"``
    centroids hold an exact duplicate (every point near it ties) and two
    copies of the least-norm centroid (the zero pad rows tie on them)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(N, D)).astype(np.float32)
    pts[-N_PAD:] = 0.0
    cents = pts[:K].copy()
    if centroids == "duplicated":
        cents[0] *= 0.05
        cents[6] = cents[0]
        cents[7] = cents[2]
    return pts, cents


def _assert_no_near_ties(pts, cents, rtol=1e-5):
    """The best two f64 distances of every row differ (duplicated centroid
    rows, which tie exactly in both packages, aside), so float rounding
    cannot flip an assignment."""
    uniq = np.unique(cents, axis=0)
    d2 = ((pts[:, None, :].astype(np.float64) - uniq[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    assert np.all(two[:, 1] - two[:, 0] > rtol * (1 + two[:, 0]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("centroids", ["distinct", "duplicated"])
@pytest.mark.parametrize("tie", ["first", "fast", "split"])
def test_update_stats_matches_pallas_interpret(tie, centroids):
    """Counts equal (every count is a sum of 1, 1/2 or the pad count, exact
    in f32); sums within 1e-4 (summation order)."""
    pts, cents = _problem(centroids)
    _assert_no_near_ties(pts[:-N_PAD], cents)
    js, jc = JK.kmeans_update_stats(jnp.asarray(pts), jnp.asarray(cents),
                                    block_n=BLOCK, tie_policy=tie,
                                    interpret=True)
    jc = JK.pad_correction(jc, jnp.asarray(cents), N_PAD, tie_policy=tie)
    ts, tc = TK.kmeans_update_stats(_t(pts), _t(cents), tie_policy=tie)
    tc = TK.pad_correction(tc, _t(cents), N_PAD, tie_policy=tie)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    if tie != "fast":                 # "fast" counts a tied row twice
        assert float(tc.sum()) == N - N_PAD


@pytest.mark.parametrize("centroids", ["distinct", "duplicated"])
def test_assign_reduce_matches_pallas_interpret(centroids):
    """Assignments of the real rows equal; counts exact; sums within 1e-4."""
    pts, cents = _problem(centroids, seed=1)
    _assert_no_near_ties(pts[:-N_PAD], cents)
    ja, js, jc = JK.kmeans_assign_reduce(jnp.asarray(pts), jnp.asarray(cents),
                                         block_n=BLOCK, interpret=True)
    ta, ts, tc = TK.kmeans_assign_reduce(_t(pts), _t(cents))
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy()[:-N_PAD],
                                  np.asarray(ja)[:-N_PAD])
    np.testing.assert_array_equal(
        TK.pad_correction(tc, _t(cents), N_PAD, "argmin").numpy(),
        np.asarray(JK.pad_correction(jc, jnp.asarray(cents), N_PAD,
                                     "argmin")))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)


def _workset_inputs(seed=2):
    """Centroids drawn apart from the points: at a zero distance the root
    turns f32 cancellation (~1e-6 of |p|^2) into ~1e-3, so a point equal
    to a centroid cannot hold the 1e-5 tolerance of the distances."""
    pts, _ = _problem(seed=seed)
    rng = np.random.default_rng(seed + 100)
    cents = rng.normal(size=(K, D)).astype(np.float32)
    prev = rng.integers(0, K, size=N).astype(np.int32)
    active = (rng.random(N) < 0.5).astype(np.float32)
    pad = np.ones(N, np.float32)
    pad[-N_PAD:] = 0.0
    return pts, cents, prev, active, pad


@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
def test_workset_update_matches_jax(oracle):
    """Merged assignments equal; d_best/d_second within 1e-5 (the same
    expression, matrix products rounded apart); counts exact; sums within
    1e-4."""
    pts, cents, prev, active, pad = _workset_inputs()
    _assert_no_near_ties(pts[:-N_PAD], cents)
    args = [jnp.asarray(a) for a in (pts, cents, prev, active, pad)]
    if oracle == "xla":
        want = kmeans_workset_update_xla(
            JD.DistanceMeasure.get_instance("euclidean"), K, *args)
    else:
        want = JK.kmeans_workset_update(*args, block_n=BLOCK, interpret=True)
    got = TK.kmeans_workset_update(*[_t(a) for a in (pts, cents, prev,
                                                     active, pad)])
    ja, jb, jsec, js, jc = (np.asarray(w) for w in want)
    ta, tb, tsec, ts, tc = (g.numpy() for g in got)
    assert ta.dtype == np.int32
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tb, jb, atol=1e-5)
    np.testing.assert_allclose(tsec, jsec, atol=1e-5)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, atol=1e-4)
    # settled rows keep the cached assignment; pad rows count nowhere
    np.testing.assert_array_equal(ta[active == 0], prev[active == 0])
    assert tc.sum() == N - N_PAD


@pytest.mark.parametrize("tie", ["first", "argmin", "fast", "split"])
def test_pad_correction_matches_jax(tie):
    _, cents = _problem("duplicated")
    counts = np.arange(K, dtype=np.float32) * 3 + 20
    want = JK.pad_correction(jnp.asarray(counts), jnp.asarray(cents), 9,
                             tie_policy=tie)
    got = TK.pad_correction(_t(counts), _t(cents), 9, tie_policy=tie)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_check_their_inputs():
    pts, cents = _problem()
    with pytest.raises(ValueError, match="tie_policy"):
        TK.kmeans_update_stats(_t(pts), _t(cents), tie_policy="nearest")
    with pytest.raises(ValueError, match="compute_dtype"):
        TK.kmeans_update_stats(_t(pts), _t(cents),
                               compute_dtype=torch.float16)
    with pytest.raises(TypeError, match="points must be"):
        TK.kmeans_assign_reduce(_t(pts.astype(np.float64)), _t(cents))
    with pytest.raises(ValueError, match="centroids must have shape"):
        TK.kmeans_assign_reduce(_t(pts), _t(cents[:, :3]))
    with pytest.raises(ValueError, match="contiguous"):
        TK.kmeans_assign_reduce(_t(pts), _t(cents).T.contiguous().T)
    n = pts.shape[0]
    with pytest.raises(TypeError, match="prev_assign must be"):
        TK.kmeans_workset_update(_t(pts), _t(cents),
                                 torch.zeros(n, dtype=torch.int64),
                                 torch.ones(n), torch.ones(n))
    assert TK.LAUNCHES == {"kmeans_update_stats": 0,
                           "kmeans_update_stats_bf16": 0,
                           "kmeans_assign_reduce": 0,
                           "kmeans_workset_update": 0}


@pytest.mark.parametrize("name", ["euclidean", "cosine", "manhattan"])
def test_distance_measures_match_jax(name):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(40, 6)).astype(np.float32)
    cents = rng.normal(size=(7, 6)).astype(np.float32)
    jm = JD.DistanceMeasure.get_instance(name)
    tm = TD.DistanceMeasure.get_instance(name)
    np.testing.assert_allclose(
        tm.pairwise(_t(pts), _t(cents)).numpy(),
        np.asarray(jm.pairwise(jnp.asarray(pts), jnp.asarray(cents))),
        atol=1e-5)
    np.testing.assert_allclose(tm.pairwise_host64(pts, cents),
                               jm.pairwise_host64(pts, cents), rtol=1e-12)
    assert tm.distance(pts[0], cents[0]) == pytest.approx(
        jm.distance(pts[0], cents[0]), rel=1e-5)
    with pytest.raises(ValueError, match="not supported"):
        TD.DistanceMeasure.get_instance("chebyshev")


@pytest.mark.parametrize("n", [0, 1, 8, 9, 300])
def test_padding_helpers_match_jax(n):
    a = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    b = np.arange(n, dtype=np.int32)
    for (got, n_got), (want, n_want) in (
            (TP.pad_rows_to_bucket((a, b)), JP.pad_rows_to_bucket((a, b))),
            (TP.pad_rows_to_block((a, b), 16),
             JP.pad_rows_to_block((a, b), 16))):
        assert n_got == n_want == n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert TP.bucket_rows(n) == JP.bucket_rows(n)
    TP.require_block_rows(n * 16, 16)
    if n % 16:
        with pytest.raises(ValueError, match="multiple of block=16"):
            TP.require_block_rows(n, 16)
