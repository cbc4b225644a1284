"""The bf16 variant of the port's stats op (``kmeans_update_stats(...,
compute_dtype=torch.bfloat16)``, on the CPU its plain twin) against the JAX
package's ``kmeans_update_stats(..., compute_dtype=jnp.bfloat16)`` in
interpret mode, as ``tests/test_ops.py`` runs it: n = 512, d = 16, k = 8,
``block_n=128``, 17 trailing zero pad rows, every tie policy.

Both packages round the points and centroids to bf16 for the score
product and add its products in f32, so a row's scores differ between
them only in the order of those f32 sums.  The tests exempt the rows
whose f32 top-two score gap lies below the bf16 bound, the most the bf16
rounding can move a gap: each score ``-2 p.c + |c|^2`` moves by at most
``2 * 2^-8 * sum_j |p_j c_j|`` when ``p`` and ``c`` are rounded (relative
error 2^-9 each), so a gap by at most ``2^-6 * max_c sum_j |p_j c_j|``;
``1e-5 (1 + |best|)`` is added for the f32 sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_ml_tpu.ops import kmeans_pallas as JK
from flink_ml_tpu_torch.ops import kmeans as TK

N, D, K, N_PAD, BLOCK = 512, 16, 8, 17, 128
TIES = ("first", "fast", "split")
# sums: bf16 x bf16 products are exact in f32; only the f32 sums' order
# differs (a cluster sums ~60 rows of |p| ~ 1)
SUMS_TOL = dict(rtol=1e-5, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(centroids="distinct", seed=0, n=N, n_pad=N_PAD):
    """Points with ``n_pad`` trailing zero rows; ``"duplicated"``
    centroids hold an exact duplicate and two copies of the least-norm
    centroid (the zero pad rows tie on them)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, D)).astype(np.float32)
    pts[n - n_pad:] = 0.0
    cents = pts[:K].copy()
    if centroids == "duplicated":
        cents[0] *= 0.05
        cents[6] = cents[0]
        cents[7] = cents[2]
    return pts, cents


def _gap_exempt(pts, cents):
    """Rows whose f32 top-two score gap lies below the bf16 bound (module
    docstring)."""
    p64, c64 = pts.astype(np.float64), np.unique(cents, axis=0).astype(
        np.float64)
    scores = -2.0 * (p64 @ c64.T) + (c64 * c64).sum(1)[None, :]
    two = np.sort(scores, axis=1)[:, :2]
    bound = (2.0 ** -6 * (np.abs(p64) @ np.abs(c64).T).max(1)
             + 1e-5 * (1 + np.abs(two[:, 0])))
    return (two[:, 1] - two[:, 0]) <= bound


def _jax_stats(pts, cents, tie, n_pad):
    s, c = JK.kmeans_update_stats(jnp.asarray(pts), jnp.asarray(cents),
                                  block_n=BLOCK, tie_policy=tie,
                                  compute_dtype=jnp.bfloat16, interpret=True)
    c = JK.pad_correction(c, jnp.asarray(cents), n_pad, tie_policy=tie)
    return np.asarray(s), np.asarray(c)


def _port_stats(pts, cents, tie, n_pad):
    s, c = TK.kmeans_update_stats(_t(pts), _t(cents), tie_policy=tie,
                                  compute_dtype=torch.bfloat16)
    c = TK.pad_correction(c, _t(cents), n_pad, tie_policy=tie)
    return s.numpy(), c.numpy()


def _jax_assign(pts, cents):
    """The JAX kernel's bf16 scores (``kmeans_pallas.py:237-240``), first
    index of the row minimum."""
    p, c = jnp.asarray(pts), jnp.asarray(cents)
    c2 = jnp.sum(c * c, axis=1)[None, :]
    sc = -2.0 * jnp.dot(p.astype(jnp.bfloat16), c.astype(jnp.bfloat16).T,
                        preferred_element_type=jnp.float32) + c2
    return np.asarray(jnp.argmin(sc, axis=1))


@pytest.mark.parametrize("centroids", ["distinct", "duplicated"])
@pytest.mark.parametrize("tie", TIES)
def test_bf16_stats_match_pallas_interpret(tie, centroids):
    """Assignments equal off the exempt rows; on the rows that are not
    exempt (with the pad rows, padded to the block) counts are equal and
    sums within ``SUMS_TOL``; on all rows the counts move by at most 2 a
    flipped exempt row."""
    pts, cents = _problem(centroids)
    real = pts[:N - N_PAD]
    exempt = _gap_exempt(real, cents)
    assert exempt.sum() < 0.05 * len(real)
    ta = torch.argmin(TK._scores(_t(real), _t(cents), torch.bfloat16),
                      dim=1).numpy()
    np.testing.assert_array_equal(ta[~exempt], _jax_assign(real, cents)[
        ~exempt])

    js, jc = _jax_stats(pts, cents, tie, N_PAD)
    ts, tc = _port_stats(pts, cents, tie, N_PAD)
    assert np.abs(tc - jc).sum() <= 2 * exempt.sum()

    kept = real[~exempt]
    n_sub = -(-len(kept) // BLOCK) * BLOCK
    sub = np.zeros((n_sub, D), np.float32)
    sub[:len(kept)] = kept
    js, jc = _jax_stats(sub, cents, tie, n_sub - len(kept))
    ts, tc = _port_stats(sub, cents, tie, n_sub - len(kept))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, **SUMS_TOL)


def _wide_problem(d, k, n=N, n_pad=7, seed=0):
    """Past the fused plan (k > 256 or d > 64): points near k random
    centers, ``n_pad`` trailing zero rows, the centers as centroids with
    the least-norm one (centroid 0, scaled by 0.05) copied across the
    256-cluster boundary (to 257 at k 300, to 300 at k 600), so the zero
    pad rows and the rows nearest it tie across two slabs."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(k, d)).astype(np.float32)
    cents[0] *= 0.05
    cents[257 if k < 600 else 300] = cents[0]
    pts = (cents[rng.integers(k, size=n)]
           + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    pts[n - n_pad:] = 0.0
    return pts, cents


@pytest.mark.parametrize("d,k", [(128, 300), (72, 600)])
@pytest.mark.parametrize("tie", TIES)
def test_bf16_wide_stats_match_pallas_interpret(tie, d, k):
    """The shapes of ``kmeans_bf16.cu``'s two passes (``bf16_plan``
    route "two_pass"): the plain twin against the JAX kernel in interpret
    mode, n 512 with 7 zero pad rows and a centroid tied across the
    256-cluster boundary, under ``test_bf16_stats_match_pallas_interpret``'s
    checks and tolerances; the tied copies get equal counts and sums
    under ``fast`` and ``split``, the lower index all under ``first``."""
    assert TK.bf16_plan(k, d).route == "two_pass"
    n_pad = 7
    pts, cents = _wide_problem(d, k, n_pad=n_pad)
    real = pts[:N - n_pad]
    exempt = _gap_exempt(real, cents)
    assert exempt.sum() < 0.05 * len(real)
    ta = torch.argmin(TK._scores(_t(real), _t(cents), torch.bfloat16),
                      dim=1).numpy()
    np.testing.assert_array_equal(ta[~exempt], _jax_assign(real, cents)[
        ~exempt])

    js, jc = _jax_stats(pts, cents, tie, n_pad)
    ts, tc = _port_stats(pts, cents, tie, n_pad)
    assert np.abs(tc - jc).sum() <= 2 * exempt.sum()
    dup = 257 if k < 600 else 300
    if tie == "first":
        assert tc[dup] == 0 and jc[dup] == 0
    else:
        assert tc[dup] == tc[0] and jc[dup] == jc[0]
        np.testing.assert_array_equal(ts[dup], ts[0])

    kept = real[~exempt]
    n_sub = -(-len(kept) // BLOCK) * BLOCK
    sub = np.zeros((n_sub, d), np.float32)
    sub[:len(kept)] = kept
    js, jc = _jax_stats(sub, cents, tie, n_sub - len(kept))
    ts, tc = _port_stats(sub, cents, tie, n_sub - len(kept))
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ts, js, **SUMS_TOL)


@pytest.mark.parametrize("centroids", ["distinct", "duplicated"])
@pytest.mark.parametrize("tie", TIES)
def test_bf16_mass_conservation(tie, centroids):
    """The JAX test's invariants (``tests/test_ops.py:57-70``) on the
    port: every real row counts once in all (``split``, and ``first``
    exactly; ``fast`` counts a tied row on each tie), the sums' mass is the
    rows' bf16 mass, and the pad rows' correction leaves the counts of the
    real rows alone (no count negative)."""
    pts, cents = _problem(centroids)
    ts, tc = _port_stats(pts, cents, tie, N_PAD)
    real = pts[:N - N_PAD]
    assert tc.min() >= 0
    if tie != "fast":
        np.testing.assert_allclose(tc.sum(), N - N_PAD, atol=1e-3)
        np.testing.assert_allclose(ts.sum(0), real.sum(0), atol=0.3)
    s_real, c_real = _port_stats(real, cents, tie, 0)
    np.testing.assert_array_equal(tc, c_real)
    np.testing.assert_allclose(ts, s_real, **SUMS_TOL)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_split_share_enters_sums_as_bf16(which):
    """A row tied three ways: ``counts`` adds the f32 share 1/3, the sums
    the bf16 share 0.333984375 times the bf16 point.  (The zero pad rows
    land on the fourth centroid, the least norm.)"""
    pts = np.zeros((BLOCK, 2), np.float32)
    pts[0] = [1.2345678, -3.3333333]
    cents = np.array([[1.0, -3.0]] * 3 + [[0.1, 0.1]], np.float32)
    stats = _port_stats if which == "port" else _jax_stats
    s, c = stats(pts, cents, "split", BLOCK - 1)
    share32 = np.float32(1.0) / np.float32(3.0)
    bf = np.asarray(torch.tensor(pts[0]).to(torch.bfloat16).float())
    np.testing.assert_array_equal(c[:3], [share32] * 3)
    np.testing.assert_array_equal(s[:3], [np.float32(0.333984375) * bf] * 3)
    assert c[3] == 0


@pytest.mark.parametrize("which", ["port", "jax"])
def test_norms_come_from_the_unrounded_centroids(which):
    """Two centroids that round to one bf16 vector but differ in f32: the
    scores' ``|c|^2`` is the f32 norm of each, so the point goes to the
    second (the smaller norm), not to the first index of a tie."""
    cents = np.array([[1.0 + 2.0 ** -9, 0.0], [1.0 + 2.0 ** -10, 0.0],
                      [-9.0, -9.0]], np.float32)
    assert np.array_equal(_t(cents[0]).bfloat16().float().numpy(),
                          _t(cents[1]).bfloat16().float().numpy())
    pts = np.zeros((BLOCK, 2), np.float32)
    pts[0] = [1.0, 0.0]
    stats = _port_stats if which == "port" else _jax_stats
    _, c = stats(pts, cents, "first", BLOCK - 1)
    np.testing.assert_array_equal(c, [0.0, 1.0, 0.0])


def test_bf16_wrapper_checks():
    pts, cents = _problem()
    with pytest.raises(ValueError, match="compute_dtype"):
        TK.kmeans_update_stats(_t(pts), _t(cents),
                               compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        TK.kmeans_update_stats_plain(_t(pts), _t(cents),
                                     compute_dtype=torch.float64)
    s, c = TK.kmeans_update_stats(_t(pts), _t(cents),
                                  compute_dtype=torch.bfloat16)
    assert s.dtype == c.dtype == torch.float32
    assert TK.LAUNCHES["kmeans_update_stats_bf16"] == 0   # the CPU twin
