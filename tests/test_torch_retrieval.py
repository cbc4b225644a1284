"""The port's IVF / IVF-PQ index (``flink_ml_tpu_torch.retrieval``) against
the JAX package's on seeded numpy data: the numpy build helpers array for
array, whole builds, searches of the same index through both packages, the
quality gates of ``tests/test_kernels.py:587-616`` and the behaviours of
``tests/test_retrieval.py`` (validation, padding, short lists, PQ tables,
option views, delta and re-anchor updates, recall probes).  The port runs
on the CPU (its kernel wrappers take their plain versions there)."""

import functools

import jax
import numpy as np
import pytest
import torch

import flink_ml_tpu_torch as T
from flink_ml_tpu.parallel.mesh import device_mesh, use_mesh
from flink_ml_tpu.retrieval import IVFIndex as JIVF
from flink_ml_tpu.retrieval import PQConfig as JPQ
from flink_ml_tpu.retrieval import ivf as JI
from flink_ml_tpu.retrieval import metrics as JM
from flink_ml_tpu_torch.retrieval import ivf as TI
from flink_ml_tpu_torch.retrieval import (RecallProbe, exact_neighbors,
                                          recall_at_k)
from flink_ml_tpu_torch.utils.convert import ivf_index_from_jax

RECALL_FLOOR = 0.95
SCAN_BUDGET = 0.25


def _one_device():
    return use_mesh(device_mesh({"data": 1}, devices=jax.devices()[:1]))


def _gaussian(n=600, d=32, seed=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _clustered(n=2048, d=16, nclusters=64, seed=4, spread=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(nclusters, d)).astype(np.float32) * 10.0
    assign = rng.integers(0, nclusters, size=n)
    return (centers[assign] + rng.normal(size=(n, d)) * spread
            ).astype(np.float32)


def _queries_near(X, count, seed=5, jitter=0.05):
    rng = np.random.default_rng(seed)
    pick = rng.choice(X.shape[0], size=count, replace=False)
    return (X[pick] + rng.normal(size=(count, X.shape[1])) * jitter
            ).astype(np.float32)


def _build(X, nlist, **kw):
    return T.IVFIndex.build(X, nlist, device="cpu", **kw)


# the fixtures of tests/test_kernels.py:528-552 (numpy seed 19)
@functools.lru_cache(maxsize=None)
def _fixture(kind):
    rng = np.random.default_rng(19)
    if kind in ("flat-small", "pq-small"):
        X = rng.normal(size=(600, 32)).astype(np.float32)
        kw = dict(nlist=8, k=10, nprobe=4, seed=1)
        pq = (16 if kind == "pq-small" else None)
        q = rng.normal(size=(16, 32)).astype(np.float32)
    else:
        centers = rng.normal(size=(64, 16)).astype(np.float32) * 10.0
        assign = rng.integers(0, 64, size=2048)
        X = (centers[assign] + rng.normal(size=(2048, 16)) * 0.5
             ).astype(np.float32)
        kw = dict(nlist=64, k=10, nprobe=8, seed=2)
        pq = None
        pick = rng.choice(2048, size=32, replace=False)
        q = (X[pick] + rng.normal(size=(32, 16)) * 0.05).astype(np.float32)
    with _one_device():
        jidx = JIVF.build(X, pq=None if pq is None else JPQ(m=8, ksub=pq),
                          **kw)
    tidx = _build(X, pq=None if pq is None else T.PQConfig(m=8, ksub=pq),
                  **kw)
    return X, q, jidx, tidx


def _port_of(jidx):
    return ivf_index_from_jax(
        jidx.params, nlist=jidx.nlist, block=jidx.block, dim=jidx.dim,
        k=jidx.k, nprobe=jidx.nprobe, pq=jidx.pq, seed=jidx.seed,
        list_slack=jidx.list_slack, drift_threshold=jidx.drift_threshold,
        max_iter=jidx.max_iter, stored=jidx.stored_vectors(), device="cpu")


# -- host helpers, array for array -------------------------------------------

def test_nearest_list_and_round_up_match_jax():
    X = _gaussian(500, 16, seed=40)
    c = _gaussian(9, 16, seed=41)
    c[3] = c[5]                              # a tie: first index wins
    np.testing.assert_array_equal(TI._nearest_list(c, X),
                                  JI._nearest_list(c, X))
    for n in (0, 1, 7, 8, 9, 1008):
        assert TI._round_up8(n) == JI._round_up8(n)


@pytest.mark.parametrize("rounds", [None, 0, 3])
def test_refine_balance_matches_jax(rounds):
    X = _clustered(n=1500, d=8, nclusters=20, seed=42)
    # a lopsided start: every centroid but two in one corner
    c = np.concatenate([X[:2], X[2:3] + _gaussian(14, 8, seed=43) * 1e-3])
    np.testing.assert_array_equal(TI._refine_balance(c, X, rounds),
                                  JI._refine_balance(c, X, rounds))


def test_pack_blocks_and_encode_pq_match_jax():
    X = _gaussian(90, 8, seed=44)
    assign = np.random.default_rng(45).integers(0, 5, 90)
    assign[assign == 3] = 2                  # list 3 stays empty
    rows_of = [np.flatnonzero(assign == lst) for lst in range(5)]
    for dtype, width in ((np.float32, 8), (np.int8, 8)):
        rows = X if dtype == np.float32 else (X * 10).astype(np.int8)
        np.testing.assert_array_equal(
            TI._pack_blocks(rows, rows_of, 48, width, dtype),
            JI._pack_blocks(rows, rows_of, 48, width, dtype))
    cb_q = np.random.default_rng(46).integers(-127, 128, (4, 6, 2)).astype(
        np.int8)
    cb_s = np.random.default_rng(47).random((4, 6)).astype(np.float32) / 50
    np.testing.assert_array_equal(TI._encode_pq(X, cb_q, cb_s),
                                  JI._encode_pq(X, cb_q, cb_s))


# -- builds against the JAX package ------------------------------------------

@pytest.mark.parametrize("kind", ["flat-small", "pq-small"])
def test_build_matches_jax(kind):
    """The plain workset KMeans of the port reproduces the JAX fit on these
    fixtures, and the host helpers are the same numpy, so the built params
    come out array for array equal."""
    _, _, jidx, tidx = _fixture(kind)
    assert set(tidx.params) == set(jidx.params)
    for name, arr in jidx.params.items():
        assert tidx.params[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(tidx.params[name], arr, err_msg=name)
    assert (tidx.block, tidx.nlist, tidx.dim, tidx.nprobe, tidx.k) == (
        jidx.block, jidx.nlist, jidx.dim, jidx.nprobe, jidx.k)
    for a, b in zip(tidx.stored_vectors(), jidx.stored_vectors()):
        np.testing.assert_array_equal(a, b)
    assert tidx.sig() == jidx.sig()
    assert tidx.centroid_drift() == pytest.approx(jidx.centroid_drift(),
                                                  rel=1e-12)
    assert set(tidx.build_times) >= {"coarse_fit_s", "balance_assign_s",
                                     "pack_encode_s"}


def _members(idx):
    return {int(v): lst for lst in range(idx.nlist)
            for v in idx.params["ids"][lst, :idx.params["counts"][lst]]}


def _inertia(idx, X):
    c = idx.params["centroids"].astype(np.float64)
    m = _members(idx)
    return float(np.mean([np.sum((X[i] - c[m[i]]) ** 2)
                          for i in range(X.shape[0])]))


def test_build_near_jax_on_clustered():
    """On the clustered fixture the two fits part: the plain fit and JAX's
    XLA body add the cluster sums in different orders (~1e-6 apart), and
    one near-tie point lands in another cluster, moving two centroids by
    up to 0.07.  So there the gate is: the same block, at most 1% of the
    vectors in another list, list counts within 1, the objective within
    1e-5 relative."""
    X, _, jidx, tidx = _fixture("clustered")
    assert tidx.block == jidx.block
    a, b = _members(tidx), _members(jidx)
    assert sum(a[i] != b[i] for i in a) <= 0.01 * X.shape[0]
    assert np.abs(tidx.params["counts"] - jidx.params["counts"]).max() <= 1
    assert _inertia(tidx, X) == pytest.approx(_inertia(jidx, X), rel=1e-5)


@pytest.mark.parametrize("kind", ["flat-small", "pq-small", "clustered"])
def test_search_matches_jax_search(kind):
    """The slice end to end: ``transform`` through both packages on the
    same (carried) index gives the same ids and distances to f32
    rounding."""
    _, q, jidx, _ = _fixture(kind)
    tidx = _port_of(jidx)
    with _one_device():
        jout = jidx.transform(T.Table({"query": q}))[0]
    tout = tidx.transform(T.Table({"query": q}))[0]
    np.testing.assert_array_equal(tout["neighbors"], jout["neighbors"])
    assert tout["neighbors"].dtype == np.int64
    assert tout["distances"].dtype == np.float32
    # f32 rounding of the same expression in another order: PQ rtol 1e-5,
    # flat 1e-5 (|q|^2 + max|x|^2) of a row
    if tidx.pq is None:
        x2 = np.max(np.sum(tidx.params["vecs"].astype(np.float64) ** 2, 1))
        scale = np.sum(q.astype(np.float64) ** 2, 1)[:, None] + x2
        assert np.all(np.abs(tout["distances"] - jout["distances"])
                      <= 1e-5 * scale)
    else:
        np.testing.assert_allclose(tout["distances"], jout["distances"],
                                   rtol=1e-5)
    np.testing.assert_array_equal(tout["query"], q)


# -- quality gates (tests/test_kernels.py:587-616) ----------------------------

def test_full_probe_equals_float64_oracle():
    _, q, _, idx = _fixture("flat-small")
    ids, X = idx.stored_vectors()
    nn, dist = idx.search(q, nprobe=idx.nlist)
    np.testing.assert_array_equal(nn, exact_neighbors(q, X, ids, idx.k))
    assert np.all(np.diff(dist, axis=1) >= 0), "distances not ascending"


def test_recall_envelope_at_bounded_scan():
    _, q, _, idx = _fixture("clustered")
    frac = idx.scan_fraction(q)
    assert frac <= SCAN_BUDGET, f"scan fraction {frac} over budget"
    ids, X = idx.stored_vectors()
    nn, _ = idx.search(q)
    rec = recall_at_k(nn, exact_neighbors(q, X, ids, idx.k))
    assert rec >= RECALL_FLOOR, f"recall {rec} (scan fraction {frac})"


def test_pq_recall_on_the_bench_corpus_recipe_matches_jax():
    """The retrieval bench's corpus recipe (``bench.py:4208-4213``: masses
    of 32 points, centers N(0,1) * 10, noise 0.3, d 64, numpy seed 77) cut
    to 4096 points in 16 lists (the bench's 16 masses a list): the port's
    IVF-PQ build (m 8, ksub 16) recalls what the JAX package's does at
    nprobe 1, 2 and 4, within 0.02 (one query's worth of slots, should
    the fits part on a near tie), while the flat index clears the
    acceptance recall."""
    rng = np.random.default_rng(77)
    n, d = 4096, 64
    centers = rng.normal(size=(n // 32, d)).astype(np.float32) * 10.0
    X = (np.repeat(centers, 32, axis=0)
         + rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    q = (X[rng.choice(n, size=64, replace=False)]
         + rng.normal(size=(64, d)) * 0.05).astype(np.float32)
    exact = exact_neighbors(q, X, np.arange(n), 10)
    with _one_device():
        jidx = JIVF.build(X, 16, pq=JPQ(m=8, ksub=16), k=10, seed=1)
        jrec = [recall_at_k(jidx.search(q, nprobe=p)[0], exact)
                for p in (1, 2, 4)]
    tidx = _build(X, 16, pq=T.PQConfig(m=8, ksub=16), k=10, seed=1)
    trec = [recall_at_k(tidx.search(q, nprobe=p)[0], exact)
            for p in (1, 2, 4)]
    np.testing.assert_allclose(trec, jrec, atol=0.02)
    flat = _build(X, 16, k=10, nprobe=2, seed=1)
    assert recall_at_k(flat.search(q)[0], exact) >= RECALL_FLOOR


# -- behaviours of tests/test_retrieval.py ------------------------------------

def test_build_validation_is_loud():
    X = _gaussian(n=64, d=8)
    with pytest.raises(ValueError, match="nlist"):
        _build(X, nlist=65)
    with pytest.raises(ValueError, match="non-empty"):
        _build(np.zeros((0, 8), np.float32), nlist=1)
    with pytest.raises(ValueError, match="unique"):
        _build(X, nlist=4, ids=np.zeros(64, np.int32))
    with pytest.raises(ValueError, match="non-negative"):
        _build(X, nlist=4, ids=np.arange(64) - 1)
    with pytest.raises(ValueError, match="must divide"):
        _build(X, nlist=4, pq=T.PQConfig(m=3))
    with pytest.raises(ValueError, match="ksub"):
        _build(X, nlist=4, pq=T.PQConfig(m=4, ksub=200))
    with pytest.raises(ValueError, match="block"):
        _build(X, nlist=2, block=8)


def test_posting_lists_honor_padding_contract():
    X = _gaussian(n=300, d=16, seed=7)
    idx = _build(X, nlist=8, k=5, seed=1)
    ids2, counts = idx.params["ids"], idx.params["counts"]
    assert idx.block % 8 == 0 and ids2.shape == (8, idx.block)
    assert idx.num_vectors == 300 and counts.sum() == 300
    assert idx.offsets[-1] == 300
    vecs = idx.params["vecs"].reshape(8, idx.block, 16)
    for lst in range(8):
        c = int(counts[lst])
        assert np.all(ids2[lst, :c] >= 0) and np.all(ids2[lst, c:] == -1)
        assert np.all(vecs[lst, c:] == 0.0)
    sids, svecs = idx.stored_vectors()
    np.testing.assert_array_equal(sids, np.arange(300))
    np.testing.assert_array_equal(svecs, X)


def test_full_probe_search_reports_squared_l2():
    X = _gaussian(n=500, d=24, seed=8)
    idx = _build(X, nlist=8, k=10, seed=2)
    q = _gaussian(n=20, d=24, seed=9)
    nn, dist = idx.search(q, nprobe=idx.nlist)
    np.testing.assert_array_equal(nn, exact_neighbors(q, X, np.arange(500),
                                                      10))
    assert nn.dtype == np.int64 and dist.dtype == np.float32
    d2 = np.sum((q[:, None, :] - X[nn]) ** 2, axis=-1)
    np.testing.assert_allclose(dist, d2, rtol=1e-4, atol=1e-3)


def test_acceptance_recall_at_bounded_scan():
    X = _clustered()
    idx = _build(X, nlist=64, k=10, nprobe=8, seed=3)
    q = _queries_near(X, 48)
    frac = idx.scan_fraction(q)
    assert 0.0 < frac <= SCAN_BUDGET, f"scan fraction {frac}"
    nn, _ = idx.search(q)
    rec = recall_at_k(nn, exact_neighbors(q, X, np.arange(X.shape[0]), 10))
    assert rec >= RECALL_FLOOR, f"recall {rec} at scan fraction {frac}"
    assert idx.scan_fraction(q, nprobe=idx.nlist) == pytest.approx(1.0)


def test_short_lists_pad_with_minus_one_never_fake_ids():
    X = _gaussian(n=12, d=8, seed=10)
    idx = _build(X, nlist=4, k=10, nprobe=1, seed=4)
    q = _gaussian(n=6, d=8, seed=11)
    nn, dist = idx.search(q)
    assert int(idx.params["counts"].max()) < 10
    for row_nn, row_d in zip(nn, dist):
        real = row_nn >= 0
        assert np.all(np.isfinite(row_d[real]))
        assert np.all(np.isinf(row_d[~real]))
        assert not np.any(np.diff(real.astype(int)) > 0)


def test_pq_adc_distances_match_explicit_reconstruction():
    X = _gaussian(n=400, d=32, seed=12)
    idx = _build(X, nlist=4, k=8, pq=T.PQConfig(m=8, ksub=16), seed=5)
    q = _gaussian(n=10, d=32, seed=13)
    nn, dist = idx.search(q, nprobe=idx.nlist)
    cb_q, cb_s = idx.params["cb_q"], idx.params["cb_s"]
    decoded = cb_q.astype(np.float32) * cb_s[..., None]
    codes = idx.params["codes"].reshape(idx.nlist, idx.block, -1)
    ids2 = idx.params["ids"]
    recon = {}
    for lst in range(idx.nlist):
        for j in range(int(idx.params["counts"][lst])):
            parts = [decoded[s, int(codes[lst, j, s])]
                     for s in range(cb_q.shape[0])]
            recon[int(ids2[lst, j])] = (idx.params["centroids"][lst]
                                        + np.concatenate(parts))
    for qi in range(q.shape[0]):
        for slot in range(nn.shape[1]):
            d2 = float(np.sum((q[qi] - recon[int(nn[qi, slot])]) ** 2,
                              dtype=np.float64))
            assert dist[qi, slot] == pytest.approx(d2, rel=1e-4, abs=1e-3)


def test_search_plan_and_option_views():
    X = _gaussian(n=200, d=16, seed=15)
    idx = _build(X, nlist=8, k=5, seed=7)
    plan = idx.search_plan()
    assert plan.sig == idx.sig() and plan.backend == "plain"   # CPU index
    view = idx.with_options(nprobe=8, k=3)
    assert (view.nprobe, view.k) == (8, 3)
    assert view.params is idx.params
    assert (idx.nprobe, idx.k) != (8, 3)
    with pytest.raises(ValueError, match="nprobe"):
        idx.with_options(nprobe=9)
    with pytest.raises(TypeError, match="query"):
        idx.transform(T.Table({"wrong": X}))
    with pytest.raises(TypeError, match="query"):
        idx.transform(T.Table({"query": np.array(["a"] * 4)}))
    # the chain terminal is ported: a kernel for a numeric query column
    kernel = idx.transform_kernel(T.Table({"query": X}).schema())
    assert kernel.post is not None and kernel.consumes == ("query",)
    assert idx.transform_kernel(T.Table({"wrong": X}).schema()) is None
    # a view serves the same device copy; plain=True equals the wrapper
    # path on the CPU
    assert view.device_params() is idx.device_params()
    a = idx.search(X[:6], nprobe=3)
    b = idx.search(X[:6], nprobe=3, plain=True)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_updated_delta_insert_and_delete_match_jax():
    """Swap-remove deletes and free-slot inserts give the JAX package's
    params array for array, and the new lists serve at once."""
    X = _gaussian(n=160, d=8, seed=16)
    with _one_device():
        jidx = JIVF.build(X, nlist=4, k=5, seed=8, drift_threshold=None)
    idx = _port_of(jidx)
    q = _gaussian(n=8, d=8, seed=18)
    idx.search(q)                            # a device copy of the old lists
    before = {k: v.copy() for k, v in idx.params.items()}
    new_vecs = _gaussian(n=3, d=8, seed=17) * 0.5
    mode, nxt = idx.updated(inserts=new_vecs, delete_ids=[0, 7])
    jmode, jnxt = jidx.updated(inserts=new_vecs, delete_ids=[0, 7])
    assert mode == jmode == "delta"
    for name, arr in jnxt.params.items():
        np.testing.assert_array_equal(nxt.params[name], arr, err_msg=name)
    for name, arr in before.items():
        np.testing.assert_array_equal(idx.params[name], arr)
    assert nxt.num_vectors == 160 + 3 - 2
    sids, svecs = nxt.stored_vectors()
    assert 0 not in sids and 7 not in sids
    for off, vid in enumerate(range(160, 163)):
        np.testing.assert_array_equal(svecs[np.searchsorted(sids, vid)],
                                      new_vecs[off])
    nn, _ = nxt.search(q, nprobe=nxt.nlist)
    np.testing.assert_array_equal(nn, exact_neighbors(q, svecs, sids,
                                                      nxt.k))
    found, _ = nxt.search(new_vecs, nprobe=nxt.nlist, k=1)
    np.testing.assert_array_equal(found[:, 0], [160, 161, 162])
    assert nxt.device_params() is not idx.device_params()
    with pytest.raises(KeyError, match="delete id"):
        nxt.updated(delete_ids=[0])
    with pytest.raises(ValueError, match="already live"):
        nxt.updated(inserts=new_vecs[:1], insert_ids=[161])


def test_pq_delta_insert_encodes_like_jax():
    X = _gaussian(n=200, d=16, seed=50)
    with _one_device():
        jidx = JIVF.build(X, nlist=4, k=5, seed=9, drift_threshold=None,
                          pq=JPQ(m=4, ksub=8))
    idx = _port_of(jidx)
    ins = _gaussian(n=4, d=16, seed=51)
    mode, nxt = idx.updated(inserts=ins, delete_ids=[3])
    _, jnxt = jidx.updated(inserts=ins, delete_ids=[3])
    assert mode == "delta"
    for name, arr in jnxt.params.items():
        np.testing.assert_array_equal(nxt.params[name], arr, err_msg=name)


def test_rebound_serves_the_new_lists():
    X = _gaussian(n=120, d=8, seed=24)
    idx = _build(X, nlist=4, k=5, seed=11, drift_threshold=None)
    q = _gaussian(n=6, d=8, seed=26)
    idx.search(q)
    _, nxt = idx.updated(inserts=_gaussian(n=2, d=8, seed=25))
    rebound = idx.rebound(nxt.params)
    assert isinstance(rebound, T.IVFIndex)
    assert rebound.params is not idx.params
    np.testing.assert_array_equal(rebound.search(q)[0], nxt.search(q)[0])
    np.testing.assert_array_equal(
        rebound.device_params()["ids"].numpy(), nxt.params["ids"])


def test_updated_overflow_reanchors_with_full_corpus():
    X = _gaussian(n=40, d=8, seed=19)
    idx = _build(X, nlist=4, k=5, seed=9, list_slack=0,
                 drift_threshold=None)
    target = X[int(np.argmax(np.bincount(
        np.argmin(np.sum((X[:, None, :] - idx.params["centroids"]) ** 2,
                         axis=-1), axis=1))))]
    flood = target[None, :] + _gaussian(n=idx.block + 4, d=8, seed=20) * 0.01
    mode, nxt = idx.updated(inserts=flood)
    assert mode == "reanchor"
    assert nxt.num_vectors == 40 + idx.block + 4
    assert nxt.device == "cpu"
    sids, svecs = nxt.stored_vectors()
    q = _gaussian(n=4, d=8, seed=21)
    nn, _ = nxt.search(q, nprobe=nxt.nlist)
    np.testing.assert_array_equal(nn, exact_neighbors(q, svecs, sids,
                                                      nxt.k))


def test_updated_drift_reanchors():
    X = _gaussian(n=120, d=8, seed=22)
    idx = _build(X, nlist=4, k=5, seed=10, drift_threshold=1e-6)
    assert idx.centroid_drift() >= 0.0
    mode, nxt = idx.updated(inserts=_gaussian(n=6, d=8, seed=23) + 4.0)
    assert mode == "reanchor"
    assert nxt.num_vectors == 126


class _Sink:
    recall_probe = float("nan")

    def on_recall_probe(self, value):
        self.recall_probe = value


def test_recall_probe_scores_and_publishes():
    X = _clustered(n=1024, d=16, nclusters=32, seed=32)
    idx = _build(X, nlist=32, k=10, nprobe=32, seed=4)
    q = _queries_near(X, 16, seed=33)
    out = idx.transform(T.Table({"query": q}))[0]
    probe = RecallProbe(idx, sample=1.0)
    assert np.isnan(probe.value)
    batch = probe.observe(q, neighbors=out["neighbors"])
    assert batch == 1.0 and probe.value == 1.0
    assert probe.observe(q) == 1.0           # the probe searches itself
    sink = _Sink()
    assert probe.publish(sink) == 1.0 and sink.recall_probe == 1.0
    mean, count = probe.reset()
    assert mean == 1.0 and count == 320 and np.isnan(probe.value)


def test_recall_probe_validates_sample():
    X = _gaussian(n=64, d=8, seed=34)
    idx = _build(X, nlist=4, k=5, seed=5)
    with pytest.raises(ValueError, match="sample"):
        RecallProbe(idx, sample=0.0)
    probe = RecallProbe(idx, sample=1e-12, seed=1)
    assert probe.observe(X[:4]) is None
    assert np.isnan(probe.value)


def test_recall_at_k_and_exact_neighbors_match_jax():
    found = np.array([[1, 2, -1], [9, 9, 9]])
    expected = np.array([[1, 2, 3], [7, 8, 9]])
    assert recall_at_k(found, expected) == pytest.approx((2 + 1) / 6)
    assert recall_at_k(found, expected) == JM.recall_at_k(found, expected)
    assert recall_at_k(np.zeros((0, 3)), np.zeros((0, 3))) == 1.0
    with pytest.raises(ValueError, match="matching n"):
        recall_at_k(found, expected[:1])
    out = exact_neighbors(np.zeros((2, 4)), np.zeros((1, 4)),
                          np.array([5]), k=3)
    np.testing.assert_array_equal(out, [[5, -1, -1], [5, -1, -1]])
    X, q = _gaussian(50, 6, seed=60), _gaussian(7, 6, seed=61)
    np.testing.assert_array_equal(
        exact_neighbors(q, X, np.arange(50) * 3, 4),
        JM.exact_neighbors(q, X, np.arange(50) * 3, 4))
    np.testing.assert_array_equal(
        exact_neighbors(q, np.zeros((0, 6)), np.zeros(0), 2),
        np.full((7, 2), -1))


def test_index_runs_on_the_card_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = _gaussian(n=64, d=8)
    with pytest.raises(RuntimeError, match="no GPU"):
        T.IVFIndex.build(X, nlist=4)
    idx = _build(X, nlist=4, k=3)
    idx.device = "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        idx.search(X[:2])
