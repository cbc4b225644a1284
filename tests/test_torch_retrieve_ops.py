"""The port's retrieve ops (``flink_ml_tpu_torch/ops/retrieve.py``, on the
CPU their plain versions) against the JAX package's fused Pallas kernels
in interpret mode and its jitted XLA stage, on indexes built by the JAX
package and carried across with ``ivf_index_from_jax``: the fixtures of
``tests/test_kernels.py:528-552`` (numpy seed 19) plus a duplicated corpus
(exact ties) and lists shorter than k.  Also the shared distance helpers,
the kernel's shape limits and the int8 row quantizer.

Tolerances: ids equal; flat distances within 1e-5 (|q|^2 + max|x|^2) of a
row (the plain version sums left to right, XLA in its own order: f32
rounding of the same expression at that scale); PQ distances rtol 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_ml_tpu.kernels import quantize as JQ
from flink_ml_tpu.kernels.registry import lookup
from flink_ml_tpu.ops.retrieve_pallas import (retrieve_flat_fused,
                                              retrieve_pq_fused)
from flink_ml_tpu.parallel.mesh import device_mesh, use_mesh
from flink_ml_tpu.retrieval import IVFIndex as JIVF
from flink_ml_tpu.retrieval import PQConfig as JPQ
from flink_ml_tpu.retrieval import ivf as JI
from flink_ml_tpu_torch.kernels import quantize as TQ
from flink_ml_tpu_torch.ops import retrieve as TR
from flink_ml_tpu_torch.utils.convert import ivf_index_from_jax


def _one_device():
    return use_mesh(device_mesh({"data": 1}, devices=jax.devices()[:1]))


@functools.lru_cache(maxsize=None)
def _fixture(kind):
    """(JAX index, queries) per shape class, built once per worker."""
    rng = np.random.default_rng(19)
    with _one_device():
        if kind in ("flat-small", "pq-small"):
            X = rng.normal(size=(600, 32)).astype(np.float32)
            pq = JPQ(m=8, ksub=16) if kind == "pq-small" else None
            idx = JIVF.build(X, nlist=8, k=10, nprobe=4, seed=1, pq=pq)
            q = rng.normal(size=(16, 32)).astype(np.float32)
        elif kind == "clustered":
            centers = rng.normal(size=(64, 16)).astype(np.float32) * 10.0
            assign = rng.integers(0, 64, size=2048)
            X = (centers[assign]
                 + rng.normal(size=(2048, 16)) * 0.5).astype(np.float32)
            idx = JIVF.build(X, nlist=64, k=10, nprobe=8, seed=2)
            pick = rng.choice(2048, size=32, replace=False)
            q = (X[pick] + rng.normal(size=(32, 16)) * 0.05).astype(
                np.float32)
        elif kind in ("dup-flat", "dup-pq"):
            # every row twice: exact distance ties inside each list
            base = rng.normal(size=(150, 16)).astype(np.float32)
            X = np.concatenate([base, base])
            pq = JPQ(m=4, ksub=8) if kind == "dup-pq" else None
            idx = JIVF.build(X, nlist=4, k=12, nprobe=2, seed=3, pq=pq)
            q = (base[:12] + rng.normal(size=(12, 16)) * 0.01).astype(
                np.float32)
        elif kind in ("short", "pq-short"):   # every list shorter than k
            X = rng.normal(size=(12, 8)).astype(np.float32)
            pq = JPQ(m=2, ksub=4) if kind == "pq-short" else None
            idx = JIVF.build(X, nlist=4, k=10, nprobe=1, seed=4, pq=pq)
            q = rng.normal(size=(6, 8)).astype(np.float32)
        elif kind == "pq-ksub2":       # two entries a subspace: many ties
            X = rng.normal(size=(400, 16)).astype(np.float32)
            idx = JIVF.build(X, nlist=8, k=10, nprobe=2, seed=5,
                             pq=JPQ(m=4, ksub=2))
            q = rng.normal(size=(16, 16)).astype(np.float32)
        else:
            raise AssertionError(kind)
    return idx, q


def _port(jidx):
    return ivf_index_from_jax(
        jidx.params, nlist=jidx.nlist, block=jidx.block, dim=jidx.dim,
        k=jidx.k, nprobe=jidx.nprobe, pq=jidx.pq, seed=jidx.seed,
        list_slack=jidx.list_slack, drift_threshold=jidx.drift_threshold,
        max_iter=jidx.max_iter, stored=jidx.stored_vectors(), device="cpu")


def _jax_runs(jidx, q, nprobe, pallas=True):
    """{"pallas": (nn, d), "xla": (nn, d)} of the JAX package at nprobe
    (the Pallas kernel in interpret mode only where ``pallas``)."""
    view = jidx.with_options(nprobe=nprobe)
    p = {k: jnp.asarray(v) for k, v in view.params.items()}
    qd = jnp.asarray(q)
    entry = lookup("retrieve", sig=view.sig(), backend="xla")
    static = view._static()
    out = jax.jit(lambda pp, c: entry.fn(static, pp, c))(
        p, {view.query_col: qd})
    runs = {"xla": (np.asarray(out[JI._NN_STAGE]),
                    np.asarray(out[JI._DIST_STAGE]))}
    if not pallas:
        return runs
    shape = dict(nprobe=nprobe, k=view.k, nlist=view.nlist, block=view.block)
    if view.pq is None:
        fused = retrieve_flat_fused(qd, p["centroids"], p["ids"], p["vecs"],
                                    interpret=True, **shape)
    else:
        fused = retrieve_pq_fused(qd, p["centroids"], p["ids"], p["codes"],
                                  p["cb_q"], p["cb_s"], m=view.pq.m,
                                  interpret=True, **shape)
    runs["pallas"] = tuple(np.asarray(a) for a in fused)
    return runs


def _port_run(tidx, q, nprobe):
    view = tidx.with_options(nprobe=nprobe)
    nn, dist = view.search_tensors(torch.from_numpy(q))
    return nn.numpy(), dist.numpy()


def _assert_close(kind, tidx, q, got, want, what):
    nn, dist = got
    np.testing.assert_array_equal(nn, want[0], err_msg=f"{kind} {what} ids")
    assert nn.dtype == np.int32 and dist.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(dist), np.isinf(want[1]))
    fin = np.isfinite(want[1])
    if tidx.pq is None:
        x2 = np.max(np.sum(tidx.params["vecs"].astype(np.float64) ** 2, 1))
        scale = np.sum(q.astype(np.float64) ** 2, 1)[:, None] + x2
        err = np.abs(dist[fin] - want[1][fin])
        assert np.all(err <= 1e-5 * np.broadcast_to(scale, dist.shape)[fin]), \
            f"{kind} {what} distances off by {err.max()}"
    else:
        np.testing.assert_allclose(dist[fin], want[1][fin], rtol=1e-5,
                                   atol=0, err_msg=f"{kind} {what}")


@pytest.mark.parametrize("kind", ["flat-small", "pq-small", "clustered",
                                  "dup-flat", "dup-pq", "short"])
@pytest.mark.parametrize("nprobe", ["1", "4", "nlist"])
def test_plain_matches_pallas_and_xla(kind, nprobe):
    jidx, q = _fixture(kind)
    nprobe = jidx.nlist if nprobe == "nlist" else min(int(nprobe),
                                                      jidx.nlist)
    tidx = _port(jidx)
    got = _port_run(tidx, q, nprobe)
    # the interpreted Pallas kernel unrolls its merge per probe: at 64
    # probes it takes a minute, so the clustered full probe holds the port
    # to the XLA stage alone (the two JAX backends are bit-equal)
    pallas = not (kind == "clustered" and nprobe == jidx.nlist)
    for backend, want in _jax_runs(jidx, q, nprobe, pallas).items():
        _assert_close(kind, tidx, q, got, want, f"nprobe {nprobe} vs "
                      f"{backend}")


def test_short_results_carry_minus_one_at_inf():
    jidx, q = _fixture("short")
    nn, dist = _port_run(_port(jidx), q, 1)
    assert np.any(nn == -1)
    np.testing.assert_array_equal(nn == -1, np.isinf(dist))
    # a -1 slot never precedes a real id
    assert not np.any(np.diff((nn >= 0).astype(int), axis=1) > 0)


def test_k_past_every_candidate_pads_the_tail():
    """k larger than nprobe * block: the tail is -1 at +inf, after every
    real candidate and every pad slot."""
    jidx, q = _fixture("short")
    tidx = _port(jidx)
    k = tidx.block + 5
    p = tidx.device_params()
    nn, dist = TR.retrieve_flat(torch.from_numpy(q), p["centroids"],
                                p["ids"], p["vecs"], nprobe=1, k=k,
                                nlist=tidx.nlist, block=tidx.block)
    assert nn.shape == (q.shape[0], k)
    assert torch.all(nn[:, tidx.block:] == -1)
    assert torch.all(torch.isinf(dist[:, tidx.block:]))
    short, _ = _port_run(tidx, q, 1)
    np.testing.assert_array_equal(nn[:, :tidx.k].numpy(), short)


def test_duplicated_rows_come_out_in_flat_position_order():
    """Exact ties: the copy at the lower flat position (probe rank, then
    row) comes first, as lax.top_k orders them."""
    jidx, q = _fixture("dup-flat")
    tidx = _port(jidx)
    nn, dist = _port_run(tidx, q, tidx.nlist)
    ties = 0
    pos = {}
    for lst in range(tidx.nlist):
        for j, vid in enumerate(tidx.params["ids"][lst]):
            pos[int(vid)] = (lst, j)
    for row in range(q.shape[0]):
        probes = TR.select_probes(torch.from_numpy(q[row:row + 1]),
                                  torch.from_numpy(
                                      tidx.params["centroids"]),
                                  tidx.nlist)[0].tolist()
        flat = [probes.index(pos[int(i)][0]) * tidx.block + pos[int(i)][1]
                for i in nn[row]]
        for a in range(len(flat) - 1):
            if dist[row, a] == dist[row, a + 1]:
                ties += 1
                assert flat[a] < flat[a + 1]
    assert ties > 0


def test_probe_order_is_stable_on_equal_scores():
    cents = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [-1.0, 0.0]])
    q = torch.tensor([[0.0, 0.0], [1.0, 0.0]])
    np.testing.assert_array_equal(
        TR.select_probes(q, cents, 4).numpy(), [[0, 1, 2, 3], [0, 2, 1, 3]])


def test_distance_helpers_match_jax():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    c = rng.normal(size=(7, 16)).astype(np.float32)
    v = rng.normal(size=(3, 2, 9, 16)).astype(np.float32)
    np.testing.assert_allclose(
        TR.coarse_distances(torch.from_numpy(q), torch.from_numpy(c)),
        np.asarray(JI.coarse_distances(jnp.asarray(q), jnp.asarray(c))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TR.flat_distances(torch.from_numpy(q)[:, None, :],
                          torch.from_numpy(v)),
        np.asarray(JI.flat_distances(jnp.asarray(q)[:, None, :],
                                     jnp.asarray(v))),
        rtol=1e-5, atol=1e-4)
    cb_q = rng.integers(-127, 128, size=(4, 8, 4)).astype(np.int8)
    cb_s = rng.random(size=(4, 8)).astype(np.float32)
    books = TR.decode_codebooks(torch.from_numpy(cb_q), torch.from_numpy(cb_s))
    np.testing.assert_array_equal(
        books, np.asarray(JI.decode_codebooks(jnp.asarray(cb_q),
                                              jnp.asarray(cb_s))))
    resid = rng.normal(size=(3, 2, 4, 4)).astype(np.float32)
    lut = TR.pq_lut(torch.from_numpy(resid), books)
    np.testing.assert_allclose(
        lut, np.asarray(JI.pq_lut(jnp.asarray(resid), jnp.asarray(books),
                                  jnp.float32(1.0))), rtol=1e-6)
    codes = rng.integers(0, 8, size=(3, 2, 5, 4)).astype(np.int8)
    np.testing.assert_allclose(
        TR.adc_distances(lut, torch.from_numpy(codes)),
        np.asarray(JI.adc_distances(jnp.asarray(lut.numpy()),
                                    jnp.asarray(codes))), rtol=1e-6)


def test_sequential_sums_fix_the_float_order():
    """The plain sums add left to right: 1e8 + 1 - 1e8 loses the 1."""
    a = torch.tensor([[1e8, 1.0, -1e8]])
    assert float(TR._seq_dot(a, torch.ones(1, 3))[0]) == 0.0


def _one_block_a_query_fits(dim, m, ksub, nlist):
    """The shared-memory rule of the IVF-PQ plan before the list-major
    search (one block a query): the query and its residual, the coarse
    row, taken flags and probes, 18 reduce words, the books, the table and
    one staged centroid row of dim + 1 words."""
    return 4 * (2 * dim + 3 * nlist + 18 + ksub * dim + m * ksub) \
        + 4 * (dim + 1) <= 232448


def test_kernel_plan_and_limits():
    """The IVF-PQ search's plan (``pq_plan``): the bench point, the limit
    cases the plan of the one-block-a-query design had, and every shape
    that plan accepted."""
    # the bench point, IVF-PQ: 256 lists of 1016 rows, d 64, m 8, ksub 16:
    # the flat search's probe launch; a scan block of a whole list and 8
    # queries a round: a window's 256 pairs, the chunk's ids, per query a
    # table of 128 words and a residual of 64, the books, 8 code bytes a row
    assert TR.pq_plan(64, 10, 256, 1016, 8, 16) == (
        *TR.flat_plan(64, 10, 256, 1016)[:3], 1016,
        4 * (256 + 1016 + 8 * (128 + 64) + 16 * 64) + 1016 * 8, 8)
    # longer lists: equal chunks of at most 1024 rows
    assert TR.pq_plan(64, 10, 256, 2500, 8, 16).scan_rows == 834
    with pytest.raises(ValueError, match="flat_plan"):
        TR.pq_plan(64, 10, 256, 1016, 0, 0)
    with pytest.raises(ValueError, match=f"k must be in \\[1, {TR.K_MAX}\\]"):
        TR.pq_plan(64, TR.K_MAX + 1, 256, 1016, 8, 16)
    with pytest.raises(ValueError, match="shared memory"):   # coarse row
        TR.pq_plan(64, 10, 40000, 8, 8, 16)
    with pytest.raises(ValueError, match="shared memory"):   # the books
        TR.pq_plan(512, 10, 1024, 8, 4, 127)
    with pytest.raises(ValueError, match="2\\^31"):
        TR.pq_plan(4, 10, 1 << 16, 1 << 16, 4, 16)
    for m, ksub in ((5, 16), (8, 1), (8, 128)):
        with pytest.raises(ValueError, match="m \\| dim and ksub"):
            TR.pq_plan(64, 10, 8, 16, m, ksub)
    jidx, q = _fixture("pq-small")
    tidx = _port(jidx)
    p = tidx.device_params()
    with pytest.raises(ValueError, match="nprobe"):
        TR.retrieve_pq(torch.from_numpy(q), p["centroids"], p["ids"],
                       p["codes"], p["cb_q"], p["cb_s"],
                       nprobe=tidx.nlist + 1, k=10, nlist=tidx.nlist,
                       block=tidx.block, m=tidx.pq.m)
    # a wide row narrows the probe tile, as in the flat search
    plan = TR.pq_plan(1024, 10, 8, 16, 8, 16)
    assert plan.probe_rows == (232448 - 4 * (1024 + 16)) // (
        4 * 1029) // 4 * 4 == 52
    assert (plan.scan_rows, plan.scan_queries) == (16, 8)
    # big tables: fewer queries a round
    plan = TR.pq_plan(256, 10, 8, 16, 64, 127)
    assert plan.scan_queries == (232448 - 32 - 4 * (256 + 16 + 127 * 256)
                                 - 16 * 64) // (4 * (64 * 127 + 256)) == 2
    # where not one query fits beside the list: one query, fewer rows (a
    # shape the old plan took with 32 bytes to spare)
    assert _one_block_a_query_fits(226, 226, 127, 1)
    plan = TR.pq_plan(226, 10, 1, 8, 226, 127)
    assert (plan.scan_queries, plan.scan_rows) == (1, 3)
    assert plan.scan_smem <= 232448 - 32
    # every shape the old plan accepted, at the largest ksub it took
    for dim in list(range(1, 300)) + list(range(300, 2100, 37)):
        for m in {1, dim} | {dim // f for f in (2, 4, 8) if dim % f == 0}:
            for nlist in (1, 3, 256, 5000):
                fits = [ksub for ksub in range(2, 128)
                        if _one_block_a_query_fits(dim, m, ksub, nlist)]
                if fits:
                    TR.pq_plan(dim, 10, nlist, 8, m, fits[-1])


def test_wrappers_take_plain_on_cpu_and_check_inputs():
    jidx, q = _fixture("flat-small")
    tidx = _port(jidx)
    p = tidx.device_params()
    TR.reset_launch_counts()
    qt = torch.from_numpy(q)
    args = dict(nprobe=2, k=5, nlist=tidx.nlist, block=tidx.block)
    got = TR.retrieve_flat(qt, p["centroids"], p["ids"], p["vecs"], **args)
    want = TR.retrieve_flat_plain(qt, p["centroids"], p["ids"], p["vecs"],
                                  **args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert TR.LAUNCHES == {"retrieve_flat": 0, "retrieve_pq": 0}
    with pytest.raises(TypeError, match="ids must be torch.int32"):
        TR.retrieve_flat(qt, p["centroids"], p["ids"].long(), p["vecs"],
                         **args)
    with pytest.raises(ValueError, match="vecs must have shape"):
        TR.retrieve_flat(qt, p["centroids"], p["ids"], p["vecs"][:-1],
                         **args)
    with pytest.raises(ValueError, match="nprobe"):
        TR.retrieve_flat(qt, p["centroids"], p["ids"], p["vecs"],
                         **dict(args, nprobe=tidx.nlist + 1))


def test_quantizer_matches_jax():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    w[2] = 0.0
    for axis in (None, 0, 1, -1):
        np.testing.assert_array_equal(TQ.maxabs_scales(w, axis),
                                      JQ.maxabs_scales(w, axis))
        for a, b in zip(TQ.quantize_channelwise(w, axis),
                        JQ.quantize_channelwise(w, axis)):
            np.testing.assert_array_equal(a, b)
    codes, scales = TQ.quantize_rows(w)
    jc, js = JQ.quantize_rows(w)
    np.testing.assert_array_equal(codes, jc)
    np.testing.assert_array_equal(scales, js)
    assert TQ.Q_MAX == JQ.Q_MAX
    np.testing.assert_array_equal(
        TQ.dequantize_rows(torch.from_numpy(codes), torch.from_numpy(scales)),
        np.asarray(JQ.dequantize_rows(codes, scales)))


_NO_POS = 2 ** 31 - 1


def _lexsort_k(dist, pos, k):
    """The k first of (dist, pos) pairs ascending, padded with (+inf, no
    position)."""
    order = np.lexsort((pos, dist))[:k]
    d, p = dist[order], pos[order]
    short = k - d.shape[0]
    return (np.concatenate([d, np.full(short, np.inf, np.float32)]),
            np.concatenate([p, np.full(short, _NO_POS, np.int64)]))


def _list_major(q, p, *, nprobe, k, nlist, block, chunk, m=0):
    """The search as the list-major kernel runs it: probes per query; for
    every list, each query that probes it (ascending) scores each chunk of
    ``chunk`` rows of the list once with the plain distance helpers (flat
    rows; for PQ, ``m > 0``, the codes against the table of the query's
    residual to the list's centroid) and keeps its k best (distance,
    position = rank * block + row); a query's nprobe * chunks partials are
    merged by (distance, position)."""
    qt = torch.from_numpy(q)
    cents = torch.from_numpy(p["centroids"])
    ids = p["ids"]
    probes = TR.select_probes(qt, cents, nprobe).numpy()
    b, d = q.shape
    if m:
        books = TR.decode_codebooks(torch.from_numpy(p["cb_q"]),
                                    torch.from_numpy(p["cb_s"]))
        codes = torch.from_numpy(p["codes"]).view(nlist, block, m)
    else:
        rows = torch.from_numpy(p["vecs"]).view(nlist, block, d)

    def distances(qi, lst):
        if not m:
            return TR.flat_distances(qt[qi], rows[lst]).numpy()
        lut = TR.pq_lut((qt[qi] - cents[lst]).view(m, d // m), books)
        return TR.adc_distances(lut, codes[lst]).numpy()

    part = {}
    for lst in range(nlist):
        for qi, rank in zip(*np.nonzero(probes == lst)):
            dist = np.where(ids[lst] >= 0, distances(qi, lst),
                            np.float32(np.inf))
            pos = rank * block + np.arange(block)
            part[qi, rank] = [
                _lexsort_k(dist[c:c + chunk].astype(np.float32),
                           pos[c:c + chunk], k)
                for c in range(0, block, chunk)]
    nn = np.empty((b, k), np.int32)
    out = np.empty((b, k), np.float32)
    for qi in range(b):
        dist = np.concatenate([c[0] for r in range(nprobe)
                               for c in part[qi, r]])
        pos = np.concatenate([c[1] for r in range(nprobe)
                              for c in part[qi, r]])
        out[qi], best = _lexsort_k(dist, pos, k)
        nn[qi] = [-1 if p == _NO_POS else
                  ids[probes[qi, p // block], p % block] for p in best]
    return nn, out


@pytest.mark.parametrize("kind", ["flat-small", "clustered", "dup-flat",
                                  "cross-ties", "short", "pq-small",
                                  "pq-ksub2", "pq-cross-ties", "pq-short"])
@pytest.mark.parametrize("nprobe", ["1", "2", "nlist"])
def test_list_major_partials_merge_to_the_plain_search(kind, nprobe):
    """The identity the list-major kernels rest on: per-(query, list,
    chunk of rows) partial top-k from the plain distance helpers, merged
    by (distance, position), gives the plain search's ids and distance
    bits, flat and IVF-PQ (duplicated rows: exact ties across and within
    lists; ksub = 2: quantised distances tie throughout; short: k past the
    candidates)."""
    base = {"cross-ties": "dup-flat", "pq-cross-ties": "dup-pq"}
    jidx, q = _fixture(base.get(kind, kind))
    tidx = _port(jidx)
    nprobe = tidx.nlist if nprobe == "nlist" else int(nprobe)
    p = {name: np.array(v) for name, v in tidx.params.items()}
    m = tidx.pq.m if tidx.pq else 0
    if kind == "cross-ties":          # list 1 holds list 0's rows again
        vecs = p["vecs"].reshape(tidx.nlist, tidx.block, -1)
        vecs[1] = vecs[0]
    if kind == "pq-cross-ties":       # list 1: list 0's codes and centroid
        codes = p["codes"].reshape(tidx.nlist, tidx.block, m)
        codes[1] = codes[0]
        p["centroids"][1] = p["centroids"][0]
    if kind in base:
        p["ids"][1] = np.where(p["ids"][0] >= 0, p["ids"][0] + 1000, -1)
    shape = dict(nprobe=nprobe, k=tidx.k, nlist=tidx.nlist,
                 block=tidx.block)
    t = {name: torch.from_numpy(v) for name, v in p.items()}
    if m:
        want_nn, want_d = TR.retrieve_pq_plain(
            torch.from_numpy(q), t["centroids"], t["ids"], t["codes"],
            t["cb_q"], t["cb_s"], m=m, **shape)
    else:
        want_nn, want_d = TR.retrieve_flat_plain(
            torch.from_numpy(q), t["centroids"], t["ids"], t["vecs"],
            **shape)
    for chunk in (tidx.block, 4):      # whole lists; chunks of 4 rows
        nn, dist = _list_major(q, p, chunk=chunk, m=m, **shape)
        np.testing.assert_array_equal(nn, want_nn.numpy())
        np.testing.assert_array_equal(dist.view(np.int32),
                                      want_d.numpy().view(np.int32))
    if kind in ("pq-ksub2", "pq-cross-ties"):   # the ties are there
        assert np.any(want_d.numpy()[:, 1:] == want_d.numpy()[:, :-1])


def test_flat_plan_and_limits():
    # the bench point: d 64, nlist 256, k 10: 8 queries a probe block over
    # 256-row centroid tiles; a scan block holds a round's 8 queries, a
    # window's 256 pairs and 256 rows of 68 words
    assert TR.flat_plan(64, 10, 256, 1016) == (
        8, 256, 4 * (256 * 69 + 8 * (64 + 2 * 256)), 256,
        4 * (8 * 64 + 256 + 256 * 70))
    # d not a multiple of 4: rows of d + 1 words (4-byte copies)
    plan = TR.flat_plan(30, 10, 16, 64)
    assert (plan.scan_rows, plan.scan_smem) == (256, 4 * (8 * 30 + 256
                                                         + 256 * 33))
    # many lists: fewer queries a probe block
    plan = TR.flat_plan(64, 10, 8000, 64)
    assert plan.probe_queries == (232448 - 4 * 256 * 69) // (
        4 * (64 + 16000)) == 2
    assert plan.probe_smem == 4 * (256 * 69 + 2 * (64 + 16000)) <= 232448
    # wide rows: fewer rows a scan block and a probe tile, multiples of 4
    plan = TR.flat_plan(1024, 10, 16, 64)
    assert plan.scan_rows == (232448 - 32 - 4 * (8 * 1024 + 256)) // (
        4 * 1030) // 4 * 4 == 48
    assert plan.probe_rows == (232448 - 4 * 1056) // (4 * 1029) // 4 * 4 \
        == 52
    assert plan.probe_queries == (232448 - 4 * 52 * 1029) // (
        4 * 1056) == 4
    assert plan.scan_smem <= 232448 - 32 and plan.probe_smem <= 232448
    with pytest.raises(ValueError, match="coarse row"):
        TR.flat_plan(64, 10, 40000, 8)
    with pytest.raises(ValueError, match="scan"):
        TR.flat_plan(8192, 10, 16, 8)
    with pytest.raises(ValueError, match="2\\^31"):
        TR.flat_plan(4, 10, 1 << 16, 1 << 16)
    with pytest.raises(ValueError, match=f"k must be in \\[1, {TR.K_MAX}\\]"):
        TR.flat_plan(64, TR.K_MAX + 1, 16, 8)
    with pytest.raises(ValueError, match="dim, nlist, block >= 1"):
        TR.flat_plan(0, 10, 16, 8)
