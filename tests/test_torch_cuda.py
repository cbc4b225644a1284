"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU (``cuda`` marker) and skips
without one.  The file imports neither JAX nor the JAX package, so it runs
on a machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest`` because ``tests/conftest.py`` imports JAX).  Inputs are
small and seeded; ``chip_smoke.py`` repeats the comparison at the main
path's full shapes."""

import os
import threading

import numpy as np
import pytest
import torch

import flink_ml_tpu_torch as T
from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES
from flink_ml_tpu_torch.ops import ell_scatter as TE
from flink_ml_tpu_torch.ops import kmeans as TK
from flink_ml_tpu_torch.ops import retrieve as TR

D = 128 * 128


@pytest.fixture
def cuda_device():
    """The first CUDA device; decided when the test runs, never at import,
    so every pytest worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda", 0)


def _grid(seed, d=D, batch=200, nnz=7):
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, d, size=(1, batch, nnz)).astype(np.int32)
    cat[0, :, 0] = 777                   # a heavy index
    cat[0, :, 1] = 128 * 5 + np.arange(batch) % 3   # an overflowing row
    vals = rng.normal(size=cat.shape).astype(np.float32)
    lay = TE.ell_layout(cat, d, values=vals, heavy_threshold=150)
    w = rng.normal(size=d).astype(np.float32)
    r_ext = np.concatenate([rng.normal(size=batch),
                            np.zeros(56)]).astype(np.float32)
    return rng, lay, w, r_ext


@pytest.mark.cuda
@pytest.mark.parametrize("with_val", [False, True])
def test_kernels_match_plain(cuda_device, with_val):
    rng, lay, w, r_ext = _grid(17)
    t = lay.to(cuda_device)
    wt = torch.from_numpy(w).to(cuda_device)
    rt = torch.from_numpy(r_ext).to(cuda_device)
    val = t.val[0] if with_val else None
    route_w, route_val = TE.sample_routing(t.src[0], t.pos[0], t.mask[0],
                                           lay.batch, val=val)
    TE.reset_launch_counts()
    got = TE.ell_margin(wt, route_w, m_len=256, route_val=route_val)
    want = TE.ell_margin_plain(wt, route_w, 256, route_val=route_val)
    assert torch.equal(got, want)        # fixed order: bit for bit
    got = TE.ell_scatter_apply_fused(wt, rt, t.src[0], t.pos[0], t.mask[0],
                                     lr=0.3, val=val)
    want = TE.ell_scatter_apply_fused_plain(wt, rt, t.src[0], t.pos[0],
                                            t.mask[0], lr=0.3, val=val)
    assert torch.equal(got, want)        # fixed order: bit for bit
    upd = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32)
                           ).to(cuda_device)
    assert torch.equal(TE.ell_scatter_apply(wt, upd, t.pos[0], t.mask[0]),
                       TE.ell_scatter_apply_plain(wt, upd, t.pos[0],
                                                  t.mask[0]))
    torch.cuda.synchronize()
    assert TE.LAUNCHES == {"ell_margin": 1, "ell_scatter_apply_fused": 1,
                           "ell_scatter_apply": 1}


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda_device):
    _, lay, w, _ = _grid(18)
    route_w, _ = TE.sample_routing(torch.from_numpy(lay.src[0]),
                                   torch.from_numpy(lay.pos[0]),
                                   torch.from_numpy(lay.mask[0]), lay.batch)
    with pytest.raises(ValueError, match="route_w is on cpu"):
        TE.ell_margin(torch.from_numpy(w).to(cuda_device), route_w,
                      m_len=256)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16008, 16003],
                         ids=["ragged_waves", "partial_block"])
@pytest.mark.parametrize("with_val", [False, True])
def test_margin_and_fused_scatter_bit_equal_on_ragged_grids(
        cuda_device, rows, with_val):
    """Grids of 2001 blocks of 8 rows (the last one short of 8 rows in
    the partial case): about two waves of the fused scatter on 132 SMs,
    not a whole number of them.  The margin is bit for bit its plain
    version and repeats bit for bit; so is the fused scatter."""
    d = 128 * rows
    rng = np.random.default_rng(23)
    batch = 4096
    cat = rng.integers(0, d, size=(1, batch, 26)).astype(np.int32)
    cat[0, :, 0] = 16                    # the label marker: heavy
    vals = (rng.normal(size=cat.shape).astype(np.float32) if with_val
            else None)
    t = TE.ell_layout(cat, d, values=vals).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(
        cuda_device)
    m_len = TS._ext_len(batch)
    r_ext = TS._extended_r(torch.from_numpy(
        rng.normal(size=batch).astype(np.float32)).to(cuda_device))
    val = None if vals is None else t.val[0]
    route_w, route_val = TE.sample_routing(t.src[0], t.pos[0], t.mask[0],
                                           batch, val=val)
    got = TE.ell_margin(w, route_w, m_len=m_len, route_val=route_val)
    again = TE.ell_margin(w, route_w, m_len=m_len, route_val=route_val)
    want = TE.ell_margin_plain(w, route_w, m_len, route_val=route_val)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert not got[batch:].any()
    got = TE.ell_scatter_apply_fused(w, r_ext, t.src[0], t.pos[0],
                                     t.mask[0], lr=0.7, val=val)
    want = TE.ell_scatter_apply_fused_plain(w, r_ext, t.src[0], t.pos[0],
                                            t.mask[0], lr=0.7, val=val)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_margin_reads_zero_outside_w(cuda_device):
    """The kernel bounds every weight gather by ``w``'s size: a route
    entry past it reads 0, as in the plain version."""
    w = torch.arange(1, 257, dtype=torch.float32, device=cuda_device)
    route_w = torch.tensor([[3, -1, 256], [7, 255, 1 << 20]],
                           dtype=torch.int32, device=cuda_device)
    got = TE.ell_margin(w, route_w, m_len=4)
    assert torch.equal(got, TE.ell_margin_plain(w, route_w, 4))
    assert got.tolist() == [12.0, 256.0, 0.0, 0.0]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 1001, 1025])
@pytest.mark.parametrize("aliased", [False, True], ids=["out", "in_place"])
def test_pair_scatter_bit_equal_on_ragged_rows(cuda_device, rows, aliased):
    """The pair kernel at row counts that leave its last block short, from
    one row up, is bit for bit its plain version, also when ``out`` is
    ``w`` itself (each warp loads its row of ``w`` before it writes it)."""
    rng = np.random.default_rng(rows)
    d = 128 * rows
    cat = rng.integers(0, d, size=(1, 64, 26)).astype(np.int32)
    lay = TE.ell_layout(cat, d).to(cuda_device)
    w = torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(
        cuda_device)
    upd = torch.from_numpy(rng.normal(size=(rows, 128)).astype(np.float32)
                           ).to(cuda_device)
    want = TE.ell_scatter_apply_plain(w, upd, lay.pos[0], lay.mask[0])
    TE.reset_launch_counts()
    if aliased:
        lib = TE._kernels()
        rc = lib.ell_scatter_pair_launch(
            w.data_ptr(), upd.data_ptr(), lay.pos[0].data_ptr(),
            lay.mask[0].data_ptr(), w.data_ptr(), rows,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        got = w
    else:
        got = TE.ell_scatter_apply(w, upd, lay.pos[0], lay.mask[0])
        assert TE.LAUNCHES["ell_scatter_apply"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _fit_data(n=1200, nd=13, nc=26, d=D, seed=6):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, nd)).astype(np.float32)
    cat = rng.integers(32, d, size=(n, nc)).astype(np.int32)
    y = rng.integers(0, 2, size=n).astype(np.float64)
    cat[:, 0] = np.where(y == 1, 16, 17)
    return dense, cat, y


@pytest.mark.cuda
@pytest.mark.parametrize("d,kernel", [(D, "ell_scatter_apply_fused"),
                                      (128 * 129, "ell_scatter_apply")],
                         ids=["fused", "pair"])
def test_fit_matches_plain_versions(cuda_device, d, kernel):
    """The kernels' fit against the same fit through the plain versions,
    both on the card."""
    dense, cat, y = _fit_data(d=d)
    cfg = TS.SGDConfig(learning_rate=0.5, max_epochs=2,
                       global_batch_size=400, tol=0)
    TE.reset_launch_counts()
    got, got_log = TS.sgd_fit_mixed(LOSSES["logistic"], dense, cat, y, None,
                                    d, cfg, device=cuda_device)
    assert TE.LAUNCHES["ell_margin"] == 3 * 2
    assert TE.LAUNCHES[kernel] == 3 * 2
    want, want_log = TS.sgd_fit_mixed(LOSSES["logistic"], dense, cat, y,
                                      None, d, cfg, device=cuda_device,
                                      plain=True)
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got_log, want_log, rtol=1e-4)


def _pair_rows(d, n=1200, seed=5):
    """Criteo-shaped rows in the pair encoding: indices 0-12 carry N(0,1)
    dense values, the 26 hashed slots 1.0, marker slot 13 drives the
    label; at batch 600 the dense indices are heavy (f32 value sums)."""
    dense, cat, y = _fit_data(n=n, d=d, seed=seed)
    idx = np.concatenate([np.broadcast_to(np.arange(13, dtype=np.int32),
                                          (n, 13)), cat], axis=1)
    vals = np.concatenate([dense, np.ones((n, 26), np.float32)], axis=1)
    return idx, vals, y


@pytest.mark.cuda
@pytest.mark.parametrize("d,kernel", [(D, "ell_scatter_apply_fused"),
                                      (128 * 1001, "ell_scatter_apply")],
                         ids=["grid_8", "grid_1001"])
@pytest.mark.parametrize("rows", ["pair", "normal"])
def test_sparse_fit_matches_plain_versions(cuda_device, d, kernel, rows):
    """The sparse (indices, values) fit through the kernels' value
    variants against the same fit through the plain versions, both on the
    card: grids of 128 rows (8-row blocks, the fused scatter) and 1001
    rows (the pair scatter), within the bench's tolerance; a second
    kernel fit gives the same bits (every scatter-add in a fixed order)."""
    idx, vals, y = _pair_rows(d)
    if rows == "normal":
        vals = np.random.default_rng(6).normal(size=vals.shape).astype(
            np.float32)
    cfg = TS.SGDConfig(learning_rate=0.3, max_epochs=2,
                       global_batch_size=600, tol=0, reg=0.01,
                       elastic_net=0.3)
    TE.reset_launch_counts()
    got, got_log = TS.sgd_fit_sparse(LOSSES["logistic"], idx, vals, y, None,
                                     d, cfg, device=cuda_device)
    torch.cuda.synchronize()
    assert got.planned_impl == "ell"
    assert TE.LAUNCHES["ell_margin"] == 2 * 2
    assert TE.LAUNCHES[kernel] == 2 * 2
    want, want_log = TS.sgd_fit_sparse(LOSSES["logistic"], idx, vals, y,
                                       None, d, cfg, device=cuda_device,
                                       plain=True)
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got_log, want_log, rtol=1e-4)
    again, again_log = TS.sgd_fit_sparse(LOSSES["logistic"], idx, vals, y,
                                         None, d, cfg, device=cuda_device)
    np.testing.assert_array_equal(again.coefficients, got.coefficients)
    assert again_log == got_log


@pytest.mark.cuda
def test_device_layout_matches_host_layout(cuda_device):
    """``ell_layout_device`` on the card gives the host layout's grids and
    records, and its value sums within f32 rounding."""
    idx, vals, _ = _pair_rows(D, n=1200)
    cat = idx.reshape(2, 600, -1)
    v = vals.reshape(2, 600, -1)
    host = TE.ell_layout(cat, D, values=v)
    dev = TE.ell_layout_device(torch.from_numpy(cat).to(cuda_device), D,
                               ovf_cap=1 << 13, heavy_cap=24,
                               values=torch.from_numpy(v).to(cuda_device)
                               ).assert_capacities().trim_overflow()
    for f in ("src", "pos", "mask", "val"):
        assert np.array_equal(getattr(dev, f).cpu().numpy(),
                              getattr(host, f)), f
    np.testing.assert_array_equal(dev.need_ovf, host.need_ovf)
    np.testing.assert_array_equal(dev.need_heavy, host.need_heavy)
    h = host.heavy_idx.shape[1]
    np.testing.assert_array_equal(dev.heavy_idx[:, :h].cpu().numpy(),
                                  host.heavy_idx)
    np.testing.assert_allclose(dev.heavy_cnt[:, :h].cpu().numpy(),
                               host.heavy_cnt, atol=1e-6)


# -- KMeans kernels ----------------------------------------------------------

def _kmeans_problem(n, d, k, seed, duplicated=False, n_pad=0):
    """Seeded points (``n_pad`` trailing zero rows) and centroids drawn
    from them; ``duplicated`` repeats a centroid (exact ties) and the
    least-norm one (the zero rows tie on it)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    if n_pad:
        pts[-n_pad:] = 0.0
    cents = pts[rng.permutation(n - n_pad)[:k]].copy()
    if duplicated:
        cents[0] *= 0.05
        cents[k - 1] = cents[0]
        cents[k - 2] = cents[1]
    return pts, cents


def _near_tie_rows(scores, rel=1e-5):
    """Rows whose best two plain scores lie within ``rel`` (1 + |best|):
    there the kernel's dot order may pick the other centroid."""
    two = torch.topk(scores, 2, dim=1, largest=False).values
    return (two[:, 1] - two[:, 0]) <= rel * (1 + two[:, 0].abs())


def _plain_scores(pts, cents):
    return -2.0 * (pts @ cents.T) + (cents * cents).sum(1)[None, :]


@pytest.mark.cuda
@pytest.mark.parametrize("tie", ["first", "fast", "split"])
@pytest.mark.parametrize("n,d,k,dup", [(1000, 16, 37, False),
                                       (4099, 64, 256, True),
                                       (300, 9, 40, True)])
def test_kmeans_update_stats_matches_plain(cuda_device, tie, n, d, k, dup):
    """Ragged n, k not a power of two, duplicated centroids (exact ties in
    both versions).  With no row near a tie the assignments agree, so
    counts are exact and sums within 1e-4 (summation order); a near-tie
    row may move one count from one cluster to another."""
    pts, cents = _kmeans_problem(n, d, k, seed=n, duplicated=dup, n_pad=7)
    p = torch.from_numpy(pts).to(cuda_device)
    c = torch.from_numpy(cents).to(cuda_device)
    near = int(_near_tie_rows(_plain_scores(p, torch.unique(c, dim=0)))
               .sum())
    TK.reset_launch_counts()
    got_s, got_c = TK.kmeans_update_stats(p, c, tie_policy=tie)
    want_s, want_c = TK.kmeans_update_stats_plain(p, c, tie_policy=tie)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["kmeans_update_stats"] == 1
    if near:
        assert float((got_c - want_c).abs().sum()) <= 4 * near
    else:
        torch.testing.assert_close(got_c, want_c, atol=0, rtol=0)
        torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(1000, 16, 37), (5000, 64, 256),
                                   (777, 3, 5), (5000, 16, 4096),
                                   (2050, 300, 600)])
def test_kmeans_assign_reduce_matches_plain(cuda_device, n, d, k):
    """Assignments equal off near-tie rows; the kernel's sums and counts
    equal the plain stats of its own assignments (counts exactly, sums
    within 1e-5 relative).  The last two shapes do not fit shared memory
    whole: their centroids are staged per tile, their partial sums live in
    device memory, and the last one reads its points from device memory."""
    pts, cents = _kmeans_problem(n, d, k, seed=d)
    p = torch.from_numpy(pts).to(cuda_device)
    c = torch.from_numpy(cents).to(cuda_device)
    near = _near_tie_rows(_plain_scores(p, torch.unique(c, dim=0)))
    a, s, cnt = TK.kmeans_assign_reduce(p, c)
    want_a, _, _ = TK.kmeans_assign_reduce_plain(p, c)
    assert a.dtype == torch.int32
    assert torch.equal(a[~near], want_a[~near])
    ones = torch.ones(n, device=cuda_device)
    own_s, own_c = TK.stats_from_assign(k, p, ones, a)
    torch.testing.assert_close(cnt, own_c, atol=0, rtol=0)
    torch.testing.assert_close(s, own_s, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(1000, 16, 37), (3001, 64, 256)])
def test_kmeans_workset_update_matches_plain(cuda_device, n, d, k):
    pts, _ = _kmeans_problem(n, d, k, seed=k)
    rng = np.random.default_rng(k + 1)
    cents = rng.normal(size=(k, d)).astype(np.float32)
    prev = rng.integers(0, k, size=n).astype(np.int32)
    active = (rng.random(n) < 0.5).astype(np.float32)
    pad = (rng.random(n) < 0.9).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda_device)
            for x in (pts, cents, prev, active, pad)]
    near = _near_tie_rows(_plain_scores(args[0], args[1]))
    a, db, ds, s, cnt = TK.kmeans_workset_update(*args)
    wa, wdb, wds, _, _ = TK.kmeans_workset_update_plain(*args)
    assert torch.equal(a[~near], wa[~near])
    torch.testing.assert_close(db, wdb, atol=1e-4, rtol=0)
    torch.testing.assert_close(ds, wds, atol=1e-4, rtol=0)
    own_s, own_c = TK.stats_from_assign(k, args[0], args[4], a)
    torch.testing.assert_close(cnt, own_c, atol=0, rtol=0)
    torch.testing.assert_close(s, own_s, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["first", "fast", "split", "assign",
                                  "workset"])
@pytest.mark.parametrize("n,d,k", [(4099, 64, 1024), (2050, 300, 600)],
                         ids=["staged_centroids", "no_tile"])
def test_kmeans_modes_on_the_fallback_plans(cuda_device, mode, n, d, k):
    """Every mode at a shape whose centroids are staged per tile (k = 1024
    at d = 64) and one whose point tile does not fit shared memory (d =
    300; its centroids are staged too): assignments equal off near-tie
    rows, stats equal the plain stats of the kernel's own assignments
    (counts exactly, sums within 1e-5 relative), or the plain stats where
    no row is near a tie.  The workset mode, whose roots magnify the
    rounding of a distance near 0, gets centroids that are not points, as
    in :func:`test_kmeans_workset_update_matches_plain`."""
    pts, cents = _kmeans_problem(n, d, k, seed=k)
    if mode == "workset":
        cents = np.random.default_rng(k + 1).normal(size=(k, d)).astype(
            np.float32)
    p = torch.from_numpy(pts).to(cuda_device)
    c = torch.from_numpy(cents).to(cuda_device)
    near = _near_tie_rows(_plain_scores(p, c))
    ones = torch.ones(n, device=cuda_device)
    if mode in TK.TIE_POLICIES:
        got_s, got_c = TK.kmeans_update_stats(p, c, tie_policy=mode)
        want_s, want_c = TK.kmeans_update_stats_plain(p, c, tie_policy=mode)
        if int(near.sum()):
            assert float((got_c - want_c).abs().sum()) <= 4 * int(near.sum())
        else:
            torch.testing.assert_close(got_c, want_c, atol=0, rtol=0)
            torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-5)
        return
    if mode == "assign":
        a, s, cnt = TK.kmeans_assign_reduce(p, c)
        want_a, _, _ = TK.kmeans_assign_reduce_plain(p, c)
        weight = ones
    else:
        rng = np.random.default_rng(n)
        prev = torch.from_numpy(rng.integers(0, k, n).astype(np.int32)).to(
            cuda_device)
        active = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32)
                                  ).to(cuda_device)
        weight = torch.from_numpy((rng.random(n) < 0.9).astype(np.float32)
                                  ).to(cuda_device)
        a, db, ds, s, cnt = TK.kmeans_workset_update(p, c, prev, active,
                                                     weight)
        want_a, wdb, wds, _, _ = TK.kmeans_workset_update_plain(
            p, c, prev, active, weight)
        torch.testing.assert_close(db, wdb, atol=1e-4, rtol=0)
        torch.testing.assert_close(ds, wds, atol=1e-4, rtol=0)
    assert torch.equal(a[~near], want_a[~near])
    own_s, own_c = TK.stats_from_assign(k, p, weight, a)
    torch.testing.assert_close(cnt, own_c, atol=0, rtol=0)
    torch.testing.assert_close(s, own_s, rtol=1e-5, atol=1e-4)


def _sum_of_squares(target, d, cap):
    """Integer coordinates (each below ``cap``) whose squares sum to
    ``target``: a short depth-first search from the largest square."""
    if d == 0:
        return [] if target == 0 else None
    top = min(int(np.sqrt(target)), cap - 1)
    for a in range(top, max(top - 40, -1), -1):
        rest = _sum_of_squares(target - a * a, d - 1, cap)
        if rest is not None:
            return [a] + rest
    return None


def _root_tie_problem(d=8, k=48, seed=31):
    """Centroids whose coordinates are integers below 2048 (exact in TF32
    and in any f32 sum) and points that are 0 or small integer vectors:
    every squared distance is an exact integer below 2^24 in both
    versions.  Centroid 3 lies at squared norm S + 1 and centroid 17 at S,
    where sqrtf(S) == sqrtf(S + 1): the zero rows see two different squares
    that round to one root, the later centroid with the smaller square.
    The other centroids lie at squared norms past S + 40000."""
    s_val = next(v for v in range(1 << 23, 1 << 24)
                 if np.sqrt(np.float32(v)) == np.sqrt(np.float32(v + 1)))
    rng = np.random.default_rng(seed)
    cents = np.zeros((k, d), np.float32)
    for c in range(k):
        while not s_val + 40000 <= int((cents[c].astype(np.int64) ** 2
                                        ).sum()) < 1 << 24:
            cents[c] = rng.integers(0, 2048, size=d)
    cents[3] = _sum_of_squares(s_val + 1, d, 2048)
    cents[17] = _sum_of_squares(s_val, d, 2048)
    cents = np.ascontiguousarray(cents[:, rng.permutation(d)])
    n = 515
    pts = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    pts[::2] = 0.0
    return pts, cents, s_val


@pytest.mark.cuda
def test_kmeans_workset_first_index_on_roots_that_round_together(
        cuda_device):
    """Two different squared distances that round to one root: the
    workset kernel, which roots only the candidates that can change its
    result, keeps the reference's first index among equal roots (not the
    smaller square's), on every row, and its roots equal the plain ones."""
    pts, cents, s_val = _root_tie_problem()
    p = torch.from_numpy(pts).to(cuda_device)
    c = torch.from_numpy(cents).to(cuda_device)
    n, k = p.shape[0], c.shape[0]
    assert np.sqrt(np.float32(s_val)) == np.sqrt(np.float32(s_val + 1))
    prev = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    ones = torch.ones(n, device=cuda_device)
    a, db, ds, s, cnt = TK.kmeans_workset_update(p, c, prev, ones, ones)
    wa, wdb, wds, ws, wcnt = TK.kmeans_workset_update_plain(p, c, prev, ones,
                                                            ones)
    torch.cuda.synchronize()
    assert torch.equal(a, wa)
    assert bool((a[::2] == 3).all())
    assert torch.equal(db, wdb) and torch.equal(ds, wds)
    assert bool((db[::2] == ds[::2]).all())
    torch.testing.assert_close(cnt, wcnt, atol=0, rtol=0)


@pytest.mark.cuda
def test_kmeans_fit_and_transform_through_the_kernels(cuda_device):
    """A small fit on the kernel plan (65536 rows), BSP and workset, and a
    transform, checked by launch counters and against the plain versions
    on the card."""
    rng = np.random.default_rng(21)
    centers = rng.normal(size=(6, 8)) * 6
    X = (centers[rng.integers(0, 6, 65536)]
         + rng.normal(size=(65536, 8)) * 0.5).astype(np.float32)
    table = T.Table({"features": X})
    TK.reset_launch_counts()
    est = T.KMeans().set_k(6).set_max_iter(5).set_seed(4)
    model = est.fit(table)
    assert est.planned_impl == "kernel"
    assert TK.LAUNCHES["kmeans_update_stats"] == 5
    ws = T.KMeans().set_k(6).set_max_iter(30).set_seed(4).set_workset(True)
    ws_model = ws.fit(table)
    assert ws.planned_impl == "kernel_ws"
    assert TK.LAUNCHES["kmeans_workset_update"] == \
        ws.last_workset_report["rounds"]
    (out,) = model.transform(T.Table({"features": X[:5000]}))
    assert TK.LAUNCHES["kmeans_assign_reduce"] == 1
    cents = model.get_model_data()[0]["centroids"][0]
    d2 = ((X[:5000, None, :].astype(np.float64) - cents[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(out["prediction"], d2.argmin(1))
    plain = T.KMeans(device="cpu").set_k(6).set_max_iter(5).set_seed(4)
    np.testing.assert_allclose(cents, plain.fit(table).get_model_data()[0][
        "centroids"][0], rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(
        ws_model.get_model_data()[0]["centroids"][0],
        T.KMeans(device="cpu").set_k(6).set_max_iter(30).set_seed(4)
        .fit(table).get_model_data()[0]["centroids"][0], rtol=5e-3,
        atol=5e-3)


# -- routed-gradient fold kernel ----------------------------------------------

def _fold_route(kind, seed=0):
    """(steps, batch, fields) ids: uniform over a small vocabulary, a heavy
    hitter in half the rows (a ~1K-row halo), a run past the shared-memory
    halo (the streaming passes), or every id distinct."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 3000, size=(2, 300, 26)), 3000
    if kind == "heavy":
        cat = rng.integers(0, 1 << 16, size=(1, 2048, 8))
        cat[0, :1024, 0] = 7
        return cat, 1 << 16
    if kind == "deep":                   # a run of 2^14 + 7: 15 passes
        cat = rng.integers(0, 100, size=(1, (1 << 14) + 7, 2))
        cat[0, :, 1] = 5
        return cat, 100
    return rng.permutation(5000)[:1000].reshape(1, 100, 10), 5000


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 3, 64, 100])
@pytest.mark.parametrize("kind", ["uniform", "heavy", "deep"])
def test_fold_runs_matches_plain_bitwise(cuda_device, kind, E):
    """Ragged S (7800, 16391), column counts that do not fill a slice, the
    squeezed (S,) payload, a -0.0 row: the kernel equals the plain version
    bit for bit, one counted launch per call."""
    from flink_ml_tpu_torch.ops import emb_grad as TG

    cat, vocab = _fold_route(kind)
    route = TG.emb_grad_route(cat, vocab).to(cuda_device)
    sid = route.sorted_ids[0]
    g = torch.from_numpy(np.random.default_rng(E).normal(
        size=(sid.shape[0], E)).astype(np.float32)).to(cuda_device)
    g[::5] = -0.0
    if E == 1:
        g = g[:, 0].contiguous()
    TG.reset_launch_counts()
    got = TG.fold_runs(g, sid, route.fold_passes)
    want = TG.fold_runs_plain(g, sid, route.fold_passes)
    torch.cuda.synchronize()
    assert TG.LAUNCHES["fold_runs"] == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["gather", "scatter"])
@pytest.mark.parametrize("kind", ["uniform", "heavy", "unique"])
def test_routed_grad_kernel_matches_plain(cuda_device, kind, placement):
    """Both placements through the kernel equal the plain fold bit for bit;
    a route with fold_passes == 0 launches nothing."""
    from flink_ml_tpu_torch.ops import emb_grad as TG

    cat, vocab = _fold_route(kind)
    route = TG.emb_grad_route(cat, vocab, placement=placement).to(
        cuda_device)
    S = route.order.shape[1]
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(S, 16)).astype(np.float32)).to(cuda_device)
    TG.reset_launch_counts()
    for s in range(route.steps):
        for payload in (g, g[:, 0].contiguous()):
            assert torch.equal(
                route.apply(payload, *route.step_slice(s)),
                route.apply(payload, *route.step_slice(s), plain=True))
    torch.cuda.synchronize()
    want = 2 * route.steps if route.fold_passes else 0
    assert TG.LAUNCHES["fold_runs"] == want


@pytest.mark.cuda
def test_widedeep_fit_through_the_kernel(cuda_device):
    """A small routed fit: two fold launches a step, the one-epoch result
    of the JAX package's contract against the same fit through the plain
    fold (rtol 2e-5 loss, 1e-3 parameters), and transform against a numpy
    float64 forward."""
    from flink_ml_tpu_torch.ops import emb_grad as TG

    rng = np.random.default_rng(3)
    n, vocab = 2000, [50, 30, 7]
    cat = np.stack([rng.integers(0, v, size=n) for v in vocab], 1)
    dense = rng.normal(size=(n, 5)).astype(np.float32)
    y = ((cat[:, 0] % 2) ^ (dense[:, 0] > 0)).astype(np.int64)
    table = T.Table({"denseFeatures": dense, "catFeatures": cat, "label": y})

    def est(epochs):
        return (T.WideDeep().set_vocab_sizes(vocab).set_max_iter(epochs)
                .set_global_batch_size(256).set_seed(2))

    TG.reset_launch_counts()
    e = est(3)
    model = e.fit(table)
    torch.cuda.synchronize()
    assert e.route_info["placement"] == "gather"
    assert e.route_info["fold_passes"] >= 1
    assert TG.LAUNCHES["fold_runs"] == 2 * 8 * 3
    assert model.loss_log[-1] < model.loss_log[0]
    one = est(1).fit(table)
    plain = est(1).fit(table, plain=True)
    np.testing.assert_allclose(one.loss_log, plain.loss_log, rtol=2e-5)
    for k in ("emb", "wide_cat", "wide_dense", "wide_b"):
        np.testing.assert_allclose(one._params[k], plain._params[k],
                                   rtol=1e-3, atol=1e-3)
    (out,) = model.transform(table)
    p = model._params
    ids = cat + np.concatenate([[0], np.cumsum(vocab)[:-1]])[None, :]
    d = dense.astype(np.float64)
    deep = np.concatenate([d, p["emb"][ids].reshape(n, -1)], 1)
    for i, layer in enumerate(p["mlp"]):
        deep = deep @ layer["w"] + layer["b"]
        if i + 1 < len(p["mlp"]):
            deep = np.maximum(deep, 0.0)
    logit = d @ p["wide_dense"] + p["wide_cat"][ids].sum(1) + p["wide_b"] \
        + deep[:, 0]
    np.testing.assert_allclose(out["rawPrediction"],
                               1.0 / (1.0 + np.exp(-logit)), atol=1e-5)


# -- retrieve kernels --------------------------------------------------------

def _retrieve_index(kind, seed=8):
    """A small seeded index on the CPU: ``flat``/``pq`` (300 x 16, 8
    lists), ``dup`` (every row twice: exact ties), ``short`` (12 rows,
    lists shorter than k)."""
    rng = np.random.default_rng(seed)
    if kind == "short":
        X = rng.normal(size=(12, 16)).astype(np.float32)
        return T.IVFIndex.build(X, 4, k=10, nprobe=1, seed=1, device="cpu")
    X = rng.normal(size=(150 if kind == "dup" else 300, 16)).astype(
        np.float32)
    if kind == "dup":
        X = np.concatenate([X, X])
    pq = T.PQConfig(m=4, ksub=8) if kind == "pq" else None
    return T.IVFIndex.build(X, 8, k=10, nprobe=2, seed=1, pq=pq,
                            device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 33])
@pytest.mark.parametrize("nprobe", ["1", "3", "nlist"])
@pytest.mark.parametrize("kind", ["flat", "pq", "dup", "short"])
def test_retrieve_kernels_match_plain_bitwise(cuda_device, kind, nprobe, b):
    """Ids equal and distance bits equal (both sum in one fixed order)."""
    index = _retrieve_index(kind)
    index.device = cuda_device
    nprobe = index.nlist if nprobe == "nlist" else min(int(nprobe),
                                                       index.nlist)
    view = index.with_options(nprobe=nprobe)
    q = np.random.default_rng(b).normal(size=(b, 16)).astype(np.float32)
    TR.reset_launch_counts()
    nn, dist = view.search(q)
    name = "retrieve_pq" if kind == "pq" else "retrieve_flat"
    assert TR.LAUNCHES[name] == 1 and sum(TR.LAUNCHES.values()) == 1
    want_nn, want_d = view.search(q, plain=True)
    assert sum(TR.LAUNCHES.values()) == 1
    np.testing.assert_array_equal(nn, want_nn)
    np.testing.assert_array_equal(dist.view(np.int32), want_d.view(np.int32))
    if kind == "short" and nprobe == 1:      # fewer than k rows scanned
        assert bool((nn == -1).any())


@pytest.mark.cuda
def test_retrieve_kernel_takes_k_past_the_candidates(cuda_device):
    index = _retrieve_index("short")
    index.device = cuda_device
    p = index.device_params()
    q = torch.from_numpy(np.random.default_rng(3).normal(
        size=(5, 16)).astype(np.float32)).to(cuda_device)
    args = (q, p["centroids"], p["ids"], p["vecs"])
    shape = dict(nprobe=1, k=index.block + 3, nlist=index.nlist,
                 block=index.block)
    got = TR.retrieve_flat(*args, **shape)
    want = TR.retrieve_flat_plain(*args, **shape)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    with pytest.raises(ValueError, match="k must be in"):
        TR.retrieve_flat(*args, **dict(shape, k=TR.K_MAX + 1))


@pytest.mark.cuda
def test_index_build_and_search_on_the_card(cuda_device):
    """Build on the card (the workset fit on its plain body below 65536
    rows), search through the kernel, an update served at once."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(400, 16)).astype(np.float32)
    index = T.IVFIndex.build(X, 8, k=5, nprobe=8, seed=2)
    assert index.search_plan().backend == "cuda"
    TR.reset_launch_counts()
    nn, _ = index.search(X[:20])
    assert TR.LAUNCHES["retrieve_flat"] == 1
    np.testing.assert_array_equal(nn[:, 0], np.arange(20))
    ins = rng.normal(size=(3, 16)).astype(np.float32) + 5.0
    mode, nxt = index.updated(inserts=ins, delete_ids=[0, 1])
    assert mode in ("delta", "reanchor")
    found, _ = nxt.search(ins, k=1)
    np.testing.assert_array_equal(found[:, 0], [400, 401, 402])
    gone, _ = nxt.search(X[:2])
    assert not np.isin(gone, [0, 1]).any()


# -- the fold in strided level groups; the list-major flat search ------------

def _run_ids(rng, S, longest):
    """Sorted ids of S slots: one run of ``longest`` (placed at a ragged
    offset) among random runs of 1-300."""
    lens = [int(longest)]
    while sum(lens) < S:
        lens.append(int(rng.integers(1, 300)))
    rng.shuffle(lens)
    ids = np.repeat(np.arange(len(lens), dtype=np.int32) * 3, lens)[:S]
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 3, 64, 100])
@pytest.mark.parametrize("P", list(range(1, 16)))
def test_fold_groups_match_plain_at_every_depth(cuda_device, P, E):
    """P = 1 .. 15 (L, L + 1, 2L, 2L + 1 among them), S not a multiple of
    anything, runs straddling tiles and blocks, -0.0 rows: bit for bit,
    one counted launch per call."""
    from flink_ml_tpu_torch.ops import emb_grad as TG

    rng = np.random.default_rng(100 * P + E)
    longest = (1 << (P - 1)) + 1 if P > 1 else 2
    S = max(3 * longest, 7919) + int(rng.integers(0, 97))
    ids = _run_ids(rng, S, longest)
    sid = torch.from_numpy(ids).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(S, E)).astype(np.float32)).to(
        cuda_device)
    g[::11] = -0.0
    if E == 1:
        g = g[:, 0].contiguous()
    TG.reset_launch_counts()
    got = TG.fold_runs(g, sid, P)
    want = TG.fold_runs_plain(g, sid, P)
    torch.cuda.synchronize()
    assert TG.LAUNCHES["fold_runs"] == 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 3, 64])
@pytest.mark.parametrize("P", [3, 7, 12])
def test_fold_signed_zeros_match_plain(cuda_device, P, E):
    """Rows of mostly -0.0 (and +0.0 and ones): the sign of every zero sum
    is the plain version's, whichever levels matched on the way."""
    from flink_ml_tpu_torch.ops import emb_grad as TG

    rng = np.random.default_rng(P * E)
    S = 3 * (1 << (P - 1)) + 101
    ids = _run_ids(rng, S, (1 << (P - 1)) + 1)
    pick = np.minimum(rng.integers(0, 8, size=(S, E)), 2)
    rows = np.choose(pick, [np.float32(0.0), np.float32(1.0),
                            np.float32(-0.0)]).astype(np.float32)
    g = torch.from_numpy(rows).to(cuda_device)
    sid = torch.from_numpy(ids).to(cuda_device)
    if E == 1:
        g = g[:, 0].contiguous()
    got = TG.fold_runs(g, sid, P)
    want = TG.fold_runs_plain(g, sid, P)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 64])
def test_fold_one_run_across_every_tile(cuda_device, E):
    """A single run over all S = 100003 rows (17 passes: three groups) and
    an unaligned payload (a view one float in)."""
    from flink_ml_tpu_torch.ops import emb_grad as TG

    S = 100003
    rng = np.random.default_rng(E)
    sid = torch.full((S,), 4, dtype=torch.int32, device=cuda_device)
    base = torch.from_numpy(rng.normal(size=S * E + 1).astype(np.float32)
                            ).to(cuda_device)
    g = base[1:].view(S, E) if E > 1 else base[1:]
    got = TG.fold_runs(g, sid, 17)
    want = TG.fold_runs_plain(g, sid, 17)
    assert torch.equal(got, want)


def _flat_index(rng, n=600, d=16, nlist=8, pq=None):
    X = rng.normal(size=(n, d)).astype(np.float32)
    index = T.IVFIndex.build(X, nlist, k=10, nprobe=2, seed=1, pq=pq,
                             device="cpu")
    return X, index


def _search_args(kind, q, p, index):
    """(kernel wrapper, plain version, inputs, keywords) of a flat or PQ
    search on the tensors ``p``."""
    if kind == "flat":
        return (TR.retrieve_flat, TR.retrieve_flat_plain,
                (q, p["centroids"], p["ids"], p["vecs"]), {})
    return (TR.retrieve_pq, TR.retrieve_pq_plain,
            (q, p["centroids"], p["ids"], p["codes"], p["cb_q"], p["cb_s"]),
            {"m": index.pq.m})


_CASES = ["one-list", "unprobed", "full", "ties", "k-past", "odd-d"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind, case", [("flat", c) for c in _CASES]
                         + [("pq", c) for c in _CASES + ["dsub-1"]])
@pytest.mark.parametrize("b", [1, 257])
def test_list_major_flat_search_matches_plain(cuda_device, kind, case, b):
    """The list-major search, flat and IVF-PQ: every query on one list;
    lists probed by none; nprobe = nlist; exact ties across lists (PQ:
    list 1 holds list 0's codes and centroid); k = K_MAX past the
    candidates; d = 30 (PQ with m = 5: codes read a byte at a time); PQ
    with m = d (dsub 1): ids and distance bits equal to the plain
    version, one counted launch per call."""
    rng = np.random.default_rng(b)
    d = 30 if case == "odd-d" else 16
    pq = None
    if kind == "pq":
        pq = T.PQConfig(m={"odd-d": 5, "dsub-1": d}.get(case, 4), ksub=8)
    X, index = _flat_index(rng, d=d, pq=pq)
    p = {name: torch.from_numpy(np.array(v)) for name, v in
         index.params.items()}
    nlist, block = index.nlist, index.block
    k, nprobe = 10, 2
    if case == "one-list":
        q = p["centroids"][3][None].repeat(b, 1) + torch.from_numpy(
            rng.normal(size=(b, d)).astype(np.float32)) * 1e-3
        nprobe = 1
    elif case == "unprobed":
        q = p["centroids"][:2].repeat((b + 1) // 2, 1)[:b].clone()
        nprobe = 1
    else:
        q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    if case in ("full", "ties"):
        nprobe = nlist
    if case == "ties":
        if kind == "flat":
            vecs = p["vecs"].view(nlist, block, d)
            vecs[1] = vecs[0]
            q = vecs[0, :b].clone() if b <= block else q
        else:
            codes = p["codes"].view(nlist, block, -1)
            codes[1] = codes[0]
            p["centroids"][1] = p["centroids"][0]
        p["ids"][1] = torch.where(p["ids"][0] >= 0, p["ids"][0] + 10000, -1)
    if case == "k-past":
        k, nprobe = TR.K_MAX, 1
        keep = torch.arange(block) < 5        # 5 live rows a list
        p["ids"] = torch.where(keep[None, :], p["ids"], -1)
    dev = {name: t.to(cuda_device) for name, t in p.items()}
    fn, plain, args, extra = _search_args(
        kind, q.contiguous().to(cuda_device), dev, index)
    shape = dict(nprobe=nprobe, k=k, nlist=nlist, block=block, **extra)
    TR.reset_launch_counts()
    got = fn(*args, **shape)
    want = plain(*args, **shape)
    torch.cuda.synchronize()
    assert TR.LAUNCHES == {"retrieve_flat": int(kind == "flat"),
                           "retrieve_pq": int(kind == "pq")}
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    if case == "k-past":
        assert bool((got[0] == -1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("d, m, ksub, nlist, block",
                         [(64, 8, 16, 16, 300), (64, 64, 127, 8, 50),
                          (226, 226, 127, 2, 9), (12, 3, 2, 4, 33),
                          (16, 4, 8, 4, 2500)])
def test_pq_scan_rounds_and_chunks(cuda_device, d, m, ksub, nlist, block):
    """IVF-PQ on seeded random books and codes, at plans off the bench:
    8 queries a round over a whole list of 300 rows (two passes of 256
    rows a warp); 5 a round (tables of 64 x 127 words); one query and
    chunks of 3 rows (the tightest shape the plan takes); ksub 2 with m =
    3 (codes read a byte at a time); lists of 2500 rows in 3 chunks: bit
    for bit the plain version at nprobe 1, 3 and nlist."""
    plan = TR.pq_plan(d, 10, nlist, block, m, ksub)
    assert (plan.scan_queries, plan.scan_rows) == {
        300: (8, 300), 50: (5, 50), 9: (1, 3), 33: (8, 33),
        2500: (8, 834)}[block]
    rng = np.random.default_rng(d + m + ksub)
    ids = np.arange(nlist * block, dtype=np.int32).reshape(nlist, block)
    ids[:, ::7] = -1
    host = {
        "centroids": rng.normal(size=(nlist, d)).astype(np.float32),
        "ids": ids,
        "codes": rng.integers(0, ksub, size=(nlist * block, m)).astype(
            np.int8),
        "cb_q": rng.integers(-127, 128, size=(m, ksub, d // m)).astype(
            np.int8),
        "cb_s": (rng.random(size=(m, ksub)) / 127).astype(np.float32),
    }
    t = {name: torch.from_numpy(v).to(cuda_device) for name, v in
         host.items()}
    q = torch.from_numpy(rng.normal(size=(300, d)).astype(np.float32)).to(
        cuda_device)
    args = (q, t["centroids"], t["ids"], t["codes"], t["cb_q"], t["cb_s"])
    for nprobe in sorted({1, min(3, nlist), nlist}):
        shape = dict(nprobe=nprobe, k=10, nlist=nlist, block=block, m=m)
        got = TR.retrieve_pq(*args, **shape)
        want = TR.retrieve_pq_plain(*args, **shape)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [30, 300])
def test_flat_search_odd_and_wide_rows(cuda_device, d):
    """Rows of d = 30 floats (4-byte copies, rows of d + 1 words) and d =
    300 (scan chunks of fewer than 256 rows, each row guarded): ids and
    distance bits equal to the plain version."""
    rng = np.random.default_rng(d)
    X = rng.normal(size=(700, d)).astype(np.float32)
    index = T.IVFIndex.build(X, 4, k=10, nprobe=2, seed=1, device="cpu")
    p = {name: torch.from_numpy(np.array(v)).to(cuda_device)
         for name, v in index.params.items()}
    assert (TR.flat_plan(d, 10, 4, index.block).scan_rows == 256) == (
        d == 30)
    q = torch.from_numpy(rng.normal(size=(33, d)).astype(np.float32)).to(
        cuda_device)
    for nprobe in (1, 2, 4):
        shape = dict(nprobe=nprobe, k=10, nlist=4, block=index.block)
        args = (q, p["centroids"], p["ids"], p["vecs"])
        got = TR.retrieve_flat(*args, **shape)
        want = TR.retrieve_flat_plain(*args, **shape)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b, nlist, nprobe", [(2000, 64, 1), (3000, 8, 8),
                                              (700, 16, 3)])
def test_list_major_spans_windows_and_rounds(cuda_device, b, nlist,
                                             nprobe):
    """The list-major scan where a block walks several 256-query windows
    of its span (b 2000 over 64 lists: one span) and scores its queries in
    many rounds of 8, and where the queries split into many spans (3000
    queries at nprobe = nlist = 8): bit for bit the plain version."""
    rng = np.random.default_rng(b)
    X = rng.normal(size=(40 * nlist, 16)).astype(np.float32)
    index = T.IVFIndex.build(X, nlist, k=10, nprobe=nprobe, seed=1,
                             device="cpu")
    p = {name: torch.from_numpy(np.array(v)).to(cuda_device)
         for name, v in index.params.items()}
    q = torch.from_numpy(rng.normal(size=(b, 16)).astype(np.float32)).to(
        cuda_device)
    shape = dict(nprobe=nprobe, k=10, nlist=nlist, block=index.block)
    args = (q, p["centroids"], p["ids"], p["vecs"])
    got = TR.retrieve_flat(*args, **shape)
    want = TR.retrieve_flat_plain(*args, **shape)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("chunks,workers,put_workers",
                         [(None, 1, 1), (3, 3, 2), (1, 2, 1)])
def test_pinned_prefetch_order_values_under_backpressure(
        cuda_device, chunks, workers, put_workers):
    """The pinned-staging transfer: a slow consumer (device sleeps before
    it reads each unit) keeps the pool of staging slots cycling many
    times; every unit arrives in order with its own values, so no slot
    was refilled while its copy could still be read."""
    from flink_ml_tpu_torch.data.prefetch import prefetch_to_device

    n = 40
    src = [(np.full((256, 512), i, np.float32),
            np.arange(300, dtype=np.int32) + i) for i in range(n)]
    seen = []
    for unit in prefetch_to_device(iter(src), device=cuda_device, depth=1,
                                   chunks=chunks, workers=workers,
                                   put_workers=put_workers):
        torch.cuda._sleep(2_000_000)    # the consumer's stream is busy
        if chunks is None:
            seen.append((unit[0].sum(), unit[1].clone()))
        else:
            chunk, mask, n_valid = unit
            for i in range(n_valid):
                seen.append((chunk[0][i].sum(), chunk[1][i].clone()))
    torch.cuda.synchronize()
    assert len(seen) == n
    for i, (total, ids) in enumerate(seen):
        assert float(total) == i * 256 * 512
        assert torch.equal(ids.cpu(), torch.arange(300, dtype=torch.int32)
                           + i)


@pytest.mark.cuda
def test_streamed_mixed_fit_launches_the_kernels_every_step(cuda_device,
                                                            tmp_path):
    """A small streamed mixed fit on the card: the margin (B1) and fused
    scatter (B2) kernels launch on every step; the fit equals the same
    stream through the plain versions within allclose(1e-3, 1e-4)
    (``bench.py:266``); W = 8 equals W = 1, the routing built in the decode
    workers equals the card's and an uncached fit the cached one, bit for
    bit."""
    from flink_ml_tpu_torch.data.datacache import (DataCacheReader,
                                                   DataCacheWriter)

    rng = np.random.default_rng(6)
    n = 2600
    cat = rng.integers(32, D, size=(n, 8)).astype(np.int32)
    y = rng.integers(0, 2, size=n).astype(np.float32)
    cat[:, 0] = np.where(y == 1, 16, 17)
    w = DataCacheWriter(str(tmp_path / "c"), segment_rows=1024)
    w.append({"d": rng.normal(size=(n, 4)).astype(np.float32), "c": cat,
              "label": y})
    w.finish()
    cfg = TS.SGDConfig(learning_rate=0.4, max_epochs=3, tol=0)

    def fit(**kw):
        return TS.sgd_fit_outofcore(
            LOSSES["logistic"],
            lambda: DataCacheReader(str(tmp_path / "c"), batch_rows=320),
            num_features=D, config=cfg, dense_key="d", indices_key="c",
            device=cuda_device, **kw)

    TE.reset_launch_counts()
    got, log = fit()
    steps = -(-n // 320) * 3
    assert TE.LAUNCHES["ell_margin"] == steps
    assert TE.LAUNCHES["ell_scatter_apply_fused"] == steps
    assert got.planned_impl == "ell-stream"
    plain, plain_log = fit(plain=True)
    np.testing.assert_allclose(got.coefficients, plain.coefficients,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(log, plain_log, rtol=1e-3, atol=1e-4)
    for kw in ({"steps_per_dispatch": 1}, {"cache_decoded": False}):
        other, other_log = fit(**kw)
        np.testing.assert_array_equal(other.coefficients, got.coefficients)
        assert other_log == log


@pytest.mark.cuda
def test_streamed_kmeans_launches_the_stats_kernel_every_batch(cuda_device,
                                                               tmp_path):
    """A streamed KMeans at 2^16 rows a batch (three full batches and a
    ragged one of 1000 rows, which runs at its own size): the stats kernel
    (B4) launches on every batch of every round; the centroids equal the
    same stream on the plain stats within chip_smoke.py's KMeans gate
    (allclose 5e-3, 5e-3), and a second fit gives the same bits."""
    from flink_ml_tpu_torch.data.datacache import (DataCacheReader,
                                                   DataCacheWriter)
    from flink_ml_tpu_torch.models.clustering import kmeans as TKM

    rng = np.random.default_rng(8)
    n = 3 * 65536 + 1000
    w = DataCacheWriter(str(tmp_path / "km"), segment_rows=65536)
    w.append({"features": rng.normal(size=(n, 16)).astype(np.float32)})
    w.finish()

    def fit(**kw):
        info = {}
        got = TKM.kmeans_fit_outofcore(
            lambda: DataCacheReader(str(tmp_path / "km"), batch_rows=65536),
            8, max_iter=3, seed=1, device=cuda_device, info=info, **kw)
        assert info["impl"] == "kernel"
        return got

    TK.reset_launch_counts()
    got = fit()
    assert TK.LAUNCHES["kmeans_update_stats"] == 4 * 3
    again = fit()
    np.testing.assert_array_equal(got, again)
    np.testing.assert_allclose(got, fit(plain=True), rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
def test_streamed_widedeep_w3_equals_w1(cuda_device, tmp_path):
    """A small streamed Wide&Deep on the card (5 batches, the last one
    padded; dense and lazy Adam): W = 3 equals W = 1 bit for bit, since the
    table gradients sum in a fixed order."""
    from flink_ml_tpu_torch.data.datacache import (DataCacheReader,
                                                   DataCacheWriter)

    rng = np.random.default_rng(9)
    n = 4 * 512 + 100
    cat = np.stack([rng.integers(0, 50, n), rng.integers(0, 7, n),
                    rng.integers(0, 3, n)], axis=1).astype(np.int32)
    w = DataCacheWriter(str(tmp_path / "wd"), segment_rows=1024)
    w.append({"denseFeatures": rng.normal(size=(n, 5)).astype(np.float32),
              "catFeatures": cat,
              "label": (cat[:, 0] % 2).astype(np.float32)})
    w.finish()
    for lazy in (False, True):
        def fit(W):
            return (T.WideDeep(device=cuda_device).set_vocab_sizes([50, 7, 3])
                    .set_max_iter(2).set_seed(3)
                    .set(T.WideDeep.LAZY_EMB_OPT, lazy)
                    .fit_outofcore(lambda: DataCacheReader(
                        str(tmp_path / "wd"), batch_rows=512),
                        steps_per_dispatch=W))

        one, three = fit(1), fit(3)
        assert one.loss_log == three.loss_log
        for k in ("emb", "wide_cat", "wide_dense"):
            np.testing.assert_array_equal(one._params[k], three._params[k])
        for a, b in zip(one._params["mlp"], three._params["mlp"]):
            np.testing.assert_array_equal(a["w"], b["w"])


@pytest.mark.cuda
def test_sparse_ftrl_step_gives_the_same_bits_twice(cuda_device):
    """The sparse FTRL step on one window with many repeated ids, run
    twice: the fixed-order gradient sum gives the same bits."""
    from flink_ml_tpu_torch.models.classification import (
        online_logisticregression as OLR)

    rng = np.random.default_rng(10)
    d, b = 1 << 12, 4096
    idx = torch.from_numpy(rng.integers(0, 64, size=(b, 39))).to(cuda_device)
    vals = torch.from_numpy(rng.normal(size=(b, 39)).astype(np.float32)
                            ).to(cuda_device)
    y = torch.from_numpy(rng.integers(0, 2, size=b).astype(np.float32)
                         ).to(cuda_device)
    sw = torch.ones(b, device=cuda_device)
    state = {k: torch.from_numpy(rng.normal(size=d).astype(np.float32)
                                 * (k == "w")).abs().to(cuda_device)
             for k in ("w", "z", "n")}
    runs = [OLR.sparse_ftrl_step(state, idx, vals, y, sw, 0.1, 1.0, 1e-4,
                                 1e-4) for _ in range(2)]
    for k in ("w", "z", "n"):
        assert torch.equal(runs[0][0][k], runs[1][0][k])
    assert torch.equal(runs[0][1], runs[1][1])


# -- fused pipeline segments ending in each terminal ---------------------------

def _scaled_pipeline(cuda_device, X, terminal):
    """StandardScaler -> MaxAbsScaler -> ``terminal(scaled table)`` on
    the card."""
    from flink_ml_tpu_torch.models.feature import MaxAbsScaler, StandardScaler

    dev = str(cuda_device)
    table = T.Table({"features": X})
    s1 = StandardScaler(device=dev).set_output_col("std").fit(table)
    t1 = s1.transform(table)[0]
    s2 = (MaxAbsScaler(device=dev).set_features_col("std")
          .set_output_col("ma").fit(t1))
    return T.PipelineModel([s1, s2, terminal(s2.transform(t1)[0])])


def _fused_and_stagewise(pm, table):
    from flink_ml_tpu_torch.api import chain

    with chain.chain_disabled():
        (ref,) = pm.transform(table)
    (out,) = pm.transform(table)
    for c in ref.column_names:
        assert np.array_equal(np.asarray(ref[c]), np.asarray(out[c])), c
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 4096])
def test_fused_linear_terminal_equals_stagewise(cuda_device, n):
    from flink_ml_tpu_torch.api import chain

    rng = np.random.default_rng(40)
    X = rng.normal(size=(n, 16)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    pm = _scaled_pipeline(cuda_device, X, lambda t: (
        T.LogisticRegression(device=str(cuda_device)).set_features_col("ma")
        .set_max_iter(2).fit(t.with_column("label", y))))
    table = T.Table({"features": X})
    _fused_and_stagewise(pm, table)
    assert pm._chain_plan([table]).describe() == [("segment", 3)]
    d0 = chain.dispatch_count()
    pm.transform(table)
    assert chain.dispatch_count() - d0 == 1


@pytest.mark.cuda
def test_fused_kmeans_terminal_launches_b5_once(cuda_device):
    rng = np.random.default_rng(41)
    X = rng.normal(size=(70000, 8)).astype(np.float32)
    pm = _scaled_pipeline(cuda_device, X, lambda t: (
        T.KMeans(device=str(cuda_device)).set_k(16).set_max_iter(3)
        .set_features_col("ma").fit(t)))
    held = T.Table({"features": X[:5000]})
    out = _fused_and_stagewise(pm, held)
    TK.reset_launch_counts()
    pm.transform(held)
    assert TK.LAUNCHES["kmeans_assign_reduce"] == 1
    scaled = pm.stages[1].transform(pm.stages[0].transform(held)[0])[0]
    P = np.asarray(scaled["ma"], np.float64)
    C = pm.stages[2]._centroids.astype(np.float64)
    d2 = ((P[:, None, :] - C[None]) ** 2).sum(-1)
    agree = np.asarray(out["prediction"]) == d2.argmin(1)
    srt = np.sort(d2, axis=1)
    near = (srt[:, 1] - srt[:, 0]) <= 1e-5 * srt[:, 1]
    assert (agree | near).all()


@pytest.mark.cuda
@pytest.mark.parametrize("pq", [None, (4, 8)])
def test_fused_ivf_terminal_launches_one_search(cuda_device, pq):
    from flink_ml_tpu_torch.models.feature import StandardScaler

    dev = str(cuda_device)
    rng = np.random.default_rng(42)
    X = rng.normal(size=(2000, 16)).astype(np.float32)
    corpus = T.Table({"query": X})
    sc = (StandardScaler(device=dev).set_features_col("query")
          .set_output_col("query").fit(corpus))
    scaled = np.asarray(sc.transform(corpus)[0]["query"], np.float32)
    index = T.IVFIndex.build(scaled, nlist=16, k=5, nprobe=2, seed=1,
                             pq=None if pq is None else T.PQConfig(*pq),
                             device=dev)
    pm = T.PipelineModel([sc, index])
    queries = T.Table({"query": X[:64]})
    out = _fused_and_stagewise(pm, queries)
    name = "retrieve_flat" if pq is None else "retrieve_pq"
    TR.reset_launch_counts()
    pm.transform(queries)
    assert TR.LAUNCHES[name] == 1
    nn, dist = index.search(scaled[:64])
    assert np.array_equal(np.asarray(out["neighbors"]), nn)
    assert np.array_equal(np.asarray(out["distances"]), dist)


@pytest.mark.cuda
def test_fused_widedeep_terminal_equals_stagewise(cuda_device):
    from flink_ml_tpu_torch.models.feature import StandardScaler

    dev = str(cuda_device)
    rng = np.random.default_rng(43)
    n = 512
    dense = rng.normal(size=(n, 13)).astype(np.float32)
    cat = rng.integers(0, 50, size=(n, 4)).astype(np.int32)
    t = T.Table({"denseFeatures": dense, "catFeatures": cat,
                 "label": (cat[:, 0] > 20).astype(np.float32)})
    sc = (StandardScaler(device=dev).set_features_col("denseFeatures")
          .set_output_col("denseFeatures").fit(t))
    wd = (T.WideDeep(device=dev).set_vocab_sizes([50] * 4).set_max_iter(1)
          .set_global_batch_size(128).fit(sc.transform(t)[0]))
    pm = T.PipelineModel([sc, wd])
    feats = t.drop("label")
    _fused_and_stagewise(pm, feats)
    assert pm._chain_plan([feats]).describe() == [("segment", 2)]
    bad = T.Table({"denseFeatures": dense, "catFeatures": cat + 50})
    with pytest.raises(ValueError):
        pm.transform(bad)


# -- serving -------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [8, 16, 32, 64, 128, 256])
def test_kmeans_assign_reduce_at_serving_buckets(cuda_device, bucket):
    """B5 at every bucket of the serving ladder (k 256, d 64): the
    assignments equal the plain version's off near-tie rows."""
    pts, _ = _kmeans_problem(bucket, 64, 256, seed=bucket)
    cents = np.random.default_rng(bucket).normal(size=(256, 64)).astype(
        np.float32)
    p = torch.from_numpy(pts).to(cuda_device)
    c = torch.from_numpy(cents).to(cuda_device)
    near = _near_tie_rows(_plain_scores(p, c))
    a = TK.kmeans_assign_reduce(p, c)[0]
    want = TK.kmeans_assign_reduce_plain(p, c)[0]
    assert torch.equal(a[~near], want[~near])


def _serve_all(endpoint, reqs):
    futures = [endpoint.submit(r) for r in reqs]
    return [f.result(60) for f in futures]


@pytest.mark.cuda
def test_kmeans_servable_launches_b5_once_a_batch(cuda_device):
    """Served on the card: one B5 launch a served batch, and every
    response equals the offline transform of its request."""
    from flink_ml_tpu_torch.serving import serve_model

    rng = np.random.default_rng(51)
    cents = rng.normal(size=(64, 16)).astype(np.float32)
    model = T.KMeansModel(device=str(cuda_device)).set_model_data(
        T.Table({"centroids": cents[None]}))
    X = rng.normal(size=(600, 16)).astype(np.float32)
    reqs = [T.Table({"features": X[i:i + 1 + i % 40]})
            for i in range(0, 560, 40)]
    refs = [model.transform(r)[0]["prediction"] for r in reqs]
    endpoint = serve_model(model, reqs[0], max_batch_rows=256,
                           max_wait_ms=2.0)
    try:
        TK.reset_launch_counts()
        b0 = endpoint.metrics.batches.value
        outs = _serve_all(endpoint, reqs)
        torch.cuda.synchronize()
        assert TK.LAUNCHES["kmeans_assign_reduce"] == \
            endpoint.metrics.batches.value - b0
        for out, ref in zip(outs, refs):
            np.testing.assert_array_equal(out["prediction"], ref)
    finally:
        endpoint.close()


@pytest.mark.cuda
@pytest.mark.parametrize("pq", [None, (4, 8)])
def test_ivf_servable_one_search_a_batch(cuda_device, pq):
    """Flat (B8) and IVF-PQ (B9) served on the card: one retrieve call a
    served batch; ids and distance bits equal ``search`` of each request
    alone."""
    from flink_ml_tpu_torch.serving import serve_model

    rng = np.random.default_rng(52)
    X = rng.normal(size=(4096, 16)).astype(np.float32)
    index = T.IVFIndex.build(
        X, nlist=16, pq=None if pq is None else T.PQConfig(*pq),
        nprobe=2, device=str(cuda_device))
    q = rng.normal(size=(300, 16)).astype(np.float32)
    reqs = [T.Table({"query": q[i:i + 1 + i % 30]})
            for i in range(0, 270, 30)]
    name = "retrieve_flat" if pq is None else "retrieve_pq"
    endpoint = serve_model(index, reqs[0], max_batch_rows=256,
                           max_wait_ms=2.0)
    try:
        TR.reset_launch_counts()
        b0 = endpoint.metrics.batches.value
        outs = _serve_all(endpoint, reqs)
        torch.cuda.synchronize()
        assert TR.LAUNCHES[name] == endpoint.metrics.batches.value - b0
        for req, out in zip(reqs, outs):
            nn, dist = index.search(req["query"])
            assert np.array_equal(out["neighbors"], nn)
            assert np.array_equal(out["distances"], dist)
    finally:
        endpoint.close()


@pytest.mark.cuda
def test_load_library_from_four_threads_builds_once(cuda_device,
                                                     monkeypatch, tmp_path):
    """Four threads' first use of a library at once: one nvcc, one loaded
    library, the launches counted."""
    from flink_ml_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LOADED", {})
    calls = []
    real = build.build_all

    def counting(names=None):
        calls.append(tuple(names))
        return real(names)

    monkeypatch.setattr(build, "build_all", counting)
    gate = threading.Barrier(4, timeout=60)
    libs = []

    def first_use():
        gate.wait()
        libs.append(build.load_library("kmeans"))

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert not any(t.is_alive() for t in threads)
    assert calls == [("kmeans",)]
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".so")]) == 1


@pytest.mark.cuda
def test_mixed_continuous_learner_launches_b1_b2_once_a_step(cuda_device,
                                                             tmp_path):
    """A mixed-layout ``ContinuousLearner`` on the card: the margin (B1)
    and fused scatter (B2) launch once per training step, the pair
    scatter never, and the served generation after the last cut is the
    offline streamed fit on the card bit for bit."""
    from flink_ml_tpu_torch.iteration import CheckpointConfig
    from flink_ml_tpu_torch.online import ContinuousLearner
    from flink_ml_tpu_torch.serving import serve_model

    rng = np.random.default_rng(61)
    n_windows, batch = 8, 512
    windows = []
    for _ in range(n_windows):
        dense = rng.normal(size=(batch, 4)).astype(np.float32)
        cat = rng.integers(0, D, size=(batch, 6)).astype(np.int32)
        y = (dense[:, 0] > 0).astype(np.float32)
        windows.append(T.Table({"features_dense": dense,
                                "features_indices": cat, "label": y}))
    boot = T.LogisticRegressionModel(device=str(cuda_device))
    boot.set_model_data(T.Table({"coefficients": np.zeros((1, D)),
                                 "intercept": np.zeros(1)}))
    endpoint = serve_model(boot, windows[0].drop("label").take(2),
                           max_batch_rows=32, max_wait_ms=0.5)
    keys = dict(dense_key="features_dense", indices_key="features_indices")
    cfg = TS.SGDConfig(learning_rate=0.4, max_epochs=1, tol=0.0)
    try:
        learner = ContinuousLearner(
            loss_fn=LOSSES["logistic"], num_features=D,
            source=iter(windows), wal_dir=str(tmp_path / "wal"),
            endpoint=endpoint, batch_rows=batch, config=cfg,
            checkpoint=CheckpointConfig(str(tmp_path / "ck")),
            publish_every_steps=4, device=str(cuda_device), **keys)
        TE.reset_launch_counts()
        learner.run(max_windows=n_windows)
        torch.cuda.synchronize()
        assert TE.LAUNCHES["ell_margin"] == n_windows
        assert TE.LAUNCHES["ell_scatter_apply_fused"] == n_windows
        assert TE.LAUNCHES["ell_scatter_apply"] == 0
        assert [r.step for r in learner.publish_log] == [4, 8]
        state, _ = TS.sgd_fit_outofcore(
            LOSSES["logistic"], lambda: (w.to_dict() for w in windows),
            num_features=D, config=cfg, steps_per_dispatch=4,
            device=str(cuda_device), **keys)
        served = endpoint.registry.current("default").servable.model
        assert np.asarray(served._state.coefficients, np.float32).tobytes() \
            == np.asarray(state.coefficients, np.float32).tobytes()
    finally:
        endpoint.close()


@pytest.mark.cuda
@pytest.mark.parametrize("pq", [None, (4, 8)])
def test_index_tenant_delta_calls_one_search_a_batch(cuda_device, pq):
    """An index tenant after a delta publish (64 inserts and 64 deletes):
    one retrieve call a served batch, ids and distance bits equal
    ``search`` of the updated index, the other tenant untouched."""
    from flink_ml_tpu_torch.online import DeltaEncoder
    from flink_ml_tpu_torch.online.driver import publish_index_update
    from flink_ml_tpu_torch.serving import SharedScheduler

    rng = np.random.default_rng(63)
    X = rng.normal(size=(4096, 16)).astype(np.float32)
    kw = dict(nlist=16, nprobe=2, device=str(cuda_device),
              drift_threshold=None)
    index = T.IVFIndex.build(X, pq=None if pq is None else T.PQConfig(*pq),
                             **kw)
    other = T.IVFIndex.build(X[::-1].copy(), **kw)
    q = rng.normal(size=(128, 16)).astype(np.float32)
    s = SharedScheduler(max_batch_rows=64, max_wait_ms=1.0)
    s.add_tenant("idx", index, T.Table({"query": q[:2]}))
    s.add_tenant("other", other, T.Table({"query": q[:2]}))
    s.start()
    try:
        other_gen = s.registry.current("other").generation
        ref_other = s.predict("other", T.Table({"query": q[:8]}),
                              timeout=60)
        pub, enc = s.delta_publisher("idx"), DeltaEncoder()
        publish_index_update(enc, pub, 1, "delta", index)
        mode, nxt = index.updated(inserts=q[:64] + 0.01,
                                  insert_ids=np.arange(5000, 5064),
                                  delete_ids=np.arange(64))
        assert mode == "delta"
        assert publish_index_update(enc, pub, 2, mode, nxt).mode == "delta"
        reqs = [T.Table({"query": q[i:i + 1 + i % 8]})
                for i in range(0, 120, 8)]
        name = "retrieve_flat" if pq is None else "retrieve_pq"
        TR.reset_launch_counts()
        b0 = s.tenant("idx").metrics.batches.value
        outs = [s.predict("idx", r, timeout=60) for r in reqs]
        torch.cuda.synchronize()
        assert TR.LAUNCHES[name] == s.tenant("idx").metrics.batches.value \
            - b0
        for req, out in zip(reqs, outs):
            nn, dist = nxt.search(req["query"])
            assert np.array_equal(out["neighbors"], nn)
            assert np.asarray(out["distances"]).tobytes() == dist.tobytes()
        assert s.registry.current("other").generation == other_gen
        again = s.predict("other", T.Table({"query": q[:8]}), timeout=60)
        assert np.array_equal(again["neighbors"], ref_other["neighbors"])
    finally:
        s.close()


@pytest.mark.cuda
def test_in_memory_fits_give_the_same_bits_twice(cuda_device):
    """The in-memory mixed LR fit (heavy indices and overflowing rows: the
    legs that used to add with atomics) and the Wide&Deep 'off' and lazy
    fits, each run twice on the card: the same bits."""
    dense, cat, y = _fit_data(n=2400)
    cat[:, 1] = 777                           # a heavy index
    cat[:, 2] = 128 * 5 + np.arange(len(y)) % 3  # an overflowing row
    cfg = TS.SGDConfig(learning_rate=0.3, max_epochs=2,
                       global_batch_size=600, tol=0, reg=0.01)
    fits = [TS.sgd_fit_mixed(LOSSES["logistic"], dense, cat, y, None, D,
                             cfg, device=cuda_device) for _ in range(2)]
    assert fits[0][0].planned_impl == "ell"
    np.testing.assert_array_equal(fits[0][0].coefficients,
                                  fits[1][0].coefficients)
    assert fits[0][1] == fits[1][1]

    rng = np.random.default_rng(12)
    n, vocab = 2000, [50, 30, 7]
    wcat = np.stack([rng.integers(0, v, size=n) for v in vocab], 1)
    wdense = rng.normal(size=(n, 5)).astype(np.float32)
    table = T.Table({"denseFeatures": wdense, "catFeatures": wcat,
                     "label": (wcat[:, 0] % 2).astype(np.int64)})
    for lazy in (False, True):
        def fit():
            return (T.WideDeep(device=cuda_device).set_vocab_sizes(vocab)
                    .set_max_iter(2).set_global_batch_size(256).set_seed(2)
                    .set(T.WideDeep.ROUTED_EMB_GRAD, "off")
                    .set(T.WideDeep.LAZY_EMB_OPT, lazy).fit(table))

        a, b = fit(), fit()
        assert a.loss_log == b.loss_log
        for k in ("emb", "wide_cat", "wide_dense", "wide_b"):
            np.testing.assert_array_equal(a._params[k], b._params[k])


def _gbt_level(n=40000, d=8, bins=32, n_nodes=4, seed=31):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, bins, size=(n, d)).astype(np.int32)
    ids = np.where(rng.random(n) < 0.2, -1,
                   rng.integers(0, n_nodes, size=n)).astype(np.int32)
    g = rng.normal(size=n).astype(np.float32)
    h = (rng.random(n) + 0.1).astype(np.float32)
    return binned, ids, g, h, d, bins, n_nodes


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["segsum", "mxu"])
def test_gbt_histograms_repeat_and_match_float64(cuda_device, impl):
    """Each histogram form on the card: two calls give the same bits, and
    the sums equal a float64 numpy histogram within the tolerance of
    ``bench.py:1388-1391`` (rtol 1e-4, atol 1e-5)."""
    from flink_ml_tpu_torch.models.common import gbt as TGB

    assert not torch.backends.cuda.matmul.allow_tf32
    binned, ids, g, h, d, bins, n_nodes = _gbt_level()
    args = [torch.from_numpy(a).to(cuda_device) for a in (binned, ids, g, h)]
    one = TGB._HIST_IMPLS[impl](*args, n_nodes, d, bins)
    two = TGB._HIST_IMPLS[impl](*args, n_nodes, d, bins)
    live = ids >= 0
    for got, again, v in zip(one, two, (g, h)):
        assert torch.equal(got, again)
        want = np.zeros((n_nodes, d, bins))
        for f in range(d):
            np.add.at(want, (ids[live], f, binned[live, f]),
                      v[live].astype(np.float64))
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
def test_gbt_fits_on_the_card(cuda_device, tmp_path):
    """A small GBT fit on the card: a second fit gives the same bits, the
    streamed fit at W 8 equals W 1 bit for bit, and the card's in-core
    forest predicts what the same fit on the CPU predicts (rtol 1e-4)."""
    from flink_ml_tpu_torch.models.common import gbt as TGB

    rng = np.random.default_rng(29)
    n, d = 20000, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=n)
         > 0).astype(np.float64)

    def grad_hess(yv, pred):
        p = 1.0 / (1.0 + np.exp(-pred))
        return p - yv, np.maximum(p * (1.0 - p), 1e-16)

    cfg = TGB.GBTConfig(num_trees=4, max_depth=4, max_bins=32,
                        learning_rate=0.2)
    a, b = (TGB.train_forest(X, y, grad_hess, 0.0, cfg, device=cuda_device)
            for _ in range(2))
    for k in ("feature", "threshold", "value"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    cpu = TGB.train_forest(X, y, grad_hess, 0.0, cfg, device="cpu")
    np.testing.assert_allclose(
        TGB.predict_forest(X, a, device=cuda_device),
        TGB.predict_forest(X, cpu, device="cpu"), rtol=1e-4, atol=1e-5)

    def reader():
        for s in range(0, n, 3000):
            yield {"features": X[s:s + 3000], "label": y[s:s + 3000]}

    streamed = {}
    for W in (1, 8):
        streamed[W] = TGB.train_forest_outofcore(
            reader, grad_hess, 0.0,
            TGB.GBTConfig(num_trees=3, max_depth=3, max_bins=32,
                          steps_per_dispatch=W),
            work_dir=str(tmp_path / f"w{W}"), batch_device_rows=2048,
            device=cuda_device)
    for k in ("feature", "threshold", "value"):
        np.testing.assert_array_equal(getattr(streamed[8], k),
                                      getattr(streamed[1], k))


def _als_neq_inputs(seed=41, n_groups=12, n_other=9, nnz=2000, rank=8):
    """A heavy group crossing chunks and 10% zero weights."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n_groups, size=nnz)
    g[:800] = 3
    o = rng.integers(0, n_other, size=nnz)
    r = rng.normal(size=nnz).astype(np.float32)
    w = np.where(rng.random(nnz) < 0.1, 0.0, 1.0).astype(np.float32)
    factors = rng.normal(size=(n_other, rank)).astype(np.float32)
    return n_groups, g, o, r, w, factors


@pytest.mark.cuda
@pytest.mark.parametrize("implicit", [False, True])
def test_als_normal_equations_on_the_card_match_cpu(cuda_device, implicit,
                                                    monkeypatch):
    """Both normal-equation forms on the card against the port on the CPU
    (rtol 1e-4, atol 1e-4: f32 sums in another order), each twice bit for
    bit; the scatter form in chunks of 256 through the fixed-order
    scatter-add."""
    from flink_ml_tpu_torch.models.recommendation import als as TA

    assert not torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(TA, "_CHUNK", 256)
    n_groups, g, o, r, w, factors = _als_neq_inputs()
    r = np.abs(r) if implicit else r
    plan = TA.NeqPlan(g, chunk=256)
    out = {}
    for dev in ("cpu", cuda_device):
        f = torch.from_numpy(factors).to(dev)
        raw = [torch.from_numpy(a).to(dev) for a in (g, o, r, w)]
        side = plan.side_data(o, r, w, dev)
        out[str(dev)] = [
            [TA._normal_equations(f, *raw, n_groups, implicit, 0.7)
             for _ in range(2)],
            [TA._normal_equations_sorted(f, *side, plan.g_lo, n_groups,
                                         plan.span, plan.chunk, implicit,
                                         0.7) for _ in range(2)]]
    for (card_one, card_two), (cpu_one, _) in zip(out[str(cuda_device)],
                                                  out["cpu"]):
        for a, b, c in zip(card_one, card_two, cpu_one):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.cpu().numpy(), c.numpy(),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_als_fits_repeat_bit_for_bit_on_the_card(cuda_device):
    """Sorted, scatter and workset ALS fits on the card, each run twice:
    the same bits; each within 5e-3 of the same fit on the CPU."""
    rng = np.random.default_rng(42)
    n = 3000
    users = rng.integers(0, 60, n)
    items = rng.integers(0, 40, n)
    ratings = (np.sin(users * 0.3) + np.cos(items * 0.5)
               + 0.05 * rng.normal(size=n)).astype(np.float32)
    table = T.Table({"user": users, "item": items, "rating": ratings})

    def fit(form, dev):
        est = (T.models.ALS(device=dev).set_rank(8).set_max_iter(5)
               .set_seed(0))
        if form == "workset":
            est.set_workset_tol(1e-4)
        else:
            est.set(T.models.ALS.NEQ_IMPL, form)
        data = est.fit(table).get_model_data()[0]
        assert est.planned_impl == form
        return data["userFactors"][0], data["itemFactors"][0]

    for form in ("sorted", "scatter", "workset"):
        one, two = fit(form, cuda_device), fit(form, cuda_device)
        cpu = fit(form, "cpu")
        for a, b, c in zip(one, two, cpu):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, c, rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
def test_als_solve_masks_failed_factorizations_on_the_card(cuda_device):
    """``cholesky_ex`` on the card: an exactly singular system, an
    unobserved group and an indefinite one (whose failed factor solves to
    finite values) keep ``prev``; a regular system solves as on the CPU.
    Nothing raises."""
    from flink_ml_tpu_torch.models.recommendation import als as TA

    A = np.zeros((4, 3, 3), np.float32)
    A[0] = np.outer([1.0, 2.0, 0.0], [1.0, 2.0, 0.0])
    A[2] = np.diag([1.0, -1.0, 1.0])
    A[3] = np.eye(3) * 2.0 + 0.1
    b = np.arange(12, dtype=np.float32).reshape(4, 3)
    cnt = np.array([1.0, 0.0, 2.0, 3.0], np.float32)
    prev = np.full((4, 3), 7.0, np.float32)
    factors = np.ones((5, 3), np.float32)
    got = {}
    for dev in ("cpu", cuda_device):
        args = [torch.from_numpy(a).to(dev)
                for a in (prev, factors, A, b, cnt)]
        got[str(dev)] = TA._solve_from_neq(*args, 0.0, False).cpu().numpy()
    card = got[str(cuda_device)]
    np.testing.assert_array_equal(card[:3], prev[:3])
    np.testing.assert_allclose(card[3], got["cpu"][3], rtol=1e-5)


@pytest.mark.cuda
def test_swing_and_minhash_on_the_card_match_cpu(cuda_device):
    """Swing scores on the card within rtol 1e-5 of the CPU's, twice bit
    for bit; MinHash signatures equal the CPU's exactly."""
    from flink_ml_tpu_torch.models.feature import MinHashLSH
    from flink_ml_tpu_torch.models.recommendation import swing as TSW

    rng = np.random.default_rng(5)
    B = (rng.random((300, 60)) < 0.15).astype(np.float32)
    cpu = TSW._swing_scores(torch.from_numpy(B), 15.0, 0.0, 0.3, 128)
    one, two = (TSW._swing_scores(torch.from_numpy(B).to(cuda_device), 15.0,
                                  0.0, 0.3, 128) for _ in range(2))
    assert torch.equal(one, two)
    np.testing.assert_allclose(one.cpu().numpy(), cpu.numpy(), rtol=1e-5,
                               atol=1e-7)

    X = (rng.random((500, 64)) < 0.1).astype(np.float64)
    X[:, 0] = 1.0
    sigs = []
    for dev in ("cpu", cuda_device):
        model = (MinHashLSH(device=dev).set_num_hash_tables(4)
                 .set_num_hash_functions_per_table(4).set_seed(9)
                 .fit(T.Table({"features": X})))
        sigs.append(model.transform(T.Table({"features": X}))[0]["output"])
    np.testing.assert_array_equal(sigs[0], sigs[1])


@pytest.mark.cuda
def test_idf_and_anova_on_the_card_match_cpu(cuda_device):
    """IDF's product on the card equals the CPU's bit for bit (one f32
    multiply).  ANOVA's class moments and the Pearson r (the f32 work on
    the device, summed in another order) within rtol 1e-5 of the CPU's
    (moments: of each column's largest magnitude; r: atol 1e-6).  The F
    values then agree within that error carried through the host
    formula: ANOVA's ``ss_within = total_sq - ss_between`` cancels, so
    its F moves by up to 1e-5 times ``total_sq / ss_within``;
    F-regression's by 2e-6 / (|r| (1 - r^2)).  The selectors pick the
    same indices on this seeded table."""
    from flink_ml_tpu_torch.models import feature as TF
    from flink_ml_tpu_torch.models import stats as ST
    from flink_ml_tpu_torch.models.stats import anovatest, fvaluetest

    rng = np.random.default_rng(42)
    counts = rng.poisson(0.3, size=(500, 300)).astype(np.float64)
    y = rng.integers(0, 5, size=500)
    counts[:, :10] += y[:, None] * np.arange(1, 11)
    table = T.Table({"features": counts, "label": y})
    out = {}
    for where in (cuda_device, "cpu"):
        model = TF.IDF(device=where).fit(table)
        out[str(where)] = model.transform(table)[0]["output"]
    a, b = out[str(cuda_device)], out["cpu"]
    assert a.dtype == b.dtype == np.float64
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))

    x32 = torch.as_tensor(a.astype(np.float32))
    onehot = torch.as_tensor(np.eye(5, dtype=np.float32)[y])
    card, cpu = ([t.cpu().numpy().astype(np.float64) for t in
                  anovatest._class_moments(x32.to(w), onehot.to(w))]
                 for w in (cuda_device, "cpu"))
    for got, want in zip(card, cpu):
        scale = np.abs(want).max(axis=0)
        assert np.all(np.abs(got - want) <= 1e-5 * scale)
    counts_k, s, _, total_sq = cpu
    ss_within = total_sq - np.sum(s * s / counts_k[:, None], axis=0)
    cond = np.maximum(total_sq / ss_within, 1.0)
    f_card = ST.anova_f_scores(a, y, device=cuda_device)[0]
    f_cpu = ST.anova_f_scores(a, y, device="cpu")[0]
    assert np.all(np.abs(f_card - f_cpu) <= 1e-5 * cond * f_cpu)

    yr = a[:, 3] * 2 + rng.normal(size=500)
    y32 = torch.as_tensor(yr.astype(np.float32))
    r_card, r_cpu = (fvaluetest._pearson_r(x32.to(w), y32.to(w)).cpu()
                     .numpy().astype(np.float64)
                     for w in (cuda_device, "cpu"))
    np.testing.assert_allclose(r_card, r_cpu, rtol=0, atol=1e-6)
    fr_card = ST.f_regression_scores(a, yr, device=cuda_device)[0]
    fr_cpu = ST.f_regression_scores(a, yr, device="cpu")[0]
    r = np.abs(r_cpu)
    assert np.all(np.abs(fr_card - fr_cpu)
                  <= fr_cpu * 2e-6 / (r * (1 - r * r)) + 1e-12)
    for ltype, label in (("categorical", y), ("continuous", yr)):
        idx = {}
        for where in (cuda_device, "cpu"):
            sel = (TF.UnivariateFeatureSelector(device=where)
                   .set_feature_type("continuous").set_label_type(ltype)
                   .set_selection_threshold(8))
            idx[str(where)] = sel.fit(T.Table({"features": a, "label":
                                               label})).get_model_data(
                )[0]["indices"]
        assert np.array_equal(idx[str(cuda_device)], idx["cpu"])


@pytest.mark.cuda
def test_hashed_sparse_lr_launches_b1_b2_value_variants(cuda_device):
    """SQLTransformer -> FeatureHasher(sparseOutput) -> LogisticRegression
    on the card: the pair columns (nnz 13 + 26) plan "ell" and launch the
    margin and the fused scatter once a step each; the fit equals the same
    fit through the plain versions on the card."""
    from flink_ml_tpu_torch.models import feature as TF

    d, n, batch = D, 1200, 400
    dense, cat, y = _fit_data(n=n, d=d, seed=8)
    cols = {f"I{j + 1}": dense[:, j] for j in range(13)}
    cols.update({f"C{f + 1}": np.char.mod("%08x", cat[:, f])
                 for f in range(26)})
    cols["label"] = y
    stmt = ("SELECT " + ", ".join(
        [f"LOG1P(MAX(I{j + 1}, 0)) AS I{j + 1}" for j in range(13)]
        + [f"C{f + 1}" for f in range(26)] + ["label"]) + " FROM __THIS__")
    (logged,) = TF.SQLTransformer().set_statement(stmt).transform(
        T.Table(cols))
    (hashed,) = (TF.FeatureHasher().set_input_cols(
        *[f"I{j + 1}" for j in range(13)], *[f"C{f + 1}" for f in range(26)])
        .set_num_features(d).set_sparse_output(True)
        .set_output_col("features").transform(logged))
    est = (T.LogisticRegression(device=cuda_device).set_num_features(d)
           .set_global_batch_size(batch).set_max_iter(2).set_tol(0))
    TE.reset_launch_counts()
    model = est.fit(hashed)
    torch.cuda.synchronize()
    assert model.planned_impl == "ell"
    assert TE.LAUNCHES == {"ell_margin": 3 * 2,
                           "ell_scatter_apply_fused": 3 * 2,
                           "ell_scatter_apply": 0}
    want, _ = TS.sgd_fit_sparse(
        LOSSES["logistic"], hashed["features_indices"],
        hashed["features_values"], y, None, d, est._sgd_config(),
        device=cuda_device, plain=True)
    np.testing.assert_allclose(
        model.get_model_data()[0]["coefficients"][0], want.coefficients,
        rtol=1e-3, atol=1e-4)


def _bf16_scores(pts, cents):
    return TK._scores(pts, cents, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("tie", ["first", "fast", "split"])
@pytest.mark.parametrize("n,d,k,dup", [(1000, 16, 37, False),
                                       (4099, 64, 256, True),
                                       (300, 9, 40, True),
                                       (4099, 64, 1024, False),
                                       (2050, 300, 600, True),
                                       (2050, 128, 200, True),
                                       (1000, 64, 257, False),
                                       (700, 65, 64, True)])
def test_kmeans_update_stats_bf16_matches_plain(cuda_device, monkeypatch,
                                                tie, n, d, k, dup):
    """The bf16 variant against its plain twin (the same roundings) on
    ragged n, k not a power of two, duplicated centroids, 7 zero pad rows,
    on both sides of the route (``bf16_plan``: ``kmeans_bf16.cu`` for
    k <= 256, d <= 64; else ``kmeans.cu``'s bf16 modes, with its
    staged-centroid and no-tile plans at k 1024 and d 300), each shape
    asserting the kernel it took.  The two differ only in the order of the
    f32 sums of the score product: off rows whose best two bf16 scores lie
    within 1e-5 (1 + |best|) of each other the counts are exact and the
    sums within 1e-4; a near-tie row may move one count.  Two launches
    give the same bits.  The bf16 launches count apart from the f32
    ones."""
    pts, cents = _kmeans_problem(n, d, k, seed=n + d, duplicated=dup,
                                 n_pad=7)
    p = torch.from_numpy(pts).to(cuda_device)
    c = torch.from_numpy(cents).to(cuda_device)
    near = int(_near_tie_rows(_bf16_scores(p, torch.unique(c, dim=0)))
               .sum())
    routes = []
    for name, label in (("_launch_bf16", "kmeans_bf16.cu"),
                        ("_launch", "kmeans.cu")):
        def spy(*args, _real=getattr(TK, name), _label=label, **kw):
            routes.append(_label)
            return _real(*args, **kw)
        monkeypatch.setattr(TK, name, spy)
    TK.reset_launch_counts()
    got_s, got_c = TK.kmeans_update_stats(p, c, tie_policy=tie,
                                          compute_dtype=torch.bfloat16)
    want_s, want_c = TK.kmeans_update_stats_plain(
        p, c, tie_policy=tie, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert routes == ["kmeans_bf16.cu" if TK.bf16_plan(k, d) else
                      "kmeans.cu"]
    assert TK.LAUNCHES["kmeans_update_stats_bf16"] == 1
    assert TK.LAUNCHES["kmeans_update_stats"] == 0
    again_s, again_c = TK.kmeans_update_stats(p, c, tie_policy=tie,
                                              compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(again_s, got_s) and torch.equal(again_c, got_c)
    if near:
        assert float((got_c - want_c).abs().sum()) <= 4 * near
    else:
        torch.testing.assert_close(got_c, want_c, atol=0, rtol=0)
        torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-5)
    if dup and tie != "first":
        # the duplicated least-norm centroid ties for every zero pad row
        corr = TK.pad_correction(got_c, c, 7, tie_policy=tie)
        assert float(corr.min()) >= 0
        assert corr[0] == corr[k - 1] and corr[1] == corr[k - 2]


@pytest.mark.cuda
@pytest.mark.parametrize("tie", ["first", "fast", "split"])
def test_kmeans_bf16_kernel_sees_bf16_operands(cuda_device, tie):
    """Both products of ``kmeans_bf16.cu`` take bf16 operands: 128 copies
    of p = (1.124, 0) are nearer (1, 0) than (1.25, 0) in f32, but bf16(p)
    = (1.125, 0) ties them exactly (``first`` takes index 0, ``fast``
    both, ``split`` halves) and the sums add 1.125 a copy.  The kernel
    equals the bf16 twin bit for bit and not the f32 one (the same problem
    is held against the JAX kernel in
    ``tests/test_torch_kmeans_bf16_plan.py``)."""
    pts = np.tile(np.array([[1.124, 0.0]], np.float32), (128, 1))
    cents = np.array([[1.25, 0.0], [1.0, 0.0], [-5.0, -5.0]], np.float32)
    p = torch.from_numpy(pts).to(cuda_device)
    c = torch.from_numpy(cents).to(cuda_device)
    assert TK.bf16_plan(3, 2) is not None
    got = TK.kmeans_update_stats(p, c, tie_policy=tie,
                                 compute_dtype=torch.bfloat16)
    want = TK.kmeans_update_stats_plain(p, c, tie_policy=tie,
                                        compute_dtype=torch.bfloat16)
    f32 = TK.kmeans_update_stats_plain(p, c, tie_policy=tie)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[1], f32[1])
    assert float(got[0][0, 0]) == 1.125 * (128 if tie != "split" else 64)


@pytest.mark.cuda
def test_kmeanspp_seeds_on_the_card_without_a_host_sync(cuda_device):
    """k-means++ on the card: the k-1 rounds run with CUDA's sync debug
    mode at "error" (any host sync raises); one seed gives one seeding,
    k distinct rows of the points; the fit through ``initMode`` launches
    the stats kernel once a round."""
    from flink_ml_tpu_torch.models.clustering import kmeans as TKM

    pts, _ = _kmeans_problem(70000, 8, 16, seed=21)
    p = torch.from_numpy(pts).to(cuda_device)

    def seed(s):
        gen = torch.Generator(device=cuda_device)
        gen.manual_seed(s)
        return TKM.select_kmeanspp_centroids(p, 64, generator=gen)

    seed(0)                      # first-call set-up outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = seed(5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(a, seed(5))
    assert not torch.equal(a, seed(6))
    rows = (p[None, :, :] == a[:, None, :]).all(-1)
    assert rows.any(1).all() and len(torch.unique(a, dim=0)) == 64
    TK.reset_launch_counts()
    est = (T.KMeans(device=cuda_device).set_k(16).set_max_iter(4)
           .set_seed(5).set_init_mode("k-means++"))
    est.fit(T.Table({"features": pts}))
    torch.cuda.synchronize()
    assert est.planned_impl == "kernel"
    assert TK.LAUNCHES["kmeans_update_stats"] == 4


def _card_rank_fit(rank, world, n, dtype):
    """One rank's KMeans fit of its share of a seeded table on the card
    (in a process group), with the stats launches it made."""
    pts, _ = _kmeans_problem(n, 8, 16, seed=23)
    share = np.split(pts, world)[rank]
    TK.reset_launch_counts()
    model = (T.KMeans(device="cuda:0", compute_dtype=getattr(torch, dtype))
             .set_k(16).set_max_iter(5).set_seed(2)
             .fit(T.Table({"features": share})))
    torch.cuda.synchronize()
    return (model.get_model_data()[0]["centroids"][0], dict(TK.LAUNCHES))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_grouped_fit_on_the_card(cuda_device, world, backend, dtype):
    """The data-parallel fit on the card: a one-rank NCCL group and two
    gloo ranks sharing the card (NCCL refuses two ranks on one device).
    Each rank launches its stats kernel once a round; the one-rank fit
    equals the one-process fit from the same init bit for bit, the
    two-rank fit within the KMeans gate of it (its sums add per rank,
    then across ranks)."""
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.models.clustering import kmeans as TKM
    from flink_ml_tpu_torch.utils.backend import run_on_ranks

    n = 1 << 17
    out = run_on_ranks(_card_rank_fit, world, world, n, dtype,
                       device="cuda:0", backend=backend, timeout_s=240)
    key = ("kmeans_update_stats_bf16" if dtype == "bfloat16"
           else "kmeans_update_stats")
    for cents, launches in out:
        assert launches[key] == 5 and sum(launches.values()) == 5
        np.testing.assert_array_equal(cents, out[0][0])
    pts, _ = _kmeans_problem(n, 8, 16, seed=23)
    shard0 = np.split(pts, world)[0]
    measure = DistanceMeasure.get_instance("euclidean")
    init = torch.from_numpy(TKM.select_random_centroids(shard0, 16, 2)).to(
        cuda_device)
    p = torch.from_numpy(pts).to(cuda_device)
    want = TKM.fit_centroids(
        p, torch.ones(n, device=cuda_device), init,
        TKM._fit_plan(n, 8, 16, measure), measure=measure, max_iter=5,
        compute_dtype=getattr(torch, dtype)).state.cpu().numpy()
    if world == 1:
        np.testing.assert_array_equal(out[0][0], want)
    else:
        np.testing.assert_allclose(out[0][0], want, rtol=5e-3, atol=5e-3)


def _rank_reduces(rank, world, device):
    """Three reduces of each compressed mode on this rank's rows of a
    seeded gradient, on ``device``: the reduced trees, the residuals and
    the pairwise rounds staged through the host."""
    from flink_ml_tpu_torch.parallel import collectives as TC
    from flink_ml_tpu_torch.parallel import grad_reduce as TGR
    from flink_ml_tpu_torch.parallel.grad_reduce import GradReduceConfig

    rng = np.random.default_rng(31)
    w = rng.normal(size=(3, world, 4099)).astype(np.float32)
    w[:, :, :16] = 0.0                       # ties at zero
    b = rng.normal(size=(3, world)).astype(np.float32)
    configs = {
        "topk_rd": GradReduceConfig(mode="topk", density=0.1),
        "topk_allgather": GradReduceConfig(mode="topk", density=0.1,
                                           wire_protocol="allgather"),
        "topk_buckets": GradReduceConfig(mode="topk", density=0.1,
                                         bucket_count=3),
        "int8": GradReduceConfig(mode="int8", block_size=64, seed=3),
        "int8_fixed": GradReduceConfig(mode="int8", block_size=64, seed=3,
                                       int8_accum="fixed"),
    }
    TC.reset_staged()
    out = {}
    for name, cfg in configs.items():
        def grads(s):
            return {"w": torch.from_numpy(w[s, rank]).to(device),
                    "b": torch.tensor(b[s, rank], device=device)}

        state = TGR.init_state(cfg, grads(0))
        reds = []
        for s in range(3):
            red, state = TGR.reduce_gradients(grads(s), state, cfg)
            reds.append(red)
        out[name] = {"red": reds, "ef": state.get("ef")}
    out["staged"] = dict(TC.STAGED)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_grad_reduce_on_the_card_equals_cpu(cuda_device, world, backend):
    """The top-k (rd, all-gather, buckets) and int8 (dequant, fixed)
    reduces in a one-rank NCCL group and on two gloo ranks sharing the
    card give the bits of the same code on CPU ranks: a stable sort's
    selection, fixed-order scatter-adds, integer rounding draws.  gloo
    ranks stage their pairwise rounds through the host; NCCL stages
    nothing."""
    from flink_ml_tpu_torch.utils.backend import run_on_ranks

    card = run_on_ranks(_rank_reduces, world, world, "cuda:0",
                        device="cuda:0", backend=backend, timeout_s=240)
    cpu = run_on_ranks(_rank_reduces, world, world, "cpu", timeout_s=240)
    for got, want in zip(card, cpu):
        for name in want:
            if name == "staged":
                continue
            for s in range(3):
                for k in ("w", "b"):
                    np.testing.assert_array_equal(
                        got[name]["red"][s][k], want[name]["red"][s][k],
                        err_msg=f"{name} step {s} {k}")
            if want[name]["ef"] is not None:
                np.testing.assert_array_equal(got[name]["ef"]["w"],
                                              want[name]["ef"]["w"],
                                              err_msg=name)
        assert (got["staged"]["rounds"] > 0) == (backend == "gloo")
