"""The port's data parallelism (``parallel/``, ``data/broadcast.py``,
``utils/backend.py``) on 2 and 4 gloo CPU ranks, spawned by
``run_on_ranks`` (one process a rank, each with its own deadline), against
numpy and the JAX package.

- Each collective against numpy on the ranks' seeded inputs.
- ``KMeans.fit`` inside the group, each rank with its shard, against the
  JAX package on the concatenated rows from the same initial centroids
  (the JAX package's ``select_random_centroids`` of rank 0's shard with
  the fit's seed), the JAX side iterating ``kmeans_epoch_step`` (and the
  workset body) on its 8-device CPU mesh, a psum over devices: the plain
  plan and the workset fit (4000 rows); the kernel plan (65536 rows; on
  the CPU the stats op's plain twin, then the all-reduce) against the
  JAX package's kernel body on the same mesh (``kmeans_epoch_step_pallas``
  over ``update_stats_sharded``, in interpret mode), which scores as the
  port's stats op does; bf16 and k-means++ against the port's own
  one-process fit.
- rank 0's too-small shard and unequal shards raise on every rank.

Each world size spawns its ranks once (a module fixture) and the tests
read their results."""

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as R
from flink_ml_tpu.distance import DistanceMeasure as JDistance
from flink_ml_tpu.iteration import IterationConfig, iterate as jiterate
from flink_ml_tpu.models.clustering import kmeans as JKM
from flink_ml_tpu.parallel.mesh import device_mesh, replicate
from flink_ml_tpu_torch.distance import DistanceMeasure as TDistance
from flink_ml_tpu_torch.models.clustering import kmeans as TKM
from flink_ml_tpu_torch.utils.backend import run_on_ranks

WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 120
K, D = 5, 4
N_SMALL, N_BIG = 4000, 1 << 16
SEED = 3
# 4000 rows: the same assignments, f32 sums of a cluster in another order
PLAIN_TOL = dict(rtol=1e-5, atol=1e-5)
# 65536 rows: a few rows lie within f32 rounding of a tie (top-two gaps of
# 3e-5 at scores ~100 in some rounds), and two packages (or two sum
# orders) may send such a row to either centroid; a flip moves a
# ~13000-row cluster's centroid by |p - c| / 13000, ~5e-4 here, so up to
# ~4 flips
FLIP_TOL = dict(rtol=1e-4, atol=2e-3)


def _blobs(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(K, D)) * 8.0
    return (centers[rng.integers(0, K, n)]
            + rng.normal(size=(n, D))).astype(np.float32)


SMALL, BIG = _blobs(N_SMALL, 1), _blobs(N_BIG, 2)


def _cases(world):
    def split(X):
        return np.split(X, world)

    small_host0 = [SMALL[:3]] + [SMALL[3:100]] * (world - 1)
    unequal = [SMALL[:1000 + r] for r in range(world)]
    base = dict(k=K, seed=SEED)
    return [
        ("plain", split(SMALL), dict(base, max_iter=10), "float32"),
        ("kernel", split(BIG), dict(base, max_iter=8), "float32"),
        ("kernel_bf16", split(BIG), dict(base, max_iter=8), "bfloat16"),
        ("workset", split(SMALL), dict(base, max_iter=30, workset=True),
         "float32"),
        ("kpp", split(SMALL), dict(base, max_iter=10,
                                   init_mode="k-means++"), "float32"),
        ("host0_small", small_host0, dict(base), "float32"),
        ("unequal", unequal, dict(base), "float32"),
    ]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"w{w}")
def ranks(request):
    world = request.param
    cases = _cases(world)
    out = run_on_ranks(R.work, world, world, cases,
                       timeout_s=SPAWN_TIMEOUT_S)
    return world, cases, out


def _mesh8():
    return device_mesh({"data": 8}, devices=jax.devices()[:8])


def _jax_fit(X, init, max_iter, workset=False, kernel=False):
    """The JAX package's Lloyd's rounds on its 8-device CPU mesh: the
    fit's ``iterate`` over sharded rows (``_prepare_points``); ``kernel``
    runs its kernel body (the Pallas stats kernel in interpret mode on
    each device's shard, then one psum)."""
    mesh = _mesh8()
    measure = JDistance.get_instance("euclidean")
    points, mask = JKM._prepare_points(
        X, mesh, row_multiple=2048 if kernel else 1,
        fill="zero" if kernel else "first_row")
    init_dev = replicate(init, mesh)
    if kernel:
        res = jiterate(JKM.kmeans_epoch_step_pallas(
            K, mesh, block_n=2048, tie_policy="first", interpret=True),
            init_dev, (points, mask), max_epochs=max_iter,
            config=IterationConfig(mode="fused"))
    elif workset:
        plan = JKM._fit_plan(len(X), D, K, measure, mesh, workset=True)
        assert plan.impl == "xla"
        res = jiterate(JKM.kmeans_workset_epoch_step(measure, K), init_dev,
                       (points, mask), max_epochs=max_iter,
                       workset=plan.init_workset(mask),
                       config=IterationConfig(mode="fused"))
    else:
        res = jiterate(JKM.kmeans_epoch_step(measure, K), init_dev,
                       (points, mask), max_epochs=max_iter,
                       config=IterationConfig(mode="fused"))
    return np.asarray(res.state), res.num_epochs


def _fit(out, name):
    """The case's result, the same centroids bit for bit on every rank."""
    fits = [o["fits"][name] for o in out]
    for f in fits[1:]:
        np.testing.assert_array_equal(f["centroids"], fits[0]["centroids"])
    return fits[0]


def test_collectives_against_numpy(ranks):
    world, _, out = ranks
    xs = [R.rank_value(r) for r in range(world)]
    total = np.sum(xs, axis=0)
    for r, o in enumerate(out):
        c = o["coll"]
        assert c["mesh"] == ({"data": world}, world, world, 8, 1)
        np.testing.assert_allclose(c["psum"], total, rtol=1e-6)
        np.testing.assert_allclose(c["pmean"], total / world, rtol=1e-6)
        np.testing.assert_array_equal(c["pmax"], np.max(xs, axis=0))
        np.testing.assert_allclose(c["tree"]["a"], total, rtol=1e-6)
        np.testing.assert_allclose(c["tree"]["b"][1], total[1:], rtol=1e-6)
        np.testing.assert_allclose(c["packed"][0], total, rtol=1e-6)
        assert c["packed"][1].dtype == np.int64
        np.testing.assert_array_equal(
            c["packed"][1], world * np.arange(3) + world * (world - 1) // 2)
        np.testing.assert_array_equal(c["gather"], np.concatenate(xs))
        np.testing.assert_array_equal(c["stack"], np.stack(xs))
        np.testing.assert_allclose(c["scatter"], total, rtol=1e-6)
        np.testing.assert_allclose(c["scatter1"], total, rtol=1e-6)
        np.testing.assert_array_equal(c["ring1"], xs[(r - 1) % world])
        np.testing.assert_array_equal(c["ring2"], xs[(r - 2) % world])
        assert (c["index"], c["size"]) == (r, world)
        np.testing.assert_array_equal(
            c["allgather"], [[q, 10 * q] for q in range(world)])
        np.testing.assert_array_equal(c["bcast_np"], np.zeros((2, 3)))
        np.testing.assert_array_equal(c["bcast_t"]["t"], xs[0])
        assert (c["info"].process_index, c["info"].process_count,
                c["info"].global_device_count) == (r, world, world)
        assert c["info"].is_coordinator == (r == 0)
        assert c["device"] == "cpu"
        np.testing.assert_array_equal(c["shard"]["rows"], np.arange(5))
        np.testing.assert_array_equal(c["global"], np.arange(3) + r)
        np.testing.assert_array_equal(c["bcast_var"], np.arange(3.0) + 1)
        assert "equal padded row counts" in c["unequal_shard"]


@pytest.mark.parametrize("name,X,max_iter,tol", [
    ("plain", SMALL, 10, PLAIN_TOL), ("kernel", BIG, 8, FLIP_TOL)])
def test_kmeans_fit_matches_jax_sharded(ranks, name, X, max_iter, tol):
    world, cases, out = ranks
    shards = dict((c[0], c[1]) for c in cases)[name]
    fit = _fit(out, name)
    assert fit["impl"] == name
    init = JKM.select_random_centroids(shards[0], K, SEED)
    want, _ = _jax_fit(X, init, max_iter, kernel=name == "kernel")
    np.testing.assert_allclose(fit["centroids"], want, **tol)


def test_workset_fit_matches_jax_sharded(ranks):
    """On a data axis of several devices the workset fit plans the plain
    body (the JAX rule); the rounds and the centroids match the JAX
    package's workset fit on its 8-device mesh."""
    world, cases, out = ranks
    shards = dict((c[0], c[1]) for c in cases)["workset"]
    fit = _fit(out, "workset")
    assert fit["impl"] == "plain"
    init = JKM.select_random_centroids(shards[0], K, SEED)
    want, rounds = _jax_fit(SMALL, init, 30, workset=True)
    assert fit["rounds"] == rounds < 30
    assert fit["points_scored"][0] == N_SMALL
    np.testing.assert_allclose(fit["centroids"], want, **PLAIN_TOL)


@pytest.mark.parametrize("name", ["kernel_bf16", "kpp"])
def test_fit_matches_one_process_port(ranks, name):
    """bf16 stats and k-means++ seeding (rank 0's, broadcast) against the
    port's one-process fit of the concatenated rows from the same init."""
    world, cases, out = ranks
    shards, params = [(c[1], c[2]) for c in cases if c[0] == name][0]
    X = np.concatenate(shards)
    measure = TDistance.get_instance("euclidean")
    if name == "kpp":
        gen = torch.Generator().manual_seed(SEED)
        init = TKM.select_kmeanspp_centroids(torch.from_numpy(shards[0]), K,
                                             generator=gen)
        dtype = torch.float32
    else:
        init = torch.from_numpy(TKM.select_random_centroids(shards[0], K,
                                                            SEED))
        dtype = torch.bfloat16
    plan = TKM._fit_plan(len(X), D, K, measure)
    want = TKM.fit_centroids(
        torch.from_numpy(X), torch.ones(len(X)), init, plan,
        measure=measure, max_iter=params["max_iter"],
        compute_dtype=dtype).state.numpy()
    np.testing.assert_allclose(_fit(out, name)["centroids"], want,
                               **(FLIP_TOL if name == "kernel_bf16"
                                  else PLAIN_TOL))


def test_errors_raise_on_every_rank(ranks):
    world, _, out = ranks
    for o in out:
        assert o["fits"]["host0_small"]["error"] == (
            "multi-host KMeans selects initial centroids from host 0's "
            f"shard, which holds 3 rows < k={K}; give host 0 at least k "
            "rows")
        assert o["fits"]["unequal"]["error"] == (
            "multi-host KMeans requires equal padded row counts per "
            f"process; got {[1000 + r for r in range(world)]}")


def test_run_on_ranks_fails_a_hung_or_failed_rank():
    """A collective one rank never reaches fails the call at its deadline
    instead of hanging it; a rank that raises fails it with its
    traceback."""
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[0, 1\] of 2"):
        run_on_ranks(R.hang, 2, timeout_s=10)
    with pytest.raises(RuntimeError, match="rank one fails"):
        run_on_ranks(R.fail, 2, timeout_s=60)


def test_workset_plan_on_a_data_axis_of_several_devices():
    """Above the kernel threshold the workset fit plans the workset kernel
    on one device and the plain body on a data axis of several (the JAX
    package's rule, ``kmeans.py:544-556``); the BSP fit plans the kernel
    either way."""
    measure = TDistance.get_instance("euclidean")
    plan = TKM._fit_plan
    assert plan(N_BIG, D, K, measure, workset=True).impl == "kernel_ws"
    assert plan(N_BIG, D, K, measure, workset=True,
                data_devs=2).impl == "plain"
    assert plan(N_BIG, D, K, measure, data_devs=4).impl == "kernel"
