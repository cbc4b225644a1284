"""The port's linear family over ranks (``flink_ml_tpu_torch``) against the
JAX package on the same seeded inputs: one step of the sharded ELL
updates (mixed and the values-aware sparse form) at 2 and 4 ranks against
the JAX package's on a 2- and 4-device mesh, the model-sharded mixed fit
on a 2x2 ``("data", "model")`` mesh, whole ``sgd_fit_mixed(mesh=)`` and
``sgd_fit_sparse(mesh=)`` fits (the fused and the pair kernels' grids), a
weighted fit whose shards carry unequal weight sums, a group of one rank
against the one-process fit, ``plan_mixed_impl``'s admissions, and the
streamed fit over ranks (dense and mixed) with a crash and resume.

The ranks are gloo CPU processes of one spawn (``tests/_torch_linear_ranks
.py``); a 2-rank job runs on ranks 0-1 of the 4.  The JAX package runs on
its virtual CPU devices (``tests/conftest.py``) with its ELL plan forced
(off a TPU it plans XLA) and its kernels' XLA twins.  Each JAX device's
rows are the rows the port's rank of that index takes at every step
(``_jax_rows``).

Tolerances (``tests/test_torch_linear_layouts.py``): weights within atol
1e-5, loss logs within atol 1e-6 (f32 summation order only: the ranks'
partial sums); a step's loss within rtol 1e-6.  A one-rank group and a
resumed stream are bit for bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from flink_ml_tpu.models.common import sgd as JS
from flink_ml_tpu.models.common.losses import LOSSES as JL
from flink_ml_tpu.ops.ell_scatter import ell_layout as j_ell_layout
from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES as TL
from flink_ml_tpu_torch.parallel.mesh import Mesh as TMesh
from flink_ml_tpu_torch.utils.backend import run_on_ranks

import _torch_linear_ranks as R

D = 128 * 128               # the fused kernel's grid (128 rows)
D_PAIR = 128 * 129          # a grid that does not tile into 8-row blocks
N_LOCAL = 480               # a rank's rows
LOCAL_BATCH = 120           # a rank's rows a step: 4 steps an epoch
FIT_CFG = dict(learning_rate=0.5, max_epochs=3, tol=0)
ATOL_W, ATOL_LOSS = 1e-5, 1e-6
SPAWN_TIMEOUT_S = 240


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return JMesh(np.asarray(jax.devices()[:n]).reshape(
        tuple(shape.values())), tuple(shape))


def _mixed_rows(n, d, seed, nd=13, nc=26):
    """Criteo-shaped rows: marker slot 0 in {16, 17} drives the label;
    slot 1 is index 777 in every row (a heavy hitter at 120 rows a step)
    and slot 2 crowds table row 5 (overflow)."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, nd)).astype(np.float32)
    cat = rng.integers(32, d, size=(n, nc)).astype(np.int32)
    y = rng.integers(0, 2, size=n).astype(np.float64)
    cat[:, 0] = np.where(y == 1, 16, 17)
    cat[:, 1] = 777
    cat[:, 2] = 128 * 5 + np.arange(n) % 3
    return {"dense": dense, "cat": cat, "y": y}


def _sparse_rows(n, d, seed, nnz=9):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, nnz)).astype(np.int32)
    idx[:, 0] = 777
    idx[:, 1] = 128 * 5 + np.arange(n) % 3
    vals = rng.normal(size=(n, nnz)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float64)
    y = np.where(vals[:, 2] > 0, 1.0, y)
    return {"idx": idx, "vals": vals, "y": y}


def _shards(world, make, d, seed, weights=None):
    shards = [make(N_LOCAL, d, seed + 10 * r) for r in range(world)]
    if weights is not None:
        for r, (lo, hi) in enumerate(weights):
            shards[r]["w"] = np.random.default_rng(seed + r).uniform(
                lo, hi, size=N_LOCAL)
    return shards


def _jax_rows(shards, batch):
    """The rows of one JAX fit on a P-device mesh that give device p the
    rows rank p takes at every step (rank p's local permutation of its
    own rows), so that the JAX package's global permutation lays them out
    so."""
    world = len(shards)
    b = batch // world
    steps = N_LOCAL // b
    local = [np.random.default_rng(0).permutation(N_LOCAL)
             for _ in range(world)]
    order = [(r, local[r][i * b:(i + 1) * b]) for i in range(steps)
             for r in range(world)]
    perm = np.random.default_rng(0).permutation(world * N_LOCAL)
    out = {}
    for key in shards[0]:
        cat = np.concatenate([shards[r][key][rows] for r, rows in order])
        arr = np.empty_like(cat)
        arr[perm] = cat
        out[key] = arr
    return out


def _step_job(world, layout, seed):
    """One step's inputs: each rank's 120 rows with 7 padding rows of
    weight 0, and random weights."""
    rng = np.random.default_rng(seed)
    make = _mixed_rows if layout == "mixed" else _sparse_rows
    rows = [make(LOCAL_BATCH, D, seed + r) for r in range(world)]
    wb = [np.ones(LOCAL_BATCH, np.float32) for _ in range(world)]
    wb[-1][-7:] = 0.0
    job = dict(kind="step", layout=layout, ranks=list(range(world)),
               shape={"data": world}, d=D, loss="logistic",
               config=dict(learning_rate=0.4, reg=0.02, elastic_net=0.3),
               params={"w": rng.normal(size=D).astype(np.float32) * 0.1,
                       "b": np.float32(0.1)},
               y=[r["y"].astype(np.float32) for r in rows], wb=wb)
    if layout == "mixed":
        job.update(dense=[r["dense"] for r in rows],
                   cat=[r["cat"] for r in rows])
    else:
        job.update(cat=[r["idx"] for r in rows],
                   vals=[r["vals"] for r in rows])
    return job


def _fit_job(world, layout, d, seed, weights=None, shape=None,
             shard_of=None, ranks=None):
    make = _mixed_rows if layout == "mixed" else _sparse_rows
    n_shards = world if shape is None else shape.get("data", world)
    job = dict(kind="fit", layout=layout, d=d,
               ranks=ranks or list(range(world)),
               shape=shape or {"data": world},
               config=dict(FIT_CFG, global_batch_size=LOCAL_BATCH * n_shards),
               rows=_shards(n_shards, make, d, seed, weights))
    if shard_of is not None:
        job["shard_of"] = shard_of
    return job


def _stream_batches(shards, keys, batch=LOCAL_BATCH):
    """Each rank's batches of its own rows, in order."""
    out = []
    for sh in shards:
        out.append([{k: sh[src][i:i + batch] for k, src in keys.items()}
                    for i in range(0, N_LOCAL, batch)])
    return out


def _stream_job(layout, seed, tmp):
    if layout == "mixed":
        shards = _shards(2, _mixed_rows, D, seed)
        keys = {"d": "dense", "c": "cat", "label": "y"}
        fit_keys = dict(dense_key="d", indices_key="c")
    else:
        rng = np.random.default_rng(seed)
        true_w = rng.normal(size=8)
        shards = []
        for _ in range(2):
            X = rng.normal(size=(N_LOCAL, 8)).astype(np.float32)
            shards.append({"X": X, "y": (X @ true_w > 0).astype(np.float32)})
        keys = {"features": "X", "label": "y"}
        fit_keys = {}
    return dict(kind="stream", ranks=[0, 1], shape={"data": 2},
                d=D if layout == "mixed" else 8,
                config=dict(learning_rate=0.4, max_epochs=2, tol=0),
                batches=_stream_batches(shards, keys), keys=fit_keys,
                crash_at=5, dir=str(tmp / f"ck_{layout}"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of 4 gloo ranks running every job of this file."""
    tmp = tmp_path_factory.mktemp("sharded")
    jobs = {
        "step_mixed_2": _step_job(2, "mixed", 1),
        "step_mixed_4": _step_job(4, "mixed", 2),
        "step_sparse_2": _step_job(2, "sparse", 3),
        "step_sparse_4": _step_job(4, "sparse", 4),
        "fit_mixed_2": _fit_job(2, "mixed", D, 5),
        "fit_mixed_4": _fit_job(4, "mixed", D, 6),
        "fit_mixed_pair_2": _fit_job(2, "mixed", D_PAIR, 7),
        "fit_sparse_2": _fit_job(2, "sparse", D, 8),
        "fit_weighted_2": _fit_job(2, "mixed", D, 9,
                                   weights=[(0.2, 0.5), (1.5, 3.0)]),
        "fit_model_2x2": _fit_job(4, "mixed", D, 10,
                                  shape={"data": 2, "model": 2},
                                  shard_of=[0, 0, 1, 1]),
        "fit_one_rank_mixed": _fit_job(1, "mixed", D, 11, ranks=[0]),
        "fit_one_rank_sparse": _fit_job(1, "sparse", D, 12, ranks=[0]),
        "stream_mixed": _stream_job("mixed", 13, tmp),
        "stream_dense": _stream_job("dense", 14, tmp),
    }
    out = run_on_ranks(R.linear_work, 4, 4, jobs, timeout_s=SPAWN_TIMEOUT_S)
    return jobs, out


def _same_on_ranks(out, name, keys=("w", "b")):
    got = [o[name] for o in out if name in o]
    for g in got[1:]:
        for k in keys:
            np.testing.assert_array_equal(g[k], got[0][k])
    return got[0]


# ------------------------------------------------------------ one step


def _jax_step(job):
    world = len(job["ranks"])
    cfg = JS.SGDConfig(**job["config"])
    cat = np.stack(job["cat"])
    if job["layout"] == "mixed":
        lay = j_ell_layout(cat, D, device=False)
        fields = ("src", "pos", "mask", "ovf_idx", "ovf_src", "heavy_idx",
                  "heavy_cnt")
        upd = JS._mixed_update_ell_sharded(JL[job["loss"]], cfg,
                                           _jmesh({"data": world}), D,
                                           backend="xla")
        lead = (jnp.asarray(np.concatenate(job["dense"])),)
    else:
        lay = j_ell_layout(cat, D, values=np.stack(job["vals"]),
                           device=False)
        fields = ("src", "pos", "mask", "val", "ovf_idx", "ovf_src",
                  "ovf_val", "heavy_idx", "heavy_cnt")
        upd = JS._sparse_update_ell_sharded(JL[job["loss"]], cfg,
                                            _jmesh({"data": world}), D,
                                            backend="xla")
        lead = ()
    params = {k: jnp.asarray(v) for k, v in job["params"].items()}
    return upd(params, *lead, *(jnp.asarray(getattr(lay, f))
                                for f in fields),
               jnp.asarray(np.concatenate(job["y"])),
               jnp.asarray(np.concatenate(job["wb"])))


@pytest.mark.parametrize("layout", ["mixed", "sparse"])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ell_step_matches_jax(ranks, layout, world):
    """One step of ``_mixed_update_ell_sharded`` /
    ``_sparse_update_ell_sharded`` (each rank its own layout, a zero delta
    summed in rank order) against the JAX package's on a mesh of as many
    devices: the same bits on every rank, within tolerance of JAX."""
    jobs, out = ranks
    name = f"step_{layout}_{world}"
    got = _same_on_ranks(out, name, ("w", "b", "loss"))
    want, want_loss = _jax_step(jobs[name])
    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(got["w"], np.asarray(want["w"]),
                               atol=ATOL_W)
    np.testing.assert_allclose(got["b"], float(want["b"]), atol=ATOL_W)


# ------------------------------------------------------------ whole fits


def _jax_fit(monkeypatch, job, world, impl="ell"):
    rows = _jax_rows(job["rows"], job["config"]["global_batch_size"])
    cfg = JS.SGDConfig(**job["config"])
    mesh = _jmesh(job["shape"] if "model" in job["shape"]
                  else {"data": world})
    if impl is not None:
        monkeypatch.setattr(JS, "plan_mixed_impl", lambda *a, **k: impl)
    if job["layout"] == "mixed":
        return JS.sgd_fit_mixed(JL["logistic"], rows["dense"], rows["cat"],
                                rows["y"], rows.get("w"), job["d"], cfg,
                                mesh=mesh)
    return JS.sgd_fit_sparse(JL["logistic"], rows["idx"], rows["vals"],
                             rows["y"], rows.get("w"), job["d"], cfg,
                             mesh=mesh)


def _assert_fit_close(got, want, want_log):
    np.testing.assert_allclose(got["w"], want.coefficients, atol=ATOL_W)
    np.testing.assert_allclose(got["b"], want.intercept, atol=ATOL_W)
    np.testing.assert_allclose(got["log"], want_log, atol=ATOL_LOSS)
    assert got["log"][-1] < got["log"][0]


@pytest.mark.parametrize("name,world", [
    ("fit_mixed_2", 2), ("fit_mixed_4", 4), ("fit_mixed_pair_2", 2),
    ("fit_sparse_2", 2)])
def test_sharded_fit_matches_jax(monkeypatch, ranks, name, world):
    """``sgd_fit_mixed(mesh=)`` / ``sgd_fit_sparse(mesh=)`` plan "ell" on
    a data mesh, each rank laying out its own rows, and agree with the
    JAX package's sharded ELL fit on a mesh of as many devices; the pair
    grid (129 rows) takes the pair kernel's path."""
    jobs, out = ranks
    got = _same_on_ranks(out, name, ("w", "b", "log"))
    assert got["impl"] == "ell"
    want, want_log = _jax_fit(monkeypatch, jobs[name], world)
    assert want.planned_impl == "ell"
    _assert_fit_close(got, want, want_log)


def test_unequal_shard_weights_normalize_globally(monkeypatch, ranks):
    """Rank 0's rows weigh 0.2-0.5, rank 1's 1.5-3.0: each rank's weighted
    mean is re-normalized by the global weight sum before ``r`` scales
    anything, so the 2-rank fit is the JAX package's (whose margins meet
    before the loss); a rank's own denominator would drift by a factor."""
    jobs, out = ranks
    got = _same_on_ranks(out, "fit_weighted_2", ("w", "b", "log"))
    want, want_log = _jax_fit(monkeypatch, jobs["fit_weighted_2"], 2)
    _assert_fit_close(got, want, want_log)
    # the sums really differ: the local normalization would be wrong
    sums = [r["w"].sum() for r in jobs["fit_weighted_2"]["rows"]]
    assert sums[1] > 4 * sums[0]


def test_model_sharded_fit_on_2x2_matches_jax(monkeypatch, ranks):
    """``_mixed_update_sharded``: each model rank owns half of ``w``; the
    ranks of a data shard pass the same rows; every rank returns the whole
    weight, and the fit is the JAX package's on a 2x2 device mesh."""
    jobs, out = ranks
    got = _same_on_ranks(out, "fit_model_2x2", ("w", "b", "log"))
    assert got["impl"] == "sharded"
    want, want_log = _jax_fit(monkeypatch, jobs["fit_model_2x2"], 4,
                              impl=None)
    assert want.planned_impl == "sharded"
    _assert_fit_close(got, want, want_log)


@pytest.mark.parametrize("layout", ["mixed", "sparse"])
def test_one_rank_group_is_the_one_process_fit(ranks, layout):
    """A group of one rank plans the one-process fit: bit for bit."""
    jobs, out = ranks
    job = jobs[f"fit_one_rank_{layout}"]
    got = out[0][f"fit_one_rank_{layout}"]
    rows, cfg = job["rows"][0], TS.SGDConfig(**job["config"])
    if layout == "mixed":
        want, log = TS.sgd_fit_mixed(TL["logistic"], rows["dense"],
                                     rows["cat"], rows["y"], None, D, cfg,
                                     device="cpu")
    else:
        want, log = TS.sgd_fit_sparse(TL["logistic"], rows["idx"],
                                      rows["vals"], rows["y"], None, D, cfg,
                                      device="cpu")
    np.testing.assert_array_equal(got["w"], want.coefficients)
    assert got["b"] == want.intercept and got["log"] == log
    assert got["impl"] == want.planned_impl == "ell"


def test_plan_mixed_impl_admissions():
    """The JAX package's admissions (``tests/test_ell_scatter.py``): a
    data mesh takes the sharded ELL route only when the caller allows it,
    a model-axis mesh never, and the layout budget is a rank's.  The port
    also asks ``allow_multiprocess`` (its ranks are processes)."""
    d = 1 << 20
    mesh8 = TMesh(object(), {"data": 8}, None)
    assert TS.plan_mixed_impl(d, 32, mesh=mesh8, allow_sharded=True,
                              allow_multiprocess=True) == "ell"
    assert TS.plan_mixed_impl(d, 32, mesh=mesh8,
                              allow_multiprocess=True) == "plain"
    assert TS.plan_mixed_impl(d, 32, mesh=mesh8,
                              allow_sharded=True) == "plain"
    mesh_mp = TMesh(object(), {"data": 4, "model": 2}, None)
    assert TS.plan_mixed_impl(d, 32, mesh=mesh_mp, allow_sharded=True,
                              allow_multiprocess=True) == "plain"
    hybrid = TMesh(object(), {"dcn": 2, "data": 4}, None)
    assert TS.plan_mixed_impl(d, 32, mesh=hybrid, allow_sharded=True,
                              allow_multiprocess=True) == "plain"
    assert TS.plan_mixed_impl(d, 1 << 15, mesh=mesh8, allow_sharded=True,
                              allow_multiprocess=True) == "plain"
    assert TS.plan_mixed_impl(d, 32, mesh=TMesh(None, {"data": 1}, None)) \
        == "ell"


# ------------------------------------------------------------ streams


def _jax_stream(monkeypatch, job):
    """The JAX package's one-process stream on a 2-device mesh over the
    ranks' batches joined in rank order."""
    monkeypatch.setattr(JS, "plan_mixed_impl", lambda *a, **k: "ell")
    per_rank = job["batches"]
    joined = [{k: np.concatenate([b[k] for b in step])
               for k in step[0]} for step in zip(*per_rank)]
    return JS.sgd_fit_outofcore(
        JL["logistic"], lambda: iter(joined), num_features=job["d"],
        config=JS.SGDConfig(**job["config"]), mesh=_jmesh({"data": 2}),
        cache_decoded=False, **job["keys"])


@pytest.mark.parametrize("layout", ["mixed", "dense"])
def test_streamed_fit_over_ranks_matches_jax_and_resumes(monkeypatch, ranks,
                                                         layout):
    """``sgd_fit_outofcore(mesh=)``: each rank streams its own batches (W
    is 1 on a mesh of several ranks), the mixed stream through the sharded
    ELL step; the fit agrees with the JAX package's one-process stream on
    a 2-device mesh, and a crash at a source pull in mid-epoch resumes
    from the newest chunk-boundary cut to the uninterrupted fit, bit for
    bit."""
    jobs, out = ranks
    name = f"stream_{layout}"
    got = _same_on_ranks(out, name, ("w", "b", "log"))
    assert got["W"] == 1
    assert got["impl"] == ("ell-stream" if layout == "mixed"
                           else "dense-stream")
    want, want_log = _jax_stream(monkeypatch, jobs[name])
    _assert_fit_close(got, want, want_log)
    res = got["resumed"]
    assert res["restarts"] == 1 and res["restored"] == 4
    np.testing.assert_array_equal(res["w"], got["w"])
    assert res["b"] == got["b"] and res["log"] == got["log"]
    for o in out[:2]:
        np.testing.assert_array_equal(o[name]["resumed"]["w"], res["w"])


def _one_rank_fit(rank, world, rows, cfg):
    from flink_ml_tpu_torch.parallel import distributed

    assert distributed.is_initialized() and (rank, world) == (0, 1)
    st, log = TS.sgd_fit_mixed(TL["logistic"], rows["dense"], rows["cat"],
                               rows["y"], None, D, TS.SGDConfig(**cfg),
                               device="cpu")
    return {"w": st.coefficients, "b": st.intercept, "log": log}


def test_group_of_one_in_this_process_is_the_one_process_fit():
    """``run_in_group_of_one``: the fit in a one-rank group of this
    process (no spawn) is the one-process fit bit for bit, and the group
    is left again."""
    from flink_ml_tpu_torch.parallel import distributed
    from flink_ml_tpu_torch.utils.backend import run_in_group_of_one

    rows = _mixed_rows(N_LOCAL, D, 15)
    cfg = dict(FIT_CFG, global_batch_size=LOCAL_BATCH)
    got = run_in_group_of_one(_one_rank_fit, rows, cfg)
    assert not distributed.is_initialized()
    want, log = TS.sgd_fit_mixed(TL["logistic"], rows["dense"], rows["cat"],
                                 rows["y"], None, D, TS.SGDConfig(**cfg),
                                 device="cpu")
    np.testing.assert_array_equal(got["w"], want.coefficients)
    assert got["b"] == want.intercept and got["log"] == log
