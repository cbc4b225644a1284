"""The port's Wide&Deep and streamed KMeans over ranks
(``flink_ml_tpu_torch``) against the JAX package on the same seeded
inputs:

- ``build_sharded_train_step`` on a 2x2 ``("data", "model")`` mesh of
  ranks, 3 steps, against the JAX package's one-device reference step and
  its sharded step on a 2x2 device mesh (``tests/test_widedeep.py:63-125``'s
  oracle), at the MLP (16, 8) (a replicated final layer) and (16, 8, 4) (a
  second column-parallel layer and a row-parallel final layer); the
  compressed step at top-k density 1 against the port's exact step
  (``tests/test_grad_reduce.py:497-560``'s inputs; the JAX package's
  compressed Wide&Deep step is no oracle on this tree, ROADMAP §C), and
  top-k 0.1 training with a live EF residual;
- ``WideDeep.fit`` over a group (routed through the fold, lazy, and the
  4-rank default mesh) against the JAX package's train ops on the global
  steps the ranks' layouts form;
- ``WideDeep.fit_outofcore(mesh=)`` against the JAX streamed fit on the
  ranks' batches joined in rank order;
- an elastic Wide&Deep fleet (``tests/test_faults.py:1567``'s data): the
  resized fit equals the port's fixed fleet of the new size restoring the
  same cut bit for bit, and is within tolerance of the JAX package's
  elastic fit;
- ``kmeans_fit_outofcore(mesh=)`` against the JAX fit on the joined stream,
  and readers of unequal length raising on every rank;
- a group of one rank against the one-process fits, bit for bit.

The ranks are gloo CPU processes of one spawn (``tests/_torch_wd_ranks.py``).
Tolerances: a step's loss ``rtol=1e-5, atol=1e-6`` and parameters
``rtol=1e-4, atol=1e-5`` (``assert_sharded_matches_reference``); fits
``tests/test_torch_widedeep.py``'s one-epoch tolerances (loss ``rtol=2e-5,
atol=1e-6``, parameters ``rtol=1e-3, atol=1e-3``); KMeans
``tests/test_torch_outofcore_models.py``'s ``KM_RTOL, KM_ATOL``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import flink_ml_tpu_torch as T
from flink_ml_tpu import robustness as JR
from flink_ml_tpu.iteration.checkpoint import CheckpointConfig as JCk
from flink_ml_tpu.models.clustering import kmeans as JKM
from flink_ml_tpu.models.common.sgd import (plan_epoch_layout,
                                            prepare_epoch_tensor)
from flink_ml_tpu.models.recommendation import widedeep as JWD
from flink_ml_tpu.ops.emb_grad import emb_grad_route as jax_route
from flink_ml_tpu.parallel.elastic import ElasticCoordinator as JCoord
from flink_ml_tpu.parallel.mesh import device_mesh
from flink_ml_tpu_torch.models.clustering import kmeans as TKM
from flink_ml_tpu_torch.models.recommendation import widedeep as TWD
from flink_ml_tpu_torch.parallel.mesh import local_mesh
from flink_ml_tpu_torch.utils.backend import run_on_ranks
from flink_ml_tpu_torch.utils.convert import (widedeep_params_to_jax,
                                              widedeep_shard_from_jax)

import _torch_wd_ranks as R

SPAWN_TIMEOUT_S = 240
VOCAB, D_DENSE, EMB = [16, 12], 3, 8
STEP_TOL = dict(loss=dict(rtol=1e-5, atol=1e-6),
                params=dict(rtol=1e-4, atol=1e-5))
FIT_LOSS_TOL, FIT_PARAM_TOL = dict(rtol=2e-5, atol=1e-6), dict(rtol=1e-3,
                                                               atol=1e-3)
KM_RTOL, KM_ATOL = 1e-5, 1e-6
FIT_LOCAL_ROWS, FIT_BATCH, FIT_EPOCHS = 256, 64, 2
STREAM_LOCAL_ROWS, STREAM_BATCH = 96, 32   # a rank's rows and batch
OFFS = np.asarray([0, VOCAB[0]], np.int32)


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return JMesh(np.asarray(jax.devices()[:n]).reshape(
        tuple(shape.values())), tuple(shape))


def _step_batches(seed, n, b=32):
    """``tests/test_grad_reduce.py:502-509``'s batch (ids offset)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dense = rng.normal(size=(b, D_DENSE)).astype(np.float32)
        cat = (np.stack([rng.integers(0, v, size=b) for v in VOCAB], 1)
               + OFFS).astype(np.int32)
        labels = rng.integers(0, 2, size=b).astype(np.float32)
        out.append((dense, cat, labels, np.ones(b, np.float32)))
    return out


def _rows(n, seed):
    """Clicks driven by field 0 and dense feature 0 (raw per-field ids)."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, D_DENSE)).astype(np.float32)
    cat = np.stack([rng.integers(0, v, size=n) for v in VOCAB],
                   1).astype(np.int32)
    logit = (cat[:, 0] - 7.5) * 0.6 + dense[:, 0] * 2.0
    label = (logit + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return {"denseFeatures": dense, "catFeatures": cat, "label": label}


def _wd_job(kind, ranks, shape, **kw):
    return dict(dict(kind=kind, ranks=list(ranks), shape=shape, vocab=VOCAB,
                     emb=EMB, hidden=(16, 8)), **kw)


def _fit_job(world, seed, shape="data", **kw):
    return _wd_job("fit", range(world), None if shape is None else
                   {"data": world}, epochs=FIT_EPOCHS, batch=FIT_BATCH,
                   rows=[_rows(FIT_LOCAL_ROWS, seed + r)
                         for r in range(world)], **kw)


def _stream_job(world, seed, **kw):
    parts = [_rows(STREAM_LOCAL_ROWS, seed + r) for r in range(world)]
    batches = [[{k: v[i:i + STREAM_BATCH] for k, v in p.items()}
                for i in range(0, STREAM_LOCAL_ROWS, STREAM_BATCH)]
               for p in parts]
    return _wd_job("stream", range(world), {"data": world}, epochs=2,
                   batches=batches, **kw)


def _km_job(world, rows, batches, seed, **kw):
    rng = np.random.default_rng(seed)
    parts = [[(rng.normal(size=(rows, 4)) + 3.0 * (b % 3)).astype(
        np.float32) for b in range(batches)] for _ in range(world)]
    return dict(kind="kmeans", ranks=list(range(world)),
                shape={"data": world}, k=3, iters=4, seed=2,
                batches=parts, **kw)


def _elastic_cols():
    """``tests/test_faults.py:1574-1581``'s rows."""
    rng = np.random.default_rng(11)
    n, d, vocab = 1440, 4, (7, 5, 3)
    dense = rng.normal(size=(n, d)).astype(np.float32)
    cat = np.stack([rng.integers(0, v, size=n) for v in vocab],
                   1).astype(np.int32)
    y = (rng.random(n) > 0.5).astype(np.float32)
    return {"denseFeatures": dense, "catFeatures": cat, "label": y}


def _elastic_job(tmp):
    return dict(dir=str(tmp / "elastic"), cols=_elastic_cols(),
                batch_rows=240, vocab=[7, 5, 3], emb=8, hidden=(64, 32),
                epochs=3, start=1, join_at=2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of 4 gloo ranks running every job of this file."""
    tmp = tmp_path_factory.mktemp("wd_ranks")
    mesh22 = {"data": 2, "model": 2}
    quad = range(4)
    jobs = {
        "step_2": _wd_job("step", quad, mesh22, d_dense=D_DENSE,
                          batches=_step_batches(1, 3)),
        "step_3": _wd_job("step", quad, mesh22, d_dense=D_DENSE,
                          batches=_step_batches(1, 3), hidden=(16, 8, 4)),
        "exact_same": _wd_job("step", quad, mesh22, d_dense=D_DENSE,
                              batches=_step_batches(0, 1) * 3),
        "topk_1": _wd_job("step", quad, mesh22, d_dense=D_DENSE,
                          batches=_step_batches(0, 1) * 3,
                          grad_reduce=dict(mode="topk", density=1.0)),
        "topk_01": _wd_job("step", quad, mesh22, d_dense=D_DENSE,
                           batches=_step_batches(1, 1) * 10,
                           grad_reduce=dict(mode="topk", density=0.1)),
        "fit_routed_2": _fit_job(2, 10),
        "fit_lazy_2": _fit_job(2, 20, params={"LAZY_EMB_OPT": True}),
        "fit_default_4": _fit_job(4, 30, shape=None),
        "fit_one_rank": _fit_job(1, 40),
        "stream_2": _stream_job(2, 50),
        "stream_lazy_2": _stream_job(2, 60, params={"LAZY_EMB_OPT": True}),
        "stream_one_rank": _stream_job(1, 70),
        "km_2": _km_job(2, 100, 3, 80, short=True),
        "km_kernel_2": dict(_km_job(2, 1 << 16, 1, 90), iters=2),
        "km_one_rank": _km_job(1, 100, 3, 95),
    }
    out = run_on_ranks(R.run_all, 4, 4, jobs, _elastic_job(tmp),
                       timeout_s=SPAWN_TIMEOUT_S)
    return jobs, out


def _same_on_ranks(out, name):
    got = [o[name] for o in out if name in o]
    for g in got[1:]:
        assert g["log" if "log" in g else "loss"] == \
            got[0]["log" if "log" in got[0] else "loss"]
        for a, b in zip(TWD.tree_leaves(g["params"]),
                        TWD.tree_leaves(got[0]["params"])):
            np.testing.assert_array_equal(a, b)
    return got[0]


def _assert_close(got_params, want_params, got_loss, want_loss, tol):
    np.testing.assert_allclose(got_loss, want_loss, **tol["loss"])
    want = jax.tree_util.tree_leaves(jax.device_get(want_params))
    got = TWD.tree_leaves(got_params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   **tol["params"])


# ------------------------------------------------------------ the dp x tp step


@pytest.mark.parametrize("name,hidden", [("step_2", (16, 8)),
                                         ("step_3", (16, 8, 4))])
def test_sharded_step_matches_jax_reference_and_sharded(ranks, name,
                                                        hidden):
    """The port's 2x2 step: every rank gathers the same tree (the model
    peers hold the same bits), and at each of 3 steps the loss and the
    parameters agree with the JAX package's one-device reference step and
    its sharded step on a 2x2 device mesh."""
    jobs, out = ranks
    for step in range(3):
        for r in range(1, 4):
            assert out[r][name]["loss"][step] == out[0][name]["loss"][step]
            for a, b in zip(TWD.tree_leaves(out[r][name]["params"][step]),
                            TWD.tree_leaves(out[0][name]["params"][step])):
                np.testing.assert_array_equal(a, b)
    got = out[0][name]
    ref_step, p1, s1 = JWD.build_reference_train_step(D_DENSE, VOCAB, EMB,
                                                      hidden)
    sh_step, ps, _, ss, shard = JWD.build_sharded_train_step(
        _jmesh({"data": 2, "model": 2}), D_DENSE, VOCAB, EMB, hidden)
    for step, batch in enumerate(jobs[name]["batches"]):
        p1, s1, l1 = ref_step(p1, s1, *batch)
        ps, ss, ls = sh_step(ps, ss, *shard(*batch))
        _assert_close(got["params"][step], p1, got["loss"][step], float(l1),
                      STEP_TOL)
        _assert_close(got["params"][step], ps, got["loss"][step], float(ls),
                      STEP_TOL)


def test_sharded_params_cross_both_ways():
    """``utils/convert.py``: a JAX tree split into the model ranks' shards
    by ``param_spec`` and gathered back is the same tree; the shards'
    shapes are the JAX package's per-device shards on a 2x2 mesh."""
    full = JWD.init_params(np.random.default_rng(0), D_DENSE, VOCAB, EMB,
                           (16, 8, 4))
    shards = [widedeep_shard_from_jax(full, m, 2, device="cpu")
              for m in range(2)]
    back = widedeep_params_to_jax(shards)
    for a, b in zip(TWD.tree_leaves(back), jax.tree_util.tree_leaves(full)):
        np.testing.assert_array_equal(a, b)
    _, ps, _, _, _ = JWD.build_sharded_train_step(
        _jmesh({"data": 2, "model": 2}), D_DENSE, VOCAB, EMB, (16, 8, 4))
    for a, b in zip(TWD.tree_leaves(shards[0]),
                    jax.tree_util.tree_leaves(ps)):
        assert tuple(a.shape) == b.addressable_shards[0].data.shape


def test_compressed_step_at_density_1_matches_exact(ranks):
    """Top-k at density 1 sends every entry: the compressed step (the
    dense tower gathered over ``model``, reduced whole over ``data``) is
    the exact step within the step tolerances, 3 steps on one batch."""
    _, out = ranks
    for r in range(4):
        e, c = out[r]["exact_same"], out[r]["topk_1"]
        for step in range(3):
            _assert_close(c["params"][step], e["params"][step],
                          c["loss"][step], e["loss"][step], STEP_TOL)


def test_compressed_topk_trains_with_live_error_feedback(ranks):
    _, out = ranks
    got = out[0]["topk_01"]
    assert got["loss"][-1] < got["loss"][0]
    assert got["ef_max"] > 0
    for r in range(1, 4):
        assert out[r]["topk_01"]["loss"] == got["loss"]


# ------------------------------------------------------------ WideDeep.fit


def _global_steps(parts, seed=0):
    """The global steps the ranks' layouts form: each rank lays its rows
    out with ``plan_epoch_layout(n, batch, ranks, seed)`` and its local
    batch; step i is the ranks' i-th local batches in rank order."""
    world = len(parts)
    n = len(parts[0]["label"])
    steps, batch, perm = plan_epoch_layout(n, FIT_BATCH, world, seed)
    local = batch // world
    steps = -(-n // local)
    cols = {}
    for key in ("denseFeatures", "catFeatures", "label"):
        per = [prepare_epoch_tensor(p[key], perm, steps, local)
               for p in parts]
        cols[key] = np.concatenate(per, axis=1)
    mask = np.concatenate([prepare_epoch_tensor(
        np.ones(n, np.float32), perm, steps, local)] * world, axis=1)
    return steps, cols, mask


def _jax_fit(job):
    steps, cols, mask = _global_steps(job["rows"])
    lazy = bool(job.get("params", {}).get("LAZY_EMB_OPT"))
    C = (cols["catFeatures"] + OFFS).astype(np.int32)
    route = None if lazy else jax_route(C, int(sum(VOCAB)), device=False,
                                        placement="auto")
    params = jax.tree_util.tree_map(jnp.asarray, JWD.init_params(
        np.random.default_rng(1), D_DENSE, VOCAB, EMB, (16, 8)))
    step, state = JWD._make_train_ops(params, 1e-2, lazy, route=route)
    step = jax.jit(step)
    log = []
    for _ in range(FIT_EPOCHS):
        losses = []
        for i in range(steps):
            extra = () if route is None else tuple(
                jnp.asarray(a[i]) for a in route.stacked_arrays())
            params, state, loss = step(
                params, state, cols["denseFeatures"][i], C[i],
                cols["label"][i].astype(np.float32), mask[i], *extra)
            losses.append(float(loss))
        log.append(float(np.mean(np.asarray(losses, np.float32))))
    return params, log


@pytest.mark.parametrize("name", ["fit_routed_2", "fit_lazy_2",
                                  "fit_default_4"])
def test_fit_over_ranks_matches_jax_on_the_global_steps(ranks, name):
    """``WideDeep.fit`` over 2 ranks (routed: B7's plain version folds the
    gathered rows of the global step on every rank; lazy: the fixed-order
    scatter and the global step's ids) and over the 4-rank default mesh:
    every rank returns the same model, within the fit tolerances of the
    JAX package's train ops on the global steps."""
    jobs, out = ranks
    got = _same_on_ranks(out, name)
    if name != "fit_lazy_2":
        assert got["route"]["fold_passes"] >= 1
        assert got["route"]["slots_per_step"] == FIT_BATCH * len(VOCAB)
    want, want_log = _jax_fit(jobs[name])
    np.testing.assert_allclose(got["log"], want_log, **FIT_LOSS_TOL)
    for a, b in zip(TWD.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(jax.device_get(want))):
        np.testing.assert_allclose(a, np.asarray(b), **FIT_PARAM_TOL)
    assert got["log"][-1] < got["log"][0]


def _est(job):
    est = (T.WideDeep(device="cpu").set_vocab_sizes(VOCAB)
           .set(T.WideDeep.EMBEDDING_DIM, EMB)
           .set(T.WideDeep.HIDDEN_UNITS, (16, 8))
           .set_max_iter(job["epochs"]).set_seed(0))
    if job.get("batch"):
        est.set_global_batch_size(job["batch"])
    return est


def _bits(got, model):
    assert got["log"] == list(model._loss_log)
    for a, b in zip(TWD.tree_leaves(got["params"]),
                    TWD.tree_leaves(model._params)):
        np.testing.assert_array_equal(a, b)


def test_one_rank_groups_are_the_one_process_fits(ranks):
    """A group of one rank runs the one-process code: ``fit``,
    ``fit_outofcore(mesh=)`` and ``kmeans_fit_outofcore(mesh=)`` bit for
    bit."""
    jobs, out = ranks
    job = jobs["fit_one_rank"]
    _bits(out[0]["fit_one_rank"], _est(job).fit(T.Table(job["rows"][0])))
    job = jobs["stream_one_rank"]
    _bits(out[0]["stream_one_rank"],
          _est(job).fit_outofcore(lambda: iter(job["batches"][0])))
    job = jobs["km_one_rank"]
    want = TKM.kmeans_fit_outofcore(
        lambda: iter({"features": b} for b in job["batches"][0]), 3,
        max_iter=4, seed=2, device="cpu")
    np.testing.assert_array_equal(out[0]["km_one_rank"]["centroids"], want)


# ------------------------------------------------------------ streams


@pytest.mark.parametrize("name", ["stream_2", "stream_lazy_2"])
def test_streamed_fit_over_ranks_matches_jax(ranks, name):
    """``WideDeep.fit_outofcore(mesh=)``: each rank streams its own
    batches; the fit agrees with the JAX package's streamed fit on a
    one-device mesh over the ranks' batches joined in rank order."""
    jobs, out = ranks
    got = _same_on_ranks(out, name)
    job = jobs[name]
    joined = [{k: np.concatenate([b[k] for b in step]) for k in step[0]}
              for step in zip(*job["batches"])]
    est = (JWD.WideDeep().set_vocab_sizes(VOCAB)
           .set(JWD.WideDeep.EMBEDDING_DIM, EMB)
           .set(JWD.WideDeep.HIDDEN_UNITS, (16, 8)).set_max_iter(2)
           .set_seed(0))
    if job.get("params"):
        est.set(JWD.WideDeep.LAZY_EMB_OPT, True)
    want = est.fit_outofcore(lambda: iter(joined),
                             mesh=device_mesh({"data": 1},
                                              devices=jax.devices()[:1]))
    np.testing.assert_allclose(got["log"], want._loss_log, **FIT_LOSS_TOL)
    for a, b in zip(TWD.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want._params)):
        np.testing.assert_allclose(a, np.asarray(b), **FIT_PARAM_TOL)


def test_elastic_resize_equals_fixed_fleet_and_jax(ranks, tmp_path):
    """The second elastic adopter over 4 ranks, 2 a worker: from 1 worker,
    a join at chunk boundary 2 resizes the fleet to 2 (params and Adam
    state replicated: a placement-only restore); the resized fit equals
    the fixed fleet of 2 restoring the same cut bit for bit on every
    rank, and agrees with the JAX package's elastic fit on the same
    schedule within the fit tolerances."""
    _, out = ranks
    for r in range(4):
        e = out[r]["elastic"]
        assert e["resizes"] == 1 and e["fleet"] == 2 and e["restored"] == 6
        _bits(e["fixed"], type("M", (), {"_loss_log": e["elastic"]["log"],
                                         "_params": e["elastic"]["params"]}))
        _bits(e["elastic"], type("M", (), {
            "_loss_log": out[0]["elastic"]["elastic"]["log"],
            "_params": out[0]["elastic"]["elastic"]["params"]}))
    cols = _elastic_cols()

    def reader():
        for i in range(0, 1440, 240):
            yield {k: v[i:i + 240] for k, v in cols.items()}

    est = JWD.WideDeep().set_vocab_sizes([7, 5, 3]).set_max_iter(3)

    def fit(**kw):
        return est.fit_outofcore(lambda: reader(), steps_per_dispatch=2,
                                 checkpoint_every_steps=2, **kw)

    coord = JCoord(chips_per_worker=2, initial_workers=1)
    plan = JR.FaultPlan().inject(coord.SCOPE, at=2, kind="join")
    rep = JR.RecoveryReport()
    with plan:
        want = JR.resilient_fit(
            fit, checkpoint=JCk(str(tmp_path / "ck"), max_to_keep=99),
            elastic=coord, report=rep,
            backoff=JR.RetryPolicy(base_delay=0.0, sleep=lambda s: None))
    assert rep.resizes == 1
    got = out[0]["elastic"]["elastic"]
    np.testing.assert_allclose(got["log"], want._loss_log, **FIT_LOSS_TOL)
    for a, b in zip(TWD.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want._params)):
        np.testing.assert_allclose(a, np.asarray(b), **FIT_PARAM_TOL)


# ------------------------------------------------------------ KMeans


@pytest.mark.parametrize("name,impl", [("km_2", "plain"),
                                       ("km_kernel_2", "kernel")])
def test_streamed_kmeans_over_ranks_matches_jax(ranks, name, impl):
    """``kmeans_fit_outofcore(mesh=)``: each rank streams its own batches
    (the stats planned at the rank's batch rows: the plain body at 100
    rows, the stats kernel's plain version at 65536 through
    ``update_stats_sharded``); the same centroids on every rank, within
    ``KM_RTOL``/``KM_ATOL`` of the JAX fit on the joined stream (the init
    is the global first batch's draw)."""
    jobs, out = ranks
    got = out[0][name]
    assert got["impl"] == impl
    np.testing.assert_array_equal(out[1][name]["centroids"],
                                  got["centroids"])
    job = jobs[name]
    joined = [np.concatenate(step) for step in zip(*job["batches"])]
    want = JKM.kmeans_fit_outofcore(
        lambda: iter({"features": b} for b in joined), 3,
        max_iter=job["iters"], seed=2,
        mesh=device_mesh({"data": 1}, devices=jax.devices()[:1]))
    np.testing.assert_allclose(got["centroids"], want, rtol=KM_RTOL,
                               atol=KM_ATOL)


def test_streamed_kmeans_unequal_readers_raise_on_every_rank(ranks):
    """Rank 1's reader ends one batch early: every rank raises (the
    per-batch flag all-reduce), none hangs."""
    _, out = ranks
    for r in range(2):
        assert "different batch counts" in out[r]["km_2"]["short"]


def test_sharded_step_needs_a_model_axis():
    """The dp x tp step refuses a mesh without ``"model"``, and a
    ``grad_reduce`` that would reduce over the shards' axis."""
    from flink_ml_tpu_torch.parallel.grad_reduce import GradReduceConfig
    from flink_ml_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="'model'"):
        TWD.build_sharded_train_step(local_mesh(), 4, [4], 2, (2,))
    mesh = Mesh(None, {"data": 1, "model": 1}, torch.device("cpu"))
    with pytest.raises(ValueError, match="data axes"):
        TWD.build_sharded_train_step(
            mesh, 4, [4], 2, (2,), grad_reduce=GradReduceConfig(
                mode="topk", axis=("data", "model"),
                wire_protocol="allgather"))
