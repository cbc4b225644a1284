"""Work that ``tests/test_torch_widedeep_ranks.py`` runs on each rank of a
gloo process group (``flink_ml_tpu_torch.utils.backend.run_on_ranks``).  A
module of its own, importing neither JAX nor the JAX package, so that the
spawned ranks start fast; the test compares what the ranks return with the
JAX package.

A job names the ranks it runs on (``ranks``, ascending) and its mesh's axes
(``shape``, None for the default mesh of the whole world); every rank makes
every job's mesh first, in job order (group creation is collective over the
world), then runs the jobs it is a rank of."""

import os
import shutil

from flink_ml_tpu_torch import Table, WideDeep
from flink_ml_tpu_torch.models.clustering import kmeans as KM
from flink_ml_tpu_torch.models.recommendation import widedeep as W
from flink_ml_tpu_torch.parallel import distributed as D
from flink_ml_tpu_torch.parallel.grad_reduce import GradReduceConfig
from flink_ml_tpu_torch.parallel.mesh import fleet_mesh


def _wd(job):
    est = (WideDeep(device="cpu").set_vocab_sizes(list(job["vocab"]))
           .set(WideDeep.EMBEDDING_DIM, job["emb"])
           .set(WideDeep.HIDDEN_UNITS, tuple(job["hidden"]))
           .set_max_iter(job["epochs"]).set_seed(job.get("seed", 0)))
    if job.get("batch"):
        est.set_global_batch_size(job["batch"])
    for key, value in job.get("params", {}).items():
        est.set(getattr(WideDeep, key), value)
    return est


def _model(model):
    return {"params": model._params, "log": list(model._loss_log)}


def step_job(pos, mesh, job):
    """``build_sharded_train_step`` over ``job["batches"]`` (global host
    batches, ids offset): each step's loss and the gathered full tree;
    with ``job["grad_reduce"]`` the compressed step and the largest
    |EF| entry at the end."""
    gr = job.get("grad_reduce")
    built = W.build_sharded_train_step(
        mesh, job["d_dense"], job["vocab"], job["emb"], tuple(job["hidden"]),
        grad_reduce=None if gr is None else GradReduceConfig(**gr))
    step, params, _, state, shard = built[:5]
    gr_state = built[5] if gr is not None else None
    out = {"loss": [], "params": []}
    for batch in job["batches"]:
        rows = shard(*batch)
        if gr is None:
            params, state, loss = step(params, state, *rows)
        else:
            params, state, gr_state, loss = step(params, state, gr_state,
                                                 *rows)
        out["loss"].append(float(loss))
        out["params"].append(W.gather_sharded_params(params, mesh))
    if gr_state is not None and "ef" in gr_state:
        out["ef_max"] = max(float(x.abs().max()) for x in
                            W.tree_leaves(gr_state["ef"]))
    return out


def fit_job(pos, mesh, job):
    """``WideDeep.fit`` of this rank's rows (``job["rows"][pos]``) on the
    job's mesh (the default mesh where the job names none)."""
    est = _wd(job)
    model = est.fit(Table(job["rows"][pos]), mesh=mesh)
    return {**_model(model), "route": est.route_info}


def stream_job(pos, mesh, job):
    """``WideDeep.fit_outofcore(mesh=)`` over this rank's own batches."""
    batches = job["batches"][pos]
    model = _wd(job).fit_outofcore(lambda: iter(batches), mesh=mesh)
    return _model(model)


def kmeans_job(pos, mesh, job):
    """``kmeans_fit_outofcore(mesh=)`` over this rank's own batches, and
    with ``job["short"]`` again with this rank's last batch dropped on
    rank 1 (the error every rank raises)."""
    batches = job["batches"][pos]
    info = {}
    got = KM.kmeans_fit_outofcore(
        lambda: iter({"features": b} for b in batches), job["k"],
        max_iter=job["iters"], seed=job["seed"], mesh=mesh, device="cpu",
        info=info, init=job.get("init"))
    out = {"centroids": got, "impl": info["impl"]}
    if job.get("short"):
        mine = batches[:-1] if pos == 1 else batches
        try:
            KM.kmeans_fit_outofcore(
                lambda: iter({"features": b} for b in mine), job["k"],
                max_iter=1, mesh=mesh, device="cpu")
            out["short"] = None
        except ValueError as exc:
            out["short"] = str(exc)
    return out


RUN = {"step": step_job, "fit": fit_job, "stream": stream_job,
       "kmeans": kmeans_job}


def _key(job):
    return (tuple(job["ranks"]), tuple((job["shape"] or {}).items()))


def wd_work(rank, world, jobs):
    """Every job of ``jobs`` (a dict, run in order) that this rank is a
    rank of; its meshes made first on every rank."""
    meshes = {}
    for job in jobs.values():
        if job["shape"] is not None and _key(job) not in meshes:
            meshes[_key(job)] = fleet_mesh(job["ranks"], job["shape"])
    out = {}
    for name, job in jobs.items():
        if rank not in job["ranks"]:
            continue
        mesh = meshes.get(_key(job))
        out[name] = RUN[job["kind"]](job["ranks"].index(rank), mesh, job)
    D.barrier()
    return out


# ---------------------------------------------------------------- elastic


def _coord(workers, chips=2):
    from flink_ml_tpu_torch.parallel.elastic import ElasticCoordinator

    return ElasticCoordinator(chips_per_worker=chips,
                              initial_workers=workers)


def elastic_job(rank, world, job):
    """``tests/test_faults.py::test_widedeep_elastic_resize_bitexact_vs_
    fixed_fleet`` on this world of ranks (2 a worker): the supervised
    elastic fit from ``job["start"]`` workers with a join at boundary
    ``job["join_at"]``; the donor fleet of the start size writing its cuts;
    and the fleet of the new size restoring the cut the resize restored
    from."""
    from flink_ml_tpu_torch.iteration.checkpoint import (
        CheckpointConfig,
        CheckpointManager,
    )
    from flink_ml_tpu_torch.robustness import (
        FaultPlan,
        RecoveryReport,
        RetryPolicy,
        resilient_fit,
    )

    root, cols, batch = job["dir"], job["cols"], job["batch_rows"]
    n = len(cols["label"])

    def reader():
        for i in range(0, n, batch):
            yield {k: v[i:i + batch] for k, v in cols.items()}

    est = _wd(job)

    def fit(**kw):
        return est.fit_outofcore(lambda: reader(), steps_per_dispatch=2,
                                 checkpoint_every_steps=2, **kw)

    nobackoff = RetryPolicy(base_delay=0.0, sleep=lambda s: None)
    coord = _coord(job["start"])
    plan = FaultPlan().inject(coord.SCOPE, at=job["join_at"], kind="join")
    rep = RecoveryReport()
    manager = CheckpointManager(CheckpointConfig(os.path.join(root, "e"),
                                                 max_to_keep=99))
    with plan:
        model_e = resilient_fit(fit, checkpoint=manager, elastic=coord,
                                backoff=nobackoff, report=rep)
    out = {"elastic": _model(model_e), "resizes": rep.resizes,
           "fleet": coord.fleet_size, "restored": manager.last_restored_step}
    donor = _coord(job["start"])
    resilient_fit(fit, checkpoint=CheckpointConfig(os.path.join(root, "a"),
                                                   max_to_keep=99),
                  elastic=donor, backoff=nobackoff)
    if rank == 0:
        name = f"ckpt-{out['restored']:08d}"
        os.makedirs(os.path.join(root, "b"))
        shutil.copytree(os.path.join(root, "a", name),
                        os.path.join(root, "b", name))
    D.barrier()
    fixed = _coord(job["start"] + 1)
    model_b = resilient_fit(
        fit, checkpoint=CheckpointManager(CheckpointConfig(
            os.path.join(root, "b"), max_to_keep=99)),
        elastic=fixed, resume=True, backoff=nobackoff)
    out["fixed"] = _model(model_b)
    D.barrier()
    return out


def run_all(rank, world, jobs, elastic):
    """The mesh jobs, then the elastic job on the whole world."""
    out = wd_work(rank, world, jobs)
    out["elastic"] = elastic_job(rank, world, elastic)
    return out
