"""Work that ``tests/test_torch_parallel.py`` runs on each rank of a gloo
process group (``flink_ml_tpu_torch.utils.backend.run_on_ranks``).  A
module of its own, importing neither JAX nor the JAX package, so that the
spawned ranks start fast; the test compares what they return."""

import time

import numpy as np
import torch

import flink_ml_tpu_torch as T
from flink_ml_tpu_torch.data.broadcast import with_broadcast
from flink_ml_tpu_torch.parallel import collectives as C
from flink_ml_tpu_torch.parallel import distributed as D
from flink_ml_tpu_torch.parallel import mesh as M


def rank_value(rank, shape=(4, 6)):
    """Rank ``rank``'s input to the collectives (the test rebuilds it)."""
    return np.random.default_rng(100 + rank).normal(size=shape).astype(
        np.float32)


def collectives(rank, world):
    x = torch.from_numpy(rank_value(rank))
    mesh = M.default_mesh()
    out = {
        "mesh": (mesh.shape, M.mesh_process_count(mesh),
                 M.axis_process_count(mesh),
                 M.local_axis_multiple(mesh, "data", 8),
                 M.local_device_count()),
        "psum": C.psum(x), "pmean": C.pmean(x), "pmax": C.pmax(x),
        "tree": C.psum({"a": x, "b": [x[0], x[1:]]}),
        "packed": C.psum_packed((x, torch.arange(3) + rank)),
        "gather": C.all_gather(x), "stack": C.all_gather(x, tiled=False),
        "scatter": C.reduce_scatter(torch.cat([x] * world)),
        "scatter1": C.reduce_scatter(torch.cat([x] * world, dim=1),
                                     scatter_dimension=1),
        "ring1": C.ppermute_ring(x), "ring2": C.ppermute_ring(x, shift=2),
        "index": C.axis_index(), "size": C.axis_size(),
        "allgather": D.process_allgather(np.asarray([rank, 10 * rank])),
        "bcast_np": D.broadcast_from_host0(np.full((2, 3), float(rank))),
        "bcast_t": D.broadcast_from_host0({"t": x + rank}),
        "info": D.process_info(),
        "device": str(D.rank_device()),
        "shard": M.fetch_replicated(M.shard_batch(
            {"rows": np.arange(5 * (rank + 1))[:5]}, pad=True)),
        "global": D.global_to_host_local(D.host_local_to_global(
            np.arange(3) + rank)),
        "bcast_var": with_broadcast(
            lambda v, ctx: ctx.get_broadcast_variable("t")["c"] + v,
            {"t": T.Table({"c": np.arange(3.0)})}, torch.tensor(1.0)),
    }
    D.barrier()
    try:
        M.shard_batch(np.zeros((3 + rank, 2)), pad=False)
    except ValueError as exc:
        out["unequal_shard"] = str(exc)
    return out


def fits(rank, world, cases):
    """``KMeans(device="cpu").fit`` of rank ``rank``'s shard for each case
    ``(name, shards, params, compute_dtype)``: the centroids, plan and
    workset report, or the error message."""
    out = {}
    for name, shards, params, dtype in cases:
        est = T.KMeans(device="cpu", compute_dtype=getattr(torch, dtype))
        for key, value in params.items():
            getattr(est, f"set_{key}")(value)
        try:
            model = est.fit(T.Table({"features": shards[rank]}))
        except ValueError as exc:
            out[name] = {"error": str(exc)}
            continue
        rep = est.last_workset_report
        out[name] = {"centroids": model.get_model_data()[0]["centroids"][0],
                     "impl": est.planned_impl,
                     "rounds": None if rep is None else rep["rounds"],
                     "points_scored": None if rep is None
                     else rep["points_scored"]}
    return out


def work(rank, world, cases):
    return {"coll": collectives(rank, world),
            "fits": fits(rank, world, cases)}


def hang(rank):
    """Rank 0 enters an all-reduce that rank 1 never reaches."""
    if rank == 0:
        C.psum(torch.ones(2))
    else:
        time.sleep(60)
    return rank


def fail(rank):
    if rank == 1:
        raise ArithmeticError("rank one fails")
    return rank


def _tree(arrays, rank):
    """Rank ``rank``'s row of each participant-stacked array."""
    return {k: torch.from_numpy(np.array(v[rank])) for k, v in arrays.items()}


def _fed_draws(draws, rank):
    """A ``draw_uniform`` that returns the JAX package's draws for this
    rank: ``draws[(step, unit)]`` stacked over ranks."""
    def draw(key, unit, shape, device):
        u = draws[(int(key[2]), int(unit))][rank]
        return torch.from_numpy(np.array(u)).reshape(shape)

    return draw


def reduce_job(rank, job):
    """``job["steps"]`` reduces of this rank's rows of the stacked
    gradients under ``job["config"]`` on a mesh of ``job["shape"]``, from
    a fresh state or the JAX package's stacked ``job["state"]``; each
    step's reduced tree and state, and the rounds staged."""
    from flink_ml_tpu_torch.parallel import grad_reduce as GR
    from flink_ml_tpu_torch.utils.convert import grad_reduce_state_from_jax

    cfg = job["config"]
    mesh = M.device_mesh(job["shape"])
    grads = job["grads"]
    if job.get("state") is not None:
        state = grad_reduce_state_from_jax(job["state"], rank, cfg,
                                           device="cpu")
    else:
        state = GR.init_state(cfg, _tree(grads[0], rank), mesh)
    draw = GR.draw_uniform
    if job.get("draws") is not None:
        GR.draw_uniform = _fed_draws(job["draws"], rank)
    reader = GR.RungReader(cfg) if cfg.adaptive else None
    steps = []
    t0 = time.perf_counter()
    try:
        for g in grads:
            rungs = reader.rungs(state) if reader is not None else None
            if job.get("pipelined"):
                red, state = GR.pipelined_reduce(_tree(g, rank), state, cfg,
                                                 mesh=mesh, rungs=rungs)
            else:
                red, state = GR.reduce_gradients(_tree(g, rank), state, cfg,
                                                 mesh=mesh, rungs=rungs)
            steps.append({"red": red, "state": dict(state)})
    finally:
        GR.draw_uniform = draw
    out = {"steps": steps, "seconds": time.perf_counter() - t0,
           "rung_reads": None if reader is None else reader.reads}
    if job.get("pipelined"):
        out["drain"] = GR.drain_pending(state, cfg, mesh=mesh)
    return out


def fit_job(rank, job):
    """``sgd_fit_params`` of this rank's rows on a mesh of
    ``job["shape"]`` (the default mesh without one)."""
    from flink_ml_tpu_torch.models.common import sgd as S

    mesh = M.device_mesh(job["shape"]) if job.get("shape") else None
    t0 = time.perf_counter()
    params, log = S.sgd_fit_params(
        job["loss"], job["X"][rank], job["y"][rank], None,
        S.SGDConfig(**job["config"]), "cpu", mesh=mesh,
        init_params=job["init"])
    return {"params": params, "log": log,
            "seconds": time.perf_counter() - t0}


def grad_reduce_work(rank, world, jobs):
    """Each job of ``tests/test_torch_grad_reduce.py`` on this rank."""
    run = {"reduce": reduce_job, "fit": fit_job, "mesh": mesh_job}
    return {name: run[job["kind"]](rank, job) for name, job in jobs.items()}


def mesh_job(rank, job):
    """The dcn x data mesh's facts and its axis collectives on this
    rank's value, and ``hybrid_mesh``'s layout (or its error)."""
    from flink_ml_tpu_torch.parallel import collectives as C2

    x = torch.from_numpy(rank_value(rank, (3,)))
    out = {}
    try:
        mesh = D.hybrid_mesh({"data": 2})
    except ValueError as exc:
        return {"error": str(exc)}
    out["shape"] = mesh.shape
    out["size"] = mesh.size
    for name, axis in (("data", "data"), ("dcn", "dcn"),
                       ("both", ("dcn", "data"))):
        out[name] = {
            "index": C2.axis_index(axis, mesh=mesh),
            "size": C2.axis_size(axis, mesh=mesh),
            "psum": C2.psum(x, axis, mesh=mesh),
            "ordered": C2.psum_ordered(x, axis, mesh=mesh),
            "gather": C2.all_gather(x, axis, mesh=mesh, tiled=False),
            "swap": (C2.ppermute(x, axis, [(0, 1), (1, 0)], mesh=mesh)
                     if C2.axis_size(axis, mesh=mesh) > 1 else None),
        }
    lane = mesh.lane()
    out["lane_psum"] = C2.psum(x, ("dcn", "data"), mesh=lane)
    out["same_lane"] = mesh.lane().group is lane.group
    out["cached"] = M.device_mesh(mesh.shape).axis_group(
        "data") is mesh.axis_group("data")
    return out
