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
