"""Work that ``tests/test_torch_parallel_families.py`` runs on each rank of
a gloo process group (``flink_ml_tpu_torch.utils.backend.run_on_ranks``).
A module of its own, importing neither JAX nor the JAX package, so that the
spawned ranks start fast; the test compares what they return with numpy
and the JAX package.

A job names the ranks it runs on (``ranks``, ascending) and its mesh's axes
(``shape``); every rank makes every job's mesh first, in job order (group
creation is collective over the world), then runs the jobs it is a rank
of, with its position on the job's mesh."""

import numpy as np
import torch

from flink_ml_tpu_torch.parallel import collectives as C
from flink_ml_tpu_torch.parallel import distributed as D
from flink_ml_tpu_torch.parallel.mesh import fleet_mesh
from flink_ml_tpu_torch.parallel.moe import moe_apply, shard_moe
from flink_ml_tpu_torch.parallel.pipeline_parallel import build_pipeline
from flink_ml_tpu_torch.parallel.ring_attention import ring_attention
from flink_ml_tpu_torch.parallel.ulysses import ulysses_attention
from flink_ml_tpu_torch.utils.convert import moe_params_from_jax


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_(True) if grad else t


def _coords(pos, shape):
    """This rank's coordinate on each axis of ``shape`` (mesh order)."""
    return dict(zip(shape, np.unravel_index(pos, tuple(shape.values()))))


def collectives_job(pos, mesh, job):
    """The all-to-all forms and the ring permute on rank ``pos``'s tensor
    ``job["x"][pos]``, each with the gradient of ``sum(w * out)`` for the
    rank's weights ``job["w"][name][pos]``."""
    out = {}
    for name, kind, kw in job["cases"]:
        x = _t(job["x"][pos], grad=True)
        if kind == "a2a":
            y = C.all_to_all(x, "data", mesh=mesh, **kw)
        else:
            y = C.ppermute_ring(x, "data", mesh=mesh, **kw)
        torch.sum(_t(job["w"][name][pos]) * y).backward()
        out[name] = {"y": y.detach(), "grad": x.grad}
    return out


def _blocks(arrs, pos, n):
    return [_t(a[:, pos * (a.shape[1] // n):(pos + 1) * (a.shape[1] // n)])
            for a in arrs]


def ring_job(pos, mesh, job):
    """``ring_attention`` of rank ``pos``'s sequence block, causal and not;
    and the gradient of ``sum(out * g)`` for Q, K and V's blocks."""
    n = mesh.shape["seq"]
    out = {}
    for causal in (False, True):
        q, k, v = (t.requires_grad_(True)
                   for t in _blocks(job["qkv"], pos, n))
        o = ring_attention(q, k, v, mesh=mesh, axis="seq", causal=causal)
        (g,) = _blocks([job["g"]], pos, n)
        torch.sum(o * g).backward()
        out[causal] = {"out": o.detach(), "dq": q.grad, "dk": k.grad,
                       "dv": v.grad}
    return out


def ulysses_job(pos, mesh, job):
    """``ulysses_attention`` on ``{"seq": 4, "data": 2}``: each data rank
    holds one batch row, each seq rank its sequence block."""
    at = _coords(pos, job["shape"])
    n = mesh.shape["seq"]
    rows = [a[at["data"]:at["data"] + 1] for a in job["qkv"]]
    out = {}
    for causal in (False, True):
        out[causal] = ulysses_attention(*_blocks(rows, at["seq"], n),
                                        mesh=mesh, axis="seq",
                                        causal=causal)
    return out


def _stage(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def pipeline_job(pos, mesh, job):
    """``build_pipeline`` forward and the gradient of the mean squared
    error against ``job["y"]``: without a data axis every rank holds the
    whole batch; with one, its contiguous rows and its part of the sum."""
    w, b = (_t(a, grad=True) for a in job["params"])
    x, y = job["x"], job["y"]
    if job.get("data_axis"):
        at = _coords(pos, job["shape"])
        rows = slice(at["data"] * (len(x) // 2),
                     (at["data"] + 1) * (len(x) // 2))
        x, y = x[rows], y[rows]
    fn = build_pipeline(_stage, mesh, n_micro=job["n_micro"],
                        data_axis=job.get("data_axis"))
    o = fn((w, b), _t(x))
    loss = torch.sum((o - _t(y)) ** 2) / job["y"].size
    loss.backward()
    stage = _coords(pos, job["shape"])["pipe"]
    return {"out": o.detach(), "dw": w.grad[stage], "db": b.grad[stage],
            "dw_other": float(w.grad.abs().sum() - w.grad[stage].abs().sum())}


def moe_job(pos, mesh, job):
    """``moe_apply`` of this rank's tokens (its data row's share) on
    ``{"data": 2, "expert": 4}``, for each case ``(name, kwargs, shard,
    bf16)``: with ``shard`` the rank's expert slice of the parameters, else
    the full parameters; with ``bf16`` the tokens in bf16."""
    at = _coords(pos, job["shape"])
    x = job["x"]
    n = len(x) // job["shape"]["data"]
    mine = _t(x[at["data"] * n:(at["data"] + 1) * n])
    full = moe_params_from_jax(job["params"], device="cpu")
    out = {}
    for name, kw, shard, bf16 in job["cases"]:
        params = shard_moe(full, mesh) if shard else full
        xi = mine.to(torch.bfloat16) if bf16 else mine
        y = moe_apply(params, xi, mesh=mesh, data_axis="data", **kw)
        out[name] = {"dtype": str(y.dtype), "y": y.float()}
    return out


def errors_job(pos, mesh, job):
    """The ValueErrors every rank raises: ring attention on a sequence
    that does not divide over the ring (blocks of unequal length), and
    Ulysses on it; Ulysses with fewer heads than ranks; a pipeline on a
    mesh without a ``"pipe"`` axis."""
    out = {}
    q = _t(np.zeros((1, job["ragged"][pos], 4, 4), np.float32))
    for name, call in (
            ("ring_ragged", lambda: ring_attention(q, q, q, mesh=mesh,
                                                   axis="seq")),
            ("ulysses_ragged", lambda: ulysses_attention(
                q, q, q, mesh=mesh, axis="seq")),
            ("ulysses_heads", lambda: ulysses_attention(
                *[_t(np.zeros((1, 4, 2, 4), np.float32))] * 3, mesh=mesh,
                axis="seq")),
            ("pipe_axis", lambda: build_pipeline(_stage, mesh, n_micro=2))):
        try:
            call()
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


def pipeline_errors_job(pos, mesh, job):
    """The pipeline's batch and stage-count ValueErrors."""
    out = {}
    w4, b4 = (_t(a) for a in job["params"])
    for name, call in (
            ("n_micro", lambda: build_pipeline(_stage, mesh, n_micro=3)(
                (w4, b4), _t(np.zeros((16, 8), np.float32)))),
            ("leading", lambda: build_pipeline(_stage, mesh, n_micro=4)(
                (w4[:3], b4[:3]), _t(np.zeros((8, 8), np.float32))))):
        try:
            call()
            out[name] = None
        except ValueError as exc:
            out[name] = str(exc)
    return out


RUN = {"collectives": collectives_job, "ring": ring_job,
       "ulysses": ulysses_job, "pipeline": pipeline_job, "moe": moe_job,
       "errors": errors_job, "pipeline_errors": pipeline_errors_job}


def _key(job):
    return (tuple(job["ranks"]), tuple(job["shape"].items()))


def families(rank, world, jobs):
    """Every job of ``jobs`` (a dict, run in order) that this rank is a
    rank of; the meshes made first on every rank."""
    meshes = {}
    for job in jobs.values():
        if _key(job) not in meshes:
            meshes[_key(job)] = fleet_mesh(job["ranks"], job["shape"])
    out = {}
    for name, job in jobs.items():
        if rank in job["ranks"]:
            out[name] = RUN[job["kind"]](job["ranks"].index(rank),
                                         meshes[_key(job)], job)
    D.barrier()
    return out
