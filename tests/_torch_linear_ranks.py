"""Work that ``tests/test_torch_sharded_linear.py`` and
``tests/test_torch_elastic.py`` run on each rank of a gloo process group
(``flink_ml_tpu_torch.utils.backend.run_on_ranks``).  A module of its own,
importing neither JAX nor the JAX package, so that the spawned ranks start
fast; the tests compare what the ranks return with the JAX package.

A job names the ranks it runs on (``ranks``, ascending) and its mesh's
axes (``shape``); every rank makes every job's mesh first, in job order
(group creation is collective over the world), then runs the jobs it is a
rank of."""

import os
import shutil
import time

import numpy as np
import torch

from flink_ml_tpu_torch.models.common import sgd as S
from flink_ml_tpu_torch.models.common.losses import LOSSES
from flink_ml_tpu_torch.ops import ell_scatter as E
from flink_ml_tpu_torch.parallel import distributed as D
from flink_ml_tpu_torch.parallel.mesh import fleet_mesh


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def step_job(pos, mesh, job):
    """One step of the sharded ELL update on this rank's shard (its own
    layout, slot sources numbered inside it), from ``job["params"]``."""
    d, cfg = job["d"], S.SGDConfig(**job["config"])
    loss = LOSSES[job["loss"]]
    cat = job["cat"][pos]
    y, wb = _t(job["y"][pos]), _t(job["wb"][pos])
    params = {k: _t(np.asarray(v, np.float32)) for k, v in
              job["params"].items()}
    if job["layout"] == "mixed":
        lay = E.ell_layout(cat[None], d).to("cpu")
        route_w, _ = E.sample_routing(lay.src, lay.pos, lay.mask, len(cat))
        upd = S._mixed_update_ell_sharded(loss, cfg, mesh)
        got, value = upd(params, _t(job["dense"][pos]), route_w[0],
                         lay.src[0], lay.pos[0], lay.mask[0],
                         lay.ovf_idx[0], lay.ovf_src[0], lay.heavy_idx[0],
                         lay.heavy_cnt[0], y, wb)
    else:
        vals = job["vals"][pos]
        lay = E.ell_layout(cat[None], d, values=vals[None]).to("cpu")
        route = E.sample_routing(lay.src, lay.pos, lay.mask, len(cat),
                                 val=lay.val)
        upd = S._sparse_update_ell_sharded(loss, cfg, mesh)
        got, value = upd(params, (route[0][0], route[1][0]), lay.src[0],
                         lay.pos[0], lay.mask[0], lay.val[0], lay.ovf_idx[0],
                         lay.ovf_src[0], lay.ovf_val[0], lay.heavy_idx[0],
                         lay.heavy_cnt[0], y, wb)
    return {"w": got["w"], "b": got["b"], "loss": value}


def fit_job(pos, mesh, job):
    """``sgd_fit_mixed`` / ``sgd_fit_sparse`` of this rank's rows on the
    job's mesh (rows by data shard: ``job["shard_of"][pos]``)."""
    rows = job["rows"][job.get("shard_of", list(range(999)))[pos]]
    cfg = S.SGDConfig(**job["config"])
    loss = LOSSES[job.get("loss", "logistic")]
    if job["layout"] == "mixed":
        st, log = S.sgd_fit_mixed(loss, rows["dense"], rows["cat"],
                                  rows["y"], rows.get("w"), job["d"], cfg,
                                  device="cpu", mesh=mesh)
    else:
        st, log = S.sgd_fit_sparse(loss, rows["idx"], rows["vals"],
                                   rows["y"], rows.get("w"), job["d"], cfg,
                                   device="cpu", mesh=mesh)
    return {"w": st.coefficients, "b": st.intercept, "log": log,
            "impl": st.planned_impl}


def _reader(batches, plan=None):
    def make():
        return iter(batches) if plan is None else plan.wrap_source(
            iter(batches))
    return make


def stream_job(pos, mesh, job):
    """``sgd_fit_outofcore(mesh=)`` over this rank's own batches: the
    uninterrupted fit, then the same fit under ``resilient_fit`` with a
    crash injected at a source pull in mid-epoch (resumed from the newest
    chunk-boundary cut)."""
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointConfig
    from flink_ml_tpu_torch.robustness import (
        FaultPlan,
        RecoveryReport,
        RetryPolicy,
        resilient_fit,
    )

    batches = job["batches"][pos]
    cfg = S.SGDConfig(**job["config"])
    kw = dict(job["keys"], num_features=job["d"], config=cfg, device="cpu",
              mesh=mesh, cache_decoded=False, checkpoint_every_steps=2)
    info = {}
    t0 = time.perf_counter()
    st, log = S.sgd_fit_outofcore(LOSSES["logistic"], _reader(batches),
                                  stream_info=info, **kw)
    out = {"w": st.coefficients, "b": st.intercept, "log": log,
           "impl": st.planned_impl, "W": info["steps_per_dispatch"],
           "seconds": time.perf_counter() - t0}
    if job.get("crash_at") is not None:
        ck = job["dir"]
        plan = FaultPlan().inject("source.pull", at=job["crash_at"],
                                  kind="crash")
        rep = RecoveryReport()
        with plan:
            st2, log2 = resilient_fit(
                S.sgd_fit_outofcore, LOSSES["logistic"],
                _reader(batches, plan),
                checkpoint=CheckpointConfig(ck, max_to_keep=99),
                backoff=RetryPolicy(base_delay=0.0, sleep=lambda s: None),
                report=rep, **kw)
        out["resumed"] = {"w": st2.coefficients, "b": st2.intercept,
                          "log": log2, "restarts": rep.restarts,
                          "restored": rep.events[0].restored_step
                          if rep.events else None,
                          "cuts": sorted(os.listdir(ck))}
    return out


RUN = {"step": step_job, "fit": fit_job, "stream": stream_job}


def linear_work(rank, world, jobs):
    """Every job of ``jobs`` (a dict, run in order) that this rank is a
    rank of; its meshes made first on every rank."""
    meshes = {}
    for job in jobs.values():
        key = (tuple(job["ranks"]), tuple(job["shape"].items()))
        if key not in meshes:
            meshes[key] = fleet_mesh(job["ranks"], job["shape"])
    out = {}
    for name, job in jobs.items():
        if rank not in job["ranks"]:
            continue
        mesh = meshes[(tuple(job["ranks"]), tuple(job["shape"].items()))]
        out[name] = RUN[job["kind"]](job["ranks"].index(rank), mesh, job)
    D.barrier()
    return out


# ---------------------------------------------------------------- elastic


def _elastic_reader(cache, plan=None):
    from flink_ml_tpu_torch.data.datacache import DataCacheReader

    def make():
        reader = DataCacheReader(cache, batch_rows=240)
        return reader if plan is None else plan.wrap_source(reader)
    return make


def _coord(workers, chips=2, **kw):
    from flink_ml_tpu_torch.parallel.elastic import ElasticCoordinator

    return ElasticCoordinator(chips_per_worker=chips,
                              initial_workers=workers, **kw)


def _schedule(plan, scope, faults):
    for at, kind in faults:
        plan.inject(scope, at=at, kind=kind)
    return plan


def _copy_cut(src, dst, step):
    if D.process_info().process_index == 0:
        name = f"ckpt-{step:08d}"
        os.makedirs(dst, exist_ok=True)
        shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    D.barrier()


def elastic_job(job):
    """One of the JAX package's elastic chaos contracts
    (``tests/test_faults.py``) on this world of ranks: the supervised
    elastic fit under ``job["faults"]`` (membership scope) and
    ``job["source_faults"]`` (source pulls), then the fixed fleets that
    hold it bit for bit: the donor fleet writing the cut, and the fleet of
    the new size restoring it (with ``job["baseline_faults"]`` when the
    contract chains a second resize)."""
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

    root, cache = job["dir"], job["cache"]
    cfg = S.SGDConfig(**job["config"])
    kw = dict(num_features=8, config=cfg, cache_decoded=False,
              steps_per_dispatch=2, checkpoint_every_steps=2, device="cpu")
    loss = LOSSES["logistic"]
    nobackoff = RetryPolicy(base_delay=0.0, sleep=lambda s: None)
    out = {}

    coord = _coord(job["start"])
    if job.get("request") is not None:
        target, at = job["request"]
        coord.request_resize(target, at_boundary=at, reason="controller")
    plan = _schedule(_schedule(FaultPlan(seed=3), coord.SCOPE,
                               job.get("faults", ())),
                     "source.pull", job.get("source_faults", ()))
    if job.get("torn_at") is not None:
        plan.inject("checkpoint.write", at=job["torn_at"], kind="torn")
    rep = RecoveryReport()
    manager = CheckpointManager(CheckpointConfig(os.path.join(root, "e"),
                                                 max_to_keep=99))
    t0 = time.perf_counter()
    with plan:
        st, log = resilient_fit(
            S.sgd_fit_outofcore, loss, _elastic_reader(cache, plan),
            checkpoint=manager, elastic=coord, backoff=nobackoff,
            report=rep, max_restarts=2, **kw)
    out["elastic"] = {
        "w": st.coefficients, "b": st.intercept, "log": log,
        "seconds": time.perf_counter() - t0,
        "report": rep.as_dict(), "restored": manager.last_restored_step,
        "fleet": coord.fleet_size, "counters": dict(coord.counters),
        "transitions": [t[0] for t in coord.transitions],
        "files": sorted(os.listdir(os.path.join(root, "e")))}
    if job.get("baseline") is None:
        return out
    donor_workers, cut, new_workers = job["baseline"]
    # the donor: a fixed fleet with its cuts kept (no fault: one attempt)
    st_a, log_a = resilient_fit(
        S.sgd_fit_outofcore, loss, _elastic_reader(cache),
        checkpoint=CheckpointConfig(os.path.join(root, "a"),
                                    max_to_keep=99),
        elastic=_coord(donor_workers), backoff=nobackoff, **kw)
    out["donor"] = {"w": st_a.coefficients, "b": st_a.intercept,
                    "log": log_a}
    if cut is None:
        cut = out["elastic"]["restored"]
    _copy_cut(os.path.join(root, "a"), os.path.join(root, "b"), cut)
    fixed = _coord(new_workers)
    plan_b = _schedule(FaultPlan(seed=3), fixed.SCOPE,
                       job.get("baseline_faults", ()))
    rep_b = RecoveryReport()
    with plan_b:
        st_b, log_b = resilient_fit(
            S.sgd_fit_outofcore, loss, _elastic_reader(cache, plan_b),
            checkpoint=CheckpointManager(CheckpointConfig(
                os.path.join(root, "b"), max_to_keep=99)),
            elastic=fixed, resume=True, backoff=nobackoff, report=rep_b,
            **kw)
    out["fixed"] = {"w": st_b.coefficients, "b": st_b.intercept,
                    "log": log_b, "resizes": rep_b.resizes}
    return out


def restore_job(job):
    """A fixed fleet of ``job["workers"]`` restoring the cut that
    ``job["dir"]`` holds (written by either package) and training on to
    the end; with ``job["strip"]`` rank 0 first strips the fleet
    metadata from every cut (a legacy cut) and the error comes back."""
    import json

    from flink_ml_tpu_torch.iteration.checkpoint import (
        CheckpointConfig,
        CheckpointManager,
    )
    from flink_ml_tpu_torch.robustness import (
        RetryPolicy,
        resilient_fit,
        write_manifest,
    )

    ck = job["dir"]
    if job.get("strip") and D.process_info().process_index == 0:
        for name in os.listdir(ck):
            if not name.startswith("ckpt-") or name.endswith(".corrupt"):
                continue
            path = os.path.join(ck, name, "structure.json")
            with open(path) as f:
                doc = json.load(f)
            for key in ("mesh_shape", "participant_count"):
                doc["meta"].pop(key, None)
            with open(path, "w") as f:
                json.dump(doc, f)
            write_manifest(os.path.join(ck, name))
    D.barrier()
    cfg = S.SGDConfig(**job["config"])
    try:
        st, log = resilient_fit(
            S.sgd_fit_outofcore, LOSSES["logistic"],
            _elastic_reader(job["cache"]),
            checkpoint=CheckpointManager(CheckpointConfig(ck,
                                                          max_to_keep=99)),
            elastic=_coord(job["workers"]), resume=True, max_restarts=0,
            backoff=RetryPolicy(base_delay=0.0, sleep=lambda s: None),
            num_features=8, config=cfg, cache_decoded=False,
            steps_per_dispatch=2, checkpoint_every_steps=2, device="cpu")
    except Exception as exc:  # noqa: BLE001 — the test reads it
        return {"error": f"{type(exc).__name__}: {exc}"}
    return {"w": st.coefficients, "b": st.intercept, "log": log}


def elastic_work(rank, world, jobs):
    """Each elastic job on this rank (every rank of the world runs every
    job: the fleets are some of its ranks)."""
    for job in jobs.values():
        job["config"] = dict(job["config"])
        if job["config"].get("grad_reduce") is not None:
            from flink_ml_tpu_torch.parallel.grad_reduce import (
                GradReduceConfig,
            )

            job["config"]["grad_reduce"] = GradReduceConfig(
                **job["config"]["grad_reduce"])
    run = {"elastic": elastic_job, "restore": restore_job}
    out = {name: run[job.get("kind", "elastic")](job)
           for name, job in jobs.items()}
    D.barrier()
    return out
