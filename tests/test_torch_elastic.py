"""Elastic fleets in the port (``flink_ml_tpu_torch.parallel.elastic``,
``grad_reduce.reshard_state``, ``sgd_fit_outofcore(membership=)``,
``resilient_fit(elastic=)``) against the JAX package.

- The coordinator's cases (``tests/test_elastic.py``) driven on the port's
  ``ElasticCoordinator`` and the JAX package's alike, by the same clock
  and fault schedules: the same answers, transitions and counters.
- ``reshard_state`` against the JAX package's on every leaf but ``key``,
  which follows the port's rule ``(seed, new rank, tick)``;
  ``require_fleet_compat``.
- The fit-level contracts of ``tests/test_faults.py`` (resize at a
  boundary, a controller preemption, a torn cut during a resize, two
  consecutive resizes with the wire accounting leaves, a death in
  mid-chunk, a legacy cut onto another fleet, exact mode) on a world of 6
  gloo CPU ranks (``tests/_torch_linear_ranks.py``, one spawn): each
  resized fit equals the fixed fleet of the new size restoring the same
  cut bit for bit; in ``exact`` and ``topk`` modes it agrees with the JAX
  package's elastic fit; in ``int8`` (two rounding streams by design)
  the port's resized fit equals the port's fixed fleet bit for bit.  A
  JAX-written elastic cut restores in the port onto a different fleet.

Tolerances: the JAX comparisons within atol 1e-5 in ``w`` and ``b`` and
1e-6 in the loss log (``tests/test_torch_linear_layouts.py``)."""

import os

import numpy as np
import pytest

import jax

from flink_ml_tpu.data.datacache import DataCacheWriter as JWriter
from flink_ml_tpu.data.datacache import DataCacheReader as JReader
from flink_ml_tpu.iteration.checkpoint import (
    CheckpointConfig as JCkConfig,
    CheckpointManager as JCkManager,
    require_fleet_compat as j_require_fleet_compat,
)
from flink_ml_tpu.models.common import sgd as JS
from flink_ml_tpu.models.common.losses import LOSSES as JL
from flink_ml_tpu.parallel import elastic as JE
from flink_ml_tpu.parallel import grad_reduce as JGR
from flink_ml_tpu import robustness as JR
from flink_ml_tpu_torch import robustness as TR
from flink_ml_tpu_torch.data.datacache import DataCacheWriter as TWriter
from flink_ml_tpu_torch.iteration.checkpoint import (
    CorruptStateError,
    load_pytree,
    mesh_shape_meta,
    require_fleet_compat,
)
from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES as TL
from flink_ml_tpu_torch.parallel import elastic as TE
from flink_ml_tpu_torch.parallel import grad_reduce as TGR
from flink_ml_tpu_torch.parallel.collectives import FILL_VEC_LEN
from flink_ml_tpu_torch.utils.backend import run_on_ranks

import _torch_linear_ranks as R

WORLD = 6                   # 3 workers of 2 ranks: the contracts' 2 -> 3
ATOL_W, ATOL_LOSS = 1e-5, 1e-6
SPAWN_TIMEOUT_S = 300
TOPK = dict(mode="topk", density=0.25, bucket_count=2, overlap=True,
            axis="data", dcn_axis="dcn")
INT8 = dict(mode="int8", block_size=4, bucket_count=2, overlap=True,
            axis="data", dcn_axis="dcn", int8_accum="fixed", seed=5)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# -------------------------------------------------- the coordinator, alike


def _pair(**kw):
    """The JAX package's coordinator and the port's, built alike (the
    port's pool is ranks, the JAX package's its CPU devices)."""
    n = kw.pop("pool", 8)
    return (JE.ElasticCoordinator(devices=jax.devices()[:n], **kw),
            TE.ElasticCoordinator(devices=list(range(n)), **kw))


def _state(c):
    return (c.fleet_size, c.membership_epoch, c.live_workers(),
            list(c.transitions), dict(c.counters))


def _drive(c, clock, script):
    """Run ``script`` (method name, args) on ``c``, the clock advanced by
    ``("tick", dt)``; each call's return (or its error's type)."""
    out = []
    for name, *args in script:
        if name == "tick":
            clock.advance(args[0])
            continue
        try:
            out.append(getattr(c, name)(*args))
        except Exception as exc:  # noqa: BLE001 — compared by type
            out.append(type(exc).__name__)
    return out


LEASES = [("heartbeat", "w0"), ("tick", 4.0), ("heartbeat", "w0"),
          ("heartbeat", "w1"), ("tick", 2.0), ("expire",),
          ("live_workers",), ("expire",), ("heartbeat", "nope"),
          ("register",), ("register",), ("register",), ("leave", "w3"),
          ("preempt",), ("preempt",), ("fail", "w0"), ("fail", "w0"),
          ("register", "w1")]


@pytest.mark.parametrize("kw", [
    dict(chips_per_worker=1, initial_workers=3, lease_timeout_s=5.0),
    dict(chips_per_worker=1, initial_workers=2, min_workers=2,
         max_workers=3),
    dict(chips_per_worker=2, initial_workers=2, min_workers=1),
], ids=["expiry", "bounds", "two_chips"])
def test_lease_table_transitions_match_jax(kw):
    """Lease expiry on the injected clock, heartbeats, the bounds'
    suppressions, LIFO preemption, deaths and the audit log: the same
    answers and counters as the JAX package's coordinator."""
    jc, tc = FakeClock(), FakeClock()
    j, t = _pair(clock=jc, **kw), _pair(clock=tc, **kw)
    j, t = j[0], t[1]
    assert _drive(t, tc, LEASES) == _drive(j, jc, LEASES)
    assert _state(t) == _state(j)
    assert t.snapshot() == j.snapshot()


def test_mesh_follows_the_fleet_and_marks_it_consumed():
    """The port's mesh is the live workers' ranks (the JAX package's
    devices, by index), ``(dcn, data)``; building it marks the fleet
    consumed for ``poll``.  Without a process group it only describes the
    fleet."""
    j, t = _pair(chips_per_worker=2, initial_workers=2)
    for step in ("first", "join", "preempt"):
        if step == "join":
            j.register(), t.register()
        elif step == "preempt":
            j.preempt(), t.preempt()
        if step != "first":
            assert t.poll() is True and j.poll() is True
        jm, tm = j.mesh(), t.mesh()
        assert tm.shape == dict(jm.shape)
        assert list(tm.ranks) == [d.id for d in jm.devices.flat]
        assert tm.group is None
        assert t.poll() is False and j.poll() is False


def test_on_failure_prefers_lapsed_lease_then_lifo_victim():
    jc, tc = FakeClock(), FakeClock()
    kw = dict(chips_per_worker=1, initial_workers=3, lease_timeout_s=5.0)
    j = _pair(clock=jc, **kw)[0]
    t = _pair(clock=tc, **kw)[1]
    for c, clock, R_ in ((j, jc, JR), (t, tc, TR)):
        clock.advance(6.0)
        c.heartbeat("w1")
        c.heartbeat("w2")
    got = [t.on_failure(RuntimeError("boom")),
           t.on_failure(TR.InjectedDiskFullError("disk full")),
           t.on_failure(TR.InjectedCrash("boom")),
           t.on_failure(TR.InjectedCrash("boom"))]
    want = [j.on_failure(RuntimeError("boom")),
            j.on_failure(JR.InjectedDiskFullError("disk full")),
            j.on_failure(JR.InjectedCrash("boom")),
            j.on_failure(JR.InjectedCrash("boom"))]
    assert got == want == ["w0", None, "w2", None]
    assert _state(t) == _state(j)
    # the fleet's rank 0's classification, as the idle ranks receive it
    t2 = TE.ElasticCoordinator(devices=[0, 1], initial_workers=2)
    assert t2.on_failure(worker_loss=False) is None
    assert t2.on_failure(worker_loss=True) == "w1"


def test_poll_translates_injected_churn_like_jax():
    j, t = _pair(chips_per_worker=1, initial_workers=3)
    outs = []
    for c, R_ in ((j, JR), (t, TR)):
        c.mesh()
        plan = (R_.FaultPlan().inject(c.SCOPE, at=1, kind="preempt")
                .inject(c.SCOPE, at=3, kind="join"))
        got = []
        with plan:
            for i in range(4):
                got.append(c.poll(i))
                if got[-1]:
                    c.mesh()
        c.mesh()
        with R_.FaultPlan().inject(c.SCOPE, at=0, kind="crash"), \
                pytest.raises(R_.InjectedCrash):
            c.poll(4)
        outs.append((got, _state(c)))
    assert outs[1] == outs[0]
    assert outs[1][0] == [False, True, False, True]


@pytest.mark.parametrize("script", [
    [("request_resize", 99), ("request_resize", 1, 2), ("poll",),
     ("poll",), ("poll",), ("mesh",), ("poll",), ("request_resize", 2),
     ("poll",)],
    [("inject_join",), ("request_resize", 4), ("poll",)],
], ids=["pinned", "with_churn"])
def test_request_resize_applies_at_boundary_like_jax(script):
    """A controller request is clamped, last-writer-wins, deferred to its
    pinned boundary and applied through the churn path's transitions;
    with an injected join on the same boundary the join fires first."""
    outs = []
    for c, R_ in zip(_pair(chips_per_worker=1, initial_workers=2 if
                           script[0][0] == "inject_join" else 3,
                           min_workers=1, max_workers=4 if
                           script[0][0] == "inject_join" else 5),
                     (JR, TR)):
        plan = R_.FaultPlan()
        got = []
        for name, *args in script:
            if name == "inject_join":
                plan.inject(c.SCOPE, at=0, kind="join")
                continue
            if name == "request_resize":
                got.append(c.request_resize(args[0], at_boundary=(
                    args[1] if len(args) > 1 else None)))
                continue
            with plan:
                got.append(getattr(c, name)() if name == "poll"
                           else (getattr(c, name)(), None)[1])
        outs.append((got, _state(c), c.snapshot()))
    assert outs[1] == outs[0]


def test_snapshot_publish_tree_and_resize_requested():
    from flink_ml_tpu_torch.obs.tree import default_tree
    from flink_ml_tpu_torch.utils.metrics import MetricGroup

    c = TE.ElasticCoordinator(devices=[0, 1, 2], initial_workers=2)
    c.register()
    c.preempt()
    snap = default_tree(elastic=c).snapshot()["elastic"]
    assert snap["fleet_size"] == 2 and snap["membership_epoch"] == 2
    assert snap["joins"] == 1 and snap["preemptions"] == 1
    g = MetricGroup("root")
    c.publish(g)
    assert g.snapshot()["elastic.fleet_size"] == 2
    exc = TE.ResizeRequested(step=12, fleet_size=3, membership_epoch=2)
    assert exc.step == 12 and "3 worker" in str(exc)
    assert set(TE.__all__) == set(JE.__all__)
    assert TE.MEMBERSHIP_SCOPE == JE.MEMBERSHIP_SCOPE


def test_membership_misuse_fails_loudly(tmp_path):
    """No checkpoint manager, a flat compressed config on the elastic
    (dcn, data) mesh, a hashed layout, no fleet mesh: each refused with
    the JAX package's guidance; a ``ResizeRequested`` with no elastic
    supervisor propagates."""
    c = TE.ElasticCoordinator(devices=[0, 1], initial_workers=2)
    fit = TS.sgd_fit_outofcore
    with pytest.raises(ValueError, match="checkpoint"):
        fit(TL["logistic"], lambda: iter([]), num_features=4,
            config=TS.SGDConfig(max_epochs=1), mesh=c.mesh(), membership=c,
            device="cpu")
    c2 = TE.ElasticCoordinator(chips_per_worker=2, devices=range(4),
                               initial_workers=2)
    gr = TGR.GradReduceConfig(mode="topk", density=0.25)
    with pytest.raises(ValueError, match="dcn_axis"):
        fit(TL["logistic"], lambda: iter([]), num_features=4,
            config=TS.SGDConfig(max_epochs=1, grad_reduce=gr),
            mesh=c2.mesh(), membership=c2, device="cpu",
            checkpoint=TS.CheckpointConfig(str(tmp_path / "ck")))
    with pytest.raises(ValueError, match="dense streaming"):
        fit(TL["logistic"], lambda: iter([]), num_features=4,
            config=TS.SGDConfig(max_epochs=1), mesh=c.mesh(), membership=c,
            indices_key="i", values_key="v", device="cpu")
    with pytest.raises(ValueError, match="process group"):
        fit(TL["logistic"], lambda: iter([]), num_features=4,
            config=TS.SGDConfig(max_epochs=1), mesh=c.mesh(), membership=c,
            device="cpu",
            checkpoint=TS.CheckpointConfig(str(tmp_path / "ck2")))

    def fake_fit(*, checkpoint, resume):
        raise TE.ResizeRequested(step=0, fleet_size=2, membership_epoch=1)

    with pytest.raises(TE.ResizeRequested):
        TR.resilient_fit(fake_fit,
                         checkpoint=TS.CheckpointConfig(str(tmp_path / "r")))


# ------------------------------------------------------------ reshard


def _stacked(n, cfg, like, seed=0):
    """The JAX package's stacked initial state with random mass."""
    st = jax.device_get(JGR.init_state(cfg, like, n))
    rng = np.random.default_rng(seed)
    for key in ("ef", "pending"):
        if key in st:
            st[key] = {k: rng.normal(size=np.shape(v)).astype(np.float32)
                       for k, v in st[key].items()}
    for key in ("ema", "union"):
        if key in st:
            st[key] = np.broadcast_to(
                rng.random(np.shape(st[key])[1:]).astype(np.float32),
                np.shape(st[key])).copy()
    if "fill" in st:
        st["fill"] = rng.random(np.shape(st["fill"])).astype(np.float32)
    return st


@pytest.mark.parametrize("n_old,n_new,ici,cfg", [
    (4, 6, 1, dict(mode="topk", density=0.5, overlap=True)),
    (4, 6, 2, dict(mode="topk", density=0.5, axis="data", dcn_axis="dcn",
                   overlap=True)),
    (6, 2, 2, dict(mode="topk", density=0.25, bucket_count=2, overlap=True,
                   adaptive=True, density_ladder=(0.1, 0.25, "exact"),
                   axis="data", dcn_axis="dcn")),
    (2, 4, 1, dict(mode="int8", block_size=4)),
], ids=["flat", "hier", "adaptive_shrink", "int8"])
def test_reshard_state_matches_jax(n_old, n_new, ici, cfg):
    """Every leaf but ``key`` as the JAX package reshards it (the totals of
    ``ef``/``pending`` per ICI position on the first dcn group, the policy
    leaves from participant 0, ``fill`` zeroed); ``key`` row ``i`` is the
    port's ``(seed, i, tick)``."""
    like = {"w": np.zeros((8,), np.float32), "b": np.zeros((), np.float32)}
    st = _stacked(n_old, JGR.GradReduceConfig(**cfg), like)
    want = JGR.reshard_state(st, n_new, ici_size=ici)
    port_in = dict(st)
    if "key" in port_in:
        port_in["key"] = np.asarray([[7, i, 3] for i in range(n_old)],
                                    np.int64)
    got = TGR.reshard_state(port_in, n_new, ici_size=ici)
    assert set(got) == set(want)
    for key in want:
        if key == "key":
            np.testing.assert_array_equal(
                got["key"], [[7, i, 3] for i in range(n_new)])
            continue
        w, g = want[key], got[key]
        if isinstance(w, dict):
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))
        else:
            np.testing.assert_array_equal(g, np.asarray(w))
    assert TGR.reshard_state(got, n_new) is got
    with pytest.raises(ValueError, match="ICI"):
        TGR.reshard_state(port_in, 2 * n_old + 1, ici_size=2)
    with pytest.raises(ValueError, match="mystery"):
        TGR.reshard_state({**port_in, "mystery": np.zeros((n_old, 2))},
                          n_new * 2)


def test_require_fleet_compat_matches_jax():
    for kw in (dict(saved_participants=4, current_participants=6,
                    path="/ck/ckpt-4"),
               dict(saved_participants=4, current_participants=4)):
        for fn in (require_fleet_compat, j_require_fleet_compat):
            if kw["saved_participants"] != kw["current_participants"]:
                with pytest.raises(Exception, match="mesh-shape metadata"):
                    fn({"epoch": 4}, **kw)
            else:
                fn({"epoch": 4}, **kw)
    with pytest.raises(CorruptStateError):
        require_fleet_compat({"epoch": 4}, saved_participants=4,
                             current_participants=6)
    c = TE.ElasticCoordinator(chips_per_worker=2, devices=range(4),
                              initial_workers=2)
    meta = mesh_shape_meta(c.mesh(), participant_count=4)
    assert meta == {"mesh_shape": {"dcn": 2, "data": 2},
                    "participant_count": 4}
    require_fleet_compat(meta, saved_participants=4, current_participants=6)


# ------------------------------------------------------------ the fits


def _write_cache(writer_cls, path):
    """The JAX package's elastic stream (``tests/test_faults.py``): 1440
    rows of 8 features, 6 batches of 240 an epoch."""
    rng = np.random.default_rng(13)
    true_w = rng.normal(size=(8,))
    writer = writer_cls(path, segment_rows=480)
    for _ in range(3):
        X = rng.normal(size=(480, 8)).astype(np.float32)
        writer.append({"features": X,
                       "label": (X @ true_w > 0).astype(np.float32)})
    writer.finish()
    return path


def _cfg(epochs, gr=None):
    return dict(learning_rate=0.4, max_epochs=epochs, tol=0.0,
                grad_reduce=gr)


def _jax_elastic(cache, root, start, faults, epochs, gr):
    """The JAX package's supervised elastic fit on its CPU devices."""
    coord = JE.ElasticCoordinator(chips_per_worker=2, initial_workers=start)
    plan = JR.FaultPlan()
    for at, kind in faults:
        plan.inject(coord.SCOPE, at=at, kind=kind)
    cfg = JS.SGDConfig(**dict(_cfg(epochs), grad_reduce=None if gr is None
                              else JGR.GradReduceConfig(**gr)))
    with plan:
        return JR.resilient_fit(
            JS.sgd_fit_outofcore, JL["logistic"],
            lambda: plan.wrap_source(JReader(cache, batch_rows=240)),
            checkpoint=JCkConfig(root, max_to_keep=99), elastic=coord,
            backoff=JR.RetryPolicy(base_delay=0.0, sleep=lambda s: None),
            num_features=8, config=cfg, cache_decoded=False,
            steps_per_dispatch=2, checkpoint_every_steps=2)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """One spawn of 6 gloo ranks running every contract; the JAX-written
    cut the port restores is written first."""
    tmp = tmp_path_factory.mktemp("elastic")
    cache = _write_cache(TWriter, str(tmp / "cache"))
    j_cache = _write_cache(JWriter, str(tmp / "j_cache"))
    # the JAX package's fixed fleet of 2 writes the cuts (topk carry)
    coord = JE.ElasticCoordinator(chips_per_worker=2, initial_workers=2)
    JS.sgd_fit_outofcore(
        JL["logistic"], lambda: JReader(j_cache, batch_rows=240),
        mesh=coord.mesh(), membership=coord,
        checkpoint=JCkConfig(str(tmp / "j_ck"), max_to_keep=99),
        num_features=8, config=JS.SGDConfig(**dict(
            _cfg(3), grad_reduce=JGR.GradReduceConfig(**TOPK))),
        cache_decoded=False, steps_per_dispatch=2, checkpoint_every_steps=2)
    import shutil

    os.makedirs(tmp / "j_cut")
    shutil.copytree(tmp / "j_ck" / "ckpt-00000006",
                    tmp / "j_cut" / "ckpt-00000006")
    shutil.copytree(tmp / "j_ck" / "ckpt-00000006",
                    tmp / "j_cut_jax" / "ckpt-00000006")

    def job(name, **kw):
        os.makedirs(tmp / name)
        return dict(dict(dir=str(tmp / name), cache=cache), **kw)

    jobs = {
        "resize": job("resize", start=2, faults=[(2, "join")],
                      config=_cfg(3, TOPK), baseline=(2, 6, 3)),
        "controller": job("controller", start=2, request=(1, 2),
                          config=_cfg(3, TOPK), baseline=(2, 6, 1)),
        "torn": job("torn", start=2, faults=[(2, "join")], torn_at=2,
                    config=_cfg(3, TOPK), baseline=(2, 4, 3)),
        "two": job("two", start=2, faults=[(2, "join"), (5, "preempt")],
                   config=_cfg(4, TOPK), baseline=(2, 6, 3),
                   baseline_faults=[(2, "preempt")]),
        "death": job("death", start=3, source_faults=[(9, "crash")],
                     config=_cfg(3, TOPK), baseline=(3, None, 2)),
        "exact": job("exact", start=2, faults=[(1, "join")],
                     config=_cfg(2), baseline=(2, 4, 3)),
        "int8": job("int8", start=2, faults=[(2, "join")],
                    config=_cfg(3, INT8), baseline=(2, 6, 3)),
        "jax_cut": dict(kind="restore", dir=str(tmp / "j_cut"),
                        cache=cache, workers=3, config=_cfg(3, TOPK)),
        "legacy": job("legacy", start=2, config=_cfg(2, TOPK)),
    }
    # the legacy contract strips the fleet metadata from the cuts its
    # elastic fit wrote, then restores them onto 3 workers
    jobs["legacy_restore"] = dict(kind="restore", strip=True,
                                  dir=str(tmp / "legacy" / "e"),
                                  cache=cache, workers=3,
                                  config=_cfg(2, TOPK))
    out = run_on_ranks(R.elastic_work, WORLD, WORLD, jobs,
                       timeout_s=SPAWN_TIMEOUT_S)
    return tmp, j_cache, jobs, out


def _same(out, name, part="elastic"):
    """The result every rank returned (the idle ranks the fleet's)."""
    got = [o[name][part] for o in out]
    for g in got[1:]:
        np.testing.assert_array_equal(g["w"], got[0]["w"])
        assert g["b"] == got[0]["b"] and g["log"] == got[0]["log"]
    return got[0]


def _assert_bits(a, b):
    np.testing.assert_array_equal(a["w"], b["w"])
    assert a["b"] == b["b"]
    np.testing.assert_array_equal(a["log"], b["log"])


@pytest.mark.parametrize("name,resizes,fleets_after,restored", [
    ("resize", 1, [3], 6), ("controller", 1, [1], 6),
    ("torn", 1, [3], 4), ("two", 2, [3, 2], 6), ("exact", 1, [3], 4),
    ("int8", 1, [3], 6)])
def test_resized_fit_equals_the_fixed_fleet_restoring_the_cut(
        fleets, name, resizes, fleets_after, restored):
    """A resize at a chunk boundary (a join, a controller's preemption,
    two in a row, a torn boundary cut falling back to the cut before it)
    is bit for bit the fixed fleet of the new size restoring the same cut
    (topk + buckets + overlap + hierarchical: EF residual and pending
    buffer across the reshard; exact; int8 with its rounding stream)."""
    tmp, _, jobs, out = fleets
    el = _same(out, name)
    rep = el["report"]
    assert rep["resizes"] == resizes and rep["restarts"] == 0
    assert [e["fleet_size"] for e in rep["events"]] == fleets_after
    assert all(e["kind"] == "resize" for e in rep["events"])
    assert rep["events"][0]["restored_step"] == restored
    assert rep["events"][0]["mttr_s"] is not None
    assert el["fleet"] == fleets_after[-1]
    fixed = _same(out, name, "fixed")
    _assert_bits(el, fixed)
    assert fixed["resizes"] == resizes - 1
    # and the resize changed the run: the donor fleet kept its size
    assert not np.array_equal(el["w"], _same(out, name, "donor")["w"])
    if name == "controller":
        assert el["transitions"] == ["preempt"]
        assert el["counters"]["controller_requests"] == 1
    if name == "torn":
        assert el["restored"] == 4
        assert any(f.endswith(".corrupt") for f in el["files"])


def test_death_in_mid_chunk_recovers_onto_the_survivors(fleets):
    """A crash at a source pull in mid-chunk on a fleet of 3: the LIFO
    victim's lease is revoked, recovery restores the newest cut onto the 2
    survivors (the victim's ranks sit the rest out), bit for bit the fixed
    fleet of 2 restoring that cut."""
    _, _, _, out = fleets
    el = _same(out, "death")
    rep = el["report"]
    assert rep["restarts"] == 1 and rep["resizes"] == 0 and rep["recovered"]
    assert rep["events"][0]["kind"] == "crash"
    assert rep["events"][0]["fleet_size"] == 2
    assert el["counters"]["deaths"] == 1 and el["fleet"] == 2
    assert el["restored"] is not None and el["restored"] >= 6
    _assert_bits(el, _same(out, "death", "fixed"))


def test_wire_accounting_leaves_survive_two_resizes(fleets):
    """The ``fill``/``union`` leaves ride every cut of the 2 -> 3 -> 2 run,
    stacked at both fleet extents (4 and 6 participants): ``union``
    uniform within each ICI column, ``fill`` repopulated after the second
    resize."""
    tmp, _, _, _ = fleets
    ck = tmp / "two" / "e"
    cuts = sorted(n for n in os.listdir(ck) if n.startswith("ckpt-")
                  and not n.endswith((".corrupt", ".old", ".tmp")))
    extents = set()
    for name in cuts:
        tree, meta = load_pytree(str(ck / name))
        gr = tree["params"]["_gr"]
        fill, union = np.asarray(gr["fill"]), np.asarray(gr["union"])
        assert fill.shape[0] == union.shape[0] == meta["participant_count"]
        assert fill.shape[-1] == FILL_VEC_LEN
        u3 = union.reshape(union.shape[0] // 2, 2, *union.shape[1:])
        np.testing.assert_array_equal(u3, np.broadcast_to(u3[:1], u3.shape))
        extents.add(fill.shape[0])
    assert extents == {4, 6}
    tree, _ = load_pytree(str(ck / cuts[-1]))
    assert np.asarray(tree["params"]["_gr"]["fill"]).any()


@pytest.mark.parametrize("name,faults,epochs,gr", [
    ("resize", [(2, "join")], 3, TOPK), ("exact", [(1, "join")], 2, None)])
def test_resized_fit_matches_jax_elastic_fit(fleets, name, faults, epochs,
                                             gr):
    """The port's resized fit against the JAX package's elastic fit under
    the same schedule (topk hierarchical with overlap; exact)."""
    tmp, j_cache, _, out = fleets
    want, want_log = _jax_elastic(j_cache, str(tmp / f"j_{name}"), 2,
                                  faults, epochs, gr)
    got = _same(out, name)
    np.testing.assert_allclose(got["w"], want.coefficients, atol=ATOL_W)
    np.testing.assert_allclose(got["b"], want.intercept, atol=ATOL_W)
    np.testing.assert_allclose(got["log"], want_log, atol=ATOL_LOSS)


def test_jax_written_cut_restores_onto_another_fleet(fleets):
    """A JAX-written elastic cut (fleet of 2 workers, step 6, topk state
    stacked over 4 participants) restored by the port onto 3 workers: its
    reducer state resharded to 6; the fit ends within tolerance of the
    JAX package's fixed fleet of 3 restoring the same cut."""
    tmp, j_cache, _, out = fleets
    got = [o["jax_cut"] for o in out]
    for g in got[1:]:
        np.testing.assert_array_equal(g["w"], got[0]["w"])
    coord = JE.ElasticCoordinator(chips_per_worker=2, initial_workers=3)
    want, want_log = JS.sgd_fit_outofcore(
        JL["logistic"], lambda: JReader(j_cache, batch_rows=240),
        mesh=coord.mesh(), membership=coord,
        checkpoint=JCkManager(JCkConfig(str(tmp / "j_cut_jax"),
                                        max_to_keep=99)),
        resume=True, num_features=8, config=JS.SGDConfig(**dict(
            _cfg(3), grad_reduce=JGR.GradReduceConfig(**TOPK))),
        cache_decoded=False, steps_per_dispatch=2, checkpoint_every_steps=2)
    np.testing.assert_allclose(got[0]["w"], want.coefficients, atol=ATOL_W)
    np.testing.assert_allclose(got[0]["b"], want.intercept, atol=ATOL_W)
    np.testing.assert_allclose(got[0]["log"], want_log, atol=ATOL_LOSS)


def test_legacy_cut_onto_another_fleet_raises(fleets):
    """Cuts stripped of their fleet metadata restore onto a fleet of
    another size with a ``CorruptStateError`` naming the fix, never a
    wrong-shape restore."""
    _, _, _, out = fleets
    for o in out:
        assert "CorruptStateError" in o["legacy_restore"]["error"]
        assert "mesh-shape metadata" in o["legacy_restore"]["error"]
