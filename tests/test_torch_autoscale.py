"""The port's autoscaling control plane (``flink_ml_tpu_torch.autoscale``),
case by case after ``tests/test_autoscale.py``, on the CPU: the versioned
placement store (atomic publish, generation CAS, restart reconciliation,
capacity validation), typed signal frames over the metrics tree, the
hysteresis matrix (deadband, publish-storm immunity, min-dwell), the
injectable clock, controller actuation into the scheduler and a learner
fleet, and the compressed diurnal replay.

The port's controller drives any object with ``request_resize``: the
port's ``ElasticCoordinator`` (a request from a tick applied at the
learner's next chunk boundary, its ``poll``), and a stand-in fleet that
applies a requested size at its next ``poll``.  Against the JAX package
(tolerance 0: host arithmetic on the same injected clock): both
controllers, fed the same ``SignalFrame``s, make the same ``Decision``s;
the compressed diurnal replay — the JAX side with its real
``ElasticCoordinator``, the port with its own or with the stand-in —
gives the same decisions, placements, SLO-violation minutes and chip-idle
fractions."""

import json
import math
import os

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu import autoscale as JA
from flink_ml_tpu import serving as JSV
from flink_ml_tpu.obs import tree as JTREE
from flink_ml_tpu_torch.autoscale import (
    DECISION_HOLD,
    DECISION_SCALE_SERVING,
    DECISION_YIELD_TO_TRAINING,
    AutoscaleController,
    AutoscalePolicy,
    PlacementConflict,
    PlacementMap,
    PlacementStore,
    PolicyConfig,
    SignalFrame,
    SignalSource,
)
from flink_ml_tpu_torch.obs import trace as trace_mod
from flink_ml_tpu_torch.obs.tree import MetricsTree, default_tree, \
    prometheus_text
from flink_ml_tpu_torch.serving import ModelRegistry, SharedScheduler
from flink_ml_tpu_torch.serving.scheduler import (SLO_BULK, SLO_CLASSES,
                                                  SLO_INTERACTIVE)


# -- fixtures ----------------------------------------------------------------

class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _frame(p99=float("nan"), idle=float("nan"), at=0.0, qd_inter=0.0,
           shed_inter=0.0, staleness=float("nan"), brownout=0,
           cls=SignalFrame):
    return cls(
        at=at, tenants={}, interactive_p99_ms=p99,
        queue_depth={"interactive": qd_inter, "standard": 0.0,
                     "bulk": 0.0},
        shed_rate={"interactive": shed_inter, "standard": 0.0,
                   "bulk": 0.0},
        chip_idle_fraction=idle, staleness_s=staleness,
        learner_staleness_s=staleness, fleet_size=0, membership_epoch=0,
        max_generation=float("nan"), brownout_level=brownout)


def _config(cls=PolicyConfig, **kw):
    kw.setdefault("p99_target_ms", 50.0)
    kw.setdefault("total_chips", 8)
    kw.setdefault("chips_per_worker", 1)
    kw.setdefault("min_dwell_s", 10.0)
    kw.setdefault("min_serving_chips", 1)
    return cls(**kw)


class _StubServable:
    """Echo servable; ``busy_s_per_row`` advances an injected clock inside
    predict, so the scheduler's chip-idle fraction is a deterministic
    function of served rows."""

    busy_clock = None
    busy_s_per_row = 0.0
    ready = True
    warmup_report = None

    def __init__(self, model, example, **kwargs):
        self.max_batch_rows = kwargs.get("max_batch_rows", 256)
        self.output_cols = None

    def warm_up(self):
        return self

    def check_schema(self, table):
        pass

    def bucket_for(self, rows):
        return max(8, rows)

    def predict(self, table):
        if _StubServable.busy_clock is not None:
            _StubServable.busy_clock.advance(
                _StubServable.busy_s_per_row * table.num_rows)
        return table


@pytest.fixture
def stub_busy():
    yield
    _StubServable.busy_clock = None
    _StubServable.busy_s_per_row = 0.0


def _stub_scheduler(pkg_sched=SharedScheduler, pkg_reg=ModelRegistry,
                    **kwargs):
    return pkg_sched(pkg_reg(servable_factory=_StubServable), **kwargs)


def _feats(n=8, seed=1, pkg=T):
    rng = np.random.default_rng(seed)
    return pkg.Table({"features": rng.normal(size=(n, 4))})


def _drain(scheduler):
    batches = 0
    while True:
        formed = scheduler._next_batch(timeout=0.0)
        if formed is None:
            return batches
        scheduler._dispatch(*formed)
        batches += 1


class _Fleet:
    """A learner fleet stand-in: ``request_resize`` records the target,
    the next ``poll`` (the learner's chunk boundary) applies it."""

    def __init__(self, workers):
        self.fleet_size = workers
        self.membership_epoch = 0
        self._pending = None
        self.counters = {"preemptions": 0, "grants": 0,
                         "controller_requests": 0}

    def request_resize(self, workers, *, reason=""):
        self._pending = int(workers)
        self.counters["controller_requests"] += 1

    def poll(self):
        if self._pending is not None and self._pending != self.fleet_size:
            key = "preemptions" if self._pending < self.fleet_size \
                else "grants"
            self.counters[key] += abs(self._pending - self.fleet_size)
            self.fleet_size = self._pending
            self.membership_epoch += 1
        self._pending = None

    def snapshot(self):
        return {"fleet_size": self.fleet_size,
                "membership_epoch": self.membership_epoch}


# -- placement store ---------------------------------------------------------

def test_placement_publish_bumps_generation_and_is_durable(tmp_path):
    path = str(tmp_path / "placement.json")
    store = PlacementStore(8, chips_per_worker=2, path=path,
                           clock=FakeClock(5.0))
    assert store.generation == 0
    pmap = store.publish({"a": [0, 1], "b": [1, 2, 3]}, 2)
    assert pmap.generation == 1
    assert pmap.serving_chips() == (0, 1, 2, 3)
    assert pmap.chips_for("a") == (0, 1)
    assert pmap.published_at == 5.0
    assert os.path.exists(path)
    assert not os.path.exists(path + ".tmp")
    on_disk = PlacementMap.from_dict(json.loads(open(path).read()))
    assert on_disk == pmap
    assert store.current() is pmap
    # the JAX package reads the port's file and vice versa
    assert JA.PlacementMap.from_dict(json.loads(open(path).read())) \
        .as_dict() == pmap.as_dict()


def test_placement_validation_rejects_bad_maps():
    store = PlacementStore(4, chips_per_worker=1)
    with pytest.raises(ValueError, match="outside the pool"):
        store.publish({"a": [0, 4]}, 0)
    with pytest.raises(ValueError, match="repeats a chip"):
        store.publish({"a": [1, 1]}, 0)
    with pytest.raises(ValueError, match="overcommits"):
        store.publish({"a": [0, 1, 2]}, 2)
    with pytest.raises(ValueError, match="learner_workers"):
        store.publish({}, -1)
    pmap = store.publish({"a": [0, 1], "b": [0, 1]}, 2)
    assert pmap.serving_chips() == (0, 1)
    with pytest.raises(ValueError):
        PlacementStore(0)
    with pytest.raises(ValueError):
        PlacementStore(2, chips_per_worker=0)


def test_placement_conditional_publish_conflicts():
    store = PlacementStore(4)
    store.publish({"a": [0]}, 1)
    with pytest.raises(PlacementConflict):
        store.publish({"a": [0, 1]}, 1, expected_generation=0)
    assert store.publish({"a": [0, 1]}, 1).generation == 2


def test_placement_load_reconciles_newer_disk_map(tmp_path):
    path = str(tmp_path / "placement.json")
    writer = PlacementStore(8, path=path)
    writer.publish({"a": [0, 1]}, 3)
    writer.publish({"a": [0, 1, 2]}, 2)
    fresh = PlacementStore(8, path=path)
    adopted = fresh.load()
    assert adopted is not None and adopted.generation == 2
    assert fresh.current().learner_workers == 2
    assert fresh.load() is None
    assert PlacementStore(8).load() is None
    # a map the JAX package wrote reconciles into the port's store
    jpath = str(tmp_path / "jax.json")
    JA.PlacementStore(8, path=jpath).publish({"a": [3]}, 1)
    assert PlacementStore(8, path=jpath).load().chips_for("a") == (3,)


# -- signals -----------------------------------------------------------------

def _fake_tree(sched=None, elastic=None, tree_cls=MetricsTree):
    tree = tree_cls()
    if sched is not None:
        tree.register("scheduler", sched)
    if elastic is not None:
        tree.register("elastic", elastic)
    return tree


def _signal_dict():
    return {
        "tenants.inter.slo": "interactive",
        "tenants.inter.latency_p99_ms": 12.5,
        "tenants.inter.queue_depth": 3,
        "tenants.inter.shed": 0,
        "tenants.inter.model_staleness_seconds": float("nan"),
        "tenants.inter.model_generation": 4,
        "tenants.bulk.slo": "bulk",
        "tenants.bulk.latency_p99_ms": 80.0,
        "tenants.bulk.shed": 10,
        "tenants.bulk.model_staleness_seconds": 7.5,
        "queue_depth_interactive": 3,
        "queue_depth_standard": 0,
        "queue_depth_bulk": 9,
        "shed_interactive": 0,
        "shed_standard": 0,
        "shed_bulk": 10,
        "chip_idle_fraction": 0.25,
        "brownout_level": 1,
    }


def test_signals_frame_from_tree_with_windowed_shed_rates():
    clock = FakeClock()
    sched = _signal_dict()
    source = SignalSource(_fake_tree(sched, {"fleet_size": 3,
                                             "membership_epoch": 7}),
                          clock=clock)
    f1 = source.sample()
    assert f1.interactive_p99_ms == 12.5
    assert f1.queue_depth["bulk"] == 9
    assert f1.chip_idle_fraction == 0.25
    assert f1.fleet_size == 3 and f1.membership_epoch == 7
    assert f1.staleness_s == 7.5
    assert f1.max_generation == 4
    assert f1.brownout_level == 1
    assert f1.tenants["inter"].slo == "interactive"
    assert f1.shed_rate["bulk"] == 0.0
    sched["shed_bulk"] = 30
    sched["tenants.bulk.shed"] = 30
    clock.advance(10.0)
    f2 = source.sample()
    assert f2.at == 10.0
    assert f2.shed_rate["bulk"] == pytest.approx(2.0)
    assert f2.tenants["bulk"].shed_rate_per_s == pytest.approx(2.0)
    assert f2.shed_rate["interactive"] == 0.0


def test_signals_missing_surfaces_degrade_to_neutral():
    frame = SignalSource(_fake_tree(), clock=FakeClock()).sample()
    assert frame.tenants == {}
    assert math.isnan(frame.interactive_p99_ms)
    assert math.isnan(frame.chip_idle_fraction)
    assert math.isnan(frame.staleness_s)
    assert frame.fleet_size == 0
    assert all(frame.queue_depth[slo] == 0.0 for slo in SLO_CLASSES)


def test_signal_frames_equal_the_jax_package():
    """The same snapshots through both packages' samplers give the same
    frames (NaN for NaN)."""
    clocks = FakeClock(), FakeClock()
    sched = _signal_dict()
    sched["tenants.learner.slo"] = "standard"
    sched["tenants.learner.model_staleness_seconds"] = 3.0
    ours = SignalSource(_fake_tree(sched, {"fleet_size": 2}),
                        clock=clocks[0], learner_tenant="learner")
    theirs = JA.SignalSource(
        _fake_tree(sched, {"fleet_size": 2}, tree_cls=JTREE.MetricsTree),
        clock=clocks[1], learner_tenant="learner")
    for step in range(4):
        sched["shed_bulk"] += 5 * step
        sched["tenants.bulk.shed"] += 5 * step
        got, want = ours.sample(), theirs.sample()
        assert repr(got).replace("flink_ml_tpu_torch", "flink_ml_tpu") \
            == repr(want)
        for c in clocks:
            c.advance(3.0)


# -- hysteresis unit matrix --------------------------------------------------

def test_deadband_holds_under_oscillating_p99():
    policy = AutoscalePolicy(_config(high_frac=0.9, low_frac=0.5),
                             clock=FakeClock())
    rng = np.random.default_rng(0)
    for i in range(200):
        p99 = 25.1 + 19.8 * rng.random()
        d = policy.decide(_frame(p99=p99, idle=0.9, at=float(i)),
                          learner_workers=2)
        assert d.kind == DECISION_HOLD, (i, p99, d.reason)
    assert policy.actuations == 0
    assert policy.holds == 200


def test_min_dwell_bounds_decisions_per_minute():
    policy = AutoscalePolicy(_config(min_dwell_s=10.0, total_chips=64),
                             clock=FakeClock())
    actuated = []
    workers = 32
    for second in range(60):
        d = policy.decide(_frame(p99=200.0, at=float(second)),
                          learner_workers=workers)
        if d.actuates:
            workers = d.learner_workers
            actuated.append(second)
    assert len(actuated) <= 7
    assert actuated[:2] == [0, 10]
    for a, b in zip(actuated, actuated[1:]):
        assert b - a >= 10


def test_publish_storm_of_30_generations_causes_zero_placement_churn():
    clock = FakeClock()
    sched = {
        "tenants.svc.slo": "interactive",
        "tenants.svc.latency_p99_ms": 30.0,
        "tenants.svc.model_generation": 0,
        "queue_depth_interactive": 0,
        "chip_idle_fraction": 0.2,
    }
    store = PlacementStore(8)
    store.publish({"svc": [0, 1, 2, 3]}, 4)
    base_generation = store.generation
    controller = AutoscaleController.build(
        _fake_tree(sched), store=store, policy_config=_config(),
        clock=clock)
    for generation in range(1, 31):
        sched["tenants.svc.model_generation"] = generation
        clock.advance(1.0)
        assert controller.tick().kind == DECISION_HOLD
    assert store.generation == base_generation
    assert controller.actuations == 0
    assert controller.policy.actuations == 0


def test_policy_respects_floors_ceilings_and_brownout():
    policy = AutoscalePolicy(
        _config(min_learner_workers=1, min_serving_chips=4,
                total_chips=8), clock=FakeClock())
    d = policy.decide(_frame(p99=200.0, at=0.0), learner_workers=1)
    assert d.kind == DECISION_HOLD and "floor" in d.reason
    d = policy.decide(_frame(p99=1.0, idle=0.95, at=100.0),
                      learner_workers=4)
    assert d.kind == DECISION_HOLD and "ceiling" in d.reason
    d = policy.decide(_frame(at=200.0), learner_workers=2)
    assert d.kind == DECISION_HOLD
    # an active brownout vetoes the yield to training
    d = policy.decide(_frame(p99=1.0, idle=0.95, at=300.0, brownout=1),
                      learner_workers=2)
    assert d.kind == DECISION_HOLD
    assert policy.actuations == 0


def test_policy_config_validation():
    with pytest.raises(ValueError, match="deadband"):
        _config(high_frac=0.4, low_frac=0.5)
    with pytest.raises(ValueError, match="p99_target_ms"):
        _config(p99_target_ms=0.0)
    with pytest.raises(ValueError, match="overcommit"):
        _config(total_chips=4, min_serving_chips=3,
                min_learner_workers=2)


def _frames(n=240, seed=5):
    """A seeded walk over every trigger: pressure by p99, by queue and by
    shed; troughs with and without staleness; NaN frames; brownouts."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = int(rng.integers(0, 7))
        p99 = [200.0, 30.0, 5.0, float("nan"), 44.9, 45.0, 25.0][kind]
        out.append(dict(
            p99=p99, at=float(i * 3),
            idle=float(rng.choice([0.2, 0.6, 0.95, float("nan")])),
            qd_inter=float(rng.choice([0.0, 10.0, 64.0])),
            shed_inter=float(rng.choice([0.0, 0.0, 0.0, 1.5])),
            staleness=float(rng.choice([float("nan"), 10.0, 120.0])),
            brownout=int(rng.choice([0, 0, 0, 1]))))
    return out


@pytest.mark.parametrize("seed", [5, 6])
def test_decisions_equal_the_jax_package_on_the_same_frames(seed):
    cfg = dict(min_dwell_s=10.0, total_chips=8, min_learner_workers=1,
               min_serving_chips=2, max_learner_workers=5)
    ours = AutoscalePolicy(_config(**cfg), clock=FakeClock())
    theirs = JA.AutoscalePolicy(_config(JA.PolicyConfig, **cfg),
                                clock=FakeClock())
    workers = [3, 3]
    for kw in _frames(seed=seed):
        got = ours.decide(_frame(**kw), learner_workers=workers[0])
        want = theirs.decide(_frame(cls=JA.SignalFrame, **kw),
                             learner_workers=workers[1])
        assert (got.kind, got.reason, got.serving_chips,
                got.learner_workers, got.at) \
            == (want.kind, want.reason, want.serving_chips,
                want.learner_workers, want.at)
        workers = [got.learner_workers, want.learner_workers]
    assert ours.snapshot() == theirs.snapshot()
    assert ours.actuations > 2


# -- clock injection ---------------------------------------------------------

def test_controller_clock_injectable_end_to_end():
    clock = FakeClock()
    sched = {"tenants.a.slo": "interactive",
             "tenants.a.latency_p99_ms": 500.0,
             "queue_depth_interactive": 0,
             "chip_idle_fraction": 0.0}
    store = PlacementStore(8)
    store.publish({"a": [0, 1, 2, 3]}, 4)
    controller = AutoscaleController.build(
        _fake_tree(sched), store=store,
        policy_config=_config(min_dwell_s=10.0), clock=clock)
    d1 = controller.tick()
    assert d1.kind == DECISION_SCALE_SERVING
    assert d1.at == 0.0
    assert controller.last_decision_latency_s == 0.0
    clock.advance(5.0)
    assert controller.tick().kind == DECISION_HOLD
    assert "min-dwell" in controller.policy.last_reason
    clock.advance(6.0)
    assert controller.tick().kind == DECISION_SCALE_SERVING
    assert store.current().learner_workers == 2
    with pytest.raises(ValueError, match="interval_s"):
        AutoscaleController(store=store, policy=controller.policy,
                            signals=controller.signals, interval_s=0.0)


# -- controller actuation ----------------------------------------------------

def test_controller_actuates_scheduler_and_learner_fleet(stub_busy):
    clock = FakeClock()
    scheduler = _stub_scheduler()
    feats = _feats()
    scheduler.add_tenant("inter", object(), feats.take(2),
                         slo=SLO_INTERACTIVE, weight=2.0)
    scheduler.add_tenant("bulk", object(), feats.take(2), slo=SLO_BULK)
    fleet = _Fleet(4)
    sched_signals = {"tenants.inter.slo": "interactive",
                     "tenants.inter.latency_p99_ms": 500.0,
                     "chip_idle_fraction": 0.0}
    store = PlacementStore(8)
    store.publish({"inter": [0, 1, 2, 3], "bulk": [0, 1, 2, 3]}, 4)
    controller = AutoscaleController.build(
        _fake_tree(sched_signals), store=store, scheduler=scheduler,
        elastic=fleet, policy_config=_config(), clock=clock)
    trace_mod.tracer.enable()
    try:
        d = controller.tick()
    finally:
        instants = [s for s in trace_mod.tracer.spans()
                    if s.name == "autoscale_decision"]
        trace_mod.tracer.disable()
        trace_mod.tracer.clear()
    assert d.kind == DECISION_SCALE_SERVING
    assert store.generation == 2
    pmap = store.current()
    assert pmap.learner_workers == 3
    assert pmap.serving_chips() == (0, 1, 2, 3, 4)
    assert scheduler.tenant("inter").weight == 2.0 * 5
    assert scheduler.tenant("bulk").weight == 1.0 * 5
    assert scheduler.snapshot()["placement_generation"] == 2
    assert fleet.fleet_size == 4
    fleet.poll()
    assert fleet.fleet_size == 3
    assert fleet.counters["preemptions"] == 1
    assert fleet.counters["controller_requests"] == 1
    assert len(instants) == 1
    assert instants[0].ids["x_kind"] == DECISION_SCALE_SERVING
    assert "p99" in instants[0].ids["x_reason"]
    # the control plane observes itself through the same tree
    snap = default_tree(autoscale=controller).snapshot()["autoscale"]
    assert snap["ticks"] == 1 and snap["actuations"] == 1
    assert snap["placement_generation"] == 2
    assert snap["last_kind"] == DECISION_SCALE_SERVING
    # unplaced tenants fall back to their admission weight
    scheduler.apply_placement(PlacementMap(generation=3,
                                           servables={"inter": (0,)},
                                           learner_workers=3))
    assert scheduler.tenant("inter").weight == 2.0
    assert scheduler.tenant("bulk").weight == 1.0


def test_controller_conflict_skips_actuation():
    clock = FakeClock()
    sched = {"tenants.a.slo": "interactive",
             "tenants.a.latency_p99_ms": 500.0}
    store = PlacementStore(8)
    store.publish({"a": [0, 1, 2, 3]}, 4)

    class RacingPolicy(AutoscalePolicy):
        def decide(self, frame, *, learner_workers):
            store.publish({"a": [0, 1, 2, 3]}, 4)
            return super().decide(frame, learner_workers=learner_workers)

    controller = AutoscaleController(
        store=store, policy=RacingPolicy(_config(), clock=clock),
        signals=SignalSource(_fake_tree(sched), clock=clock),
        clock=clock)
    generation = store.generation
    controller.tick()
    assert controller.conflicts == 1
    assert controller.actuations == 0
    assert store.generation == generation + 1


def test_controller_background_thread_ticks_and_stops():
    import time as _time

    store = PlacementStore(4)
    store.publish({"a": [0]}, 1)
    controller = AutoscaleController.build(
        _fake_tree({}), store=store,
        policy_config=_config(total_chips=4), interval_s=0.005).start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            controller.start()
        deadline = _time.time() + 5.0
        while controller.ticks < 2 and _time.time() < deadline:
            _time.sleep(0.005)
    finally:
        controller.stop(timeout=5.0)
    assert controller.ticks >= 2
    assert controller._thread is None


# -- obs round-trip ----------------------------------------------------------

def test_scheduler_class_depth_and_idle_gauges_round_trip(stub_busy):
    clock = FakeClock()
    _StubServable.busy_clock = clock
    _StubServable.busy_s_per_row = 0.1
    scheduler = _stub_scheduler(max_batch_rows=8, max_wait_ms=0.0,
                                busy_clock=clock)
    feats = _feats()
    scheduler.add_tenant("inter", object(), feats.take(2),
                         slo=SLO_INTERACTIVE)
    scheduler.add_tenant("bulk", object(), feats.take(2), slo=SLO_BULK)
    snap = scheduler.snapshot()
    assert math.isnan(snap["chip_idle_fraction"])
    text = prometheus_text({"scheduler": snap})
    assert "chip_idle_fraction" not in text
    assert "queue_depth_interactive 0" in text
    for _ in range(3):
        scheduler.submit("inter", feats.take(4))
    scheduler.submit("bulk", feats.take(4))
    snap = scheduler.snapshot()
    assert snap["queue_depth_interactive"] == 3
    assert snap["queue_depth_bulk"] == 1
    assert snap["tenants.inter.slo"] == "interactive"
    _drain(scheduler)
    clock.advance(10.0 - 1.6)
    snap = scheduler.snapshot()
    assert snap["chip_idle_fraction"] == pytest.approx(0.84)
    assert snap["queue_depth_interactive"] == 0
    text = prometheus_text({"scheduler": snap})
    assert "flink_ml_tpu_scheduler_chip_idle_fraction 0.84" in text
    assert "flink_ml_tpu_scheduler_queue_depth_bulk 0" in text
    frame = SignalSource(_fake_tree(scheduler.snapshot()),
                         clock=FakeClock()).sample()
    assert frame.chip_idle_fraction == pytest.approx(0.84)


def test_controller_drives_the_elastic_coordinator_at_the_next_boundary(
        stub_busy):
    """The port's controller and the port's ``ElasticCoordinator`` end to
    end (``tests/test_autoscale.py``'s actuation case): the tick's
    ``request_resize`` is not applied at the tick but at the learner's
    next chunk boundary (``poll``), through the same preempt transition
    injected churn takes; the fleet's gauges reach the metrics tree."""
    from flink_ml_tpu_torch.parallel.elastic import ElasticCoordinator

    clock = FakeClock()
    scheduler = _stub_scheduler()
    feats = _feats()
    scheduler.add_tenant("inter", object(), feats.take(2),
                         slo=SLO_INTERACTIVE, weight=2.0)
    scheduler.add_tenant("bulk", object(), feats.take(2), slo=SLO_BULK)
    coord = ElasticCoordinator(chips_per_worker=1, initial_workers=4,
                               min_workers=1, clock=clock,
                               devices=list(range(8)))
    coord.mesh()
    sched_signals = {"tenants.inter.slo": "interactive",
                     "tenants.inter.latency_p99_ms": 500.0,
                     "chip_idle_fraction": 0.0}
    store = PlacementStore(8)
    store.publish({"inter": [0, 1, 2, 3], "bulk": [0, 1, 2, 3]}, 4)
    controller = AutoscaleController.build(
        _fake_tree(sched_signals), store=store, scheduler=scheduler,
        elastic=coord, policy_config=_config(), clock=clock)
    d = controller.tick()
    assert d.kind == DECISION_SCALE_SERVING
    assert store.current().learner_workers == 3
    assert coord.fleet_size == 4 and coord.counters["controller_requests"] == 1
    assert coord.snapshot()["pending_resize_target"] == 3
    assert coord.poll() is True            # the learner's next boundary
    assert coord.fleet_size == 3 and coord.transitions[-1][0] == "preempt"
    assert coord.counters["preemptions"] == 1
    assert coord.fleet_ranks() == (0, 1, 2)
    assert coord.mesh().shape == {"dcn": 3, "data": 1}
    assert coord.poll() is False
    snap = default_tree(elastic=coord).snapshot()["elastic"]
    assert snap["fleet_size"] == 3 and snap["pending_resize_target"] == -1


# -- the acceptance replay ---------------------------------------------------

REPLAY_TARGET_MS = 250.0
REPLAY_DT = 900.0                 # one tick per compressed 15 min


def _replay(pkg):
    """The compressed 24 h diurnal day through ``pkg``'s scheduler,
    placement store and controller on one fake clock: returns the per-tick
    record both packages must agree on."""
    clock = FakeClock()
    _StubServable.busy_clock = clock
    _StubServable.busy_s_per_row = 0.9
    if pkg == "torch":
        scheduler = _stub_scheduler(max_batch_rows=64, max_wait_ms=0.0,
                                    busy_clock=clock)
        fleet = _Fleet(4)
        store = PlacementStore(8, chips_per_worker=1)
        tree = default_tree(scheduler=scheduler).register("elastic", fleet)
        build, cfg, table = AutoscaleController.build, PolicyConfig, T
    elif pkg == "torch-elastic":
        from flink_ml_tpu_torch.parallel.elastic import ElasticCoordinator

        scheduler = _stub_scheduler(max_batch_rows=64, max_wait_ms=0.0,
                                    busy_clock=clock)
        fleet = ElasticCoordinator(chips_per_worker=1, initial_workers=4,
                                   min_workers=1, clock=clock,
                                   devices=list(range(8)))
        store = PlacementStore(8, chips_per_worker=1)
        tree = default_tree(scheduler=scheduler, elastic=fleet)
        build, cfg, table = AutoscaleController.build, PolicyConfig, T
    else:
        from flink_ml_tpu.parallel.elastic import ElasticCoordinator

        scheduler = _stub_scheduler(JSV.SharedScheduler, JSV.ModelRegistry,
                                    max_batch_rows=64, max_wait_ms=0.0,
                                    busy_clock=clock)
        fleet = ElasticCoordinator(chips_per_worker=1, initial_workers=4,
                                   min_workers=1, clock=clock)
        store = JA.PlacementStore(8, chips_per_worker=1)
        tree = JTREE.default_tree(scheduler=scheduler, elastic=fleet)
        build, cfg, table = JA.AutoscaleController.build, \
            JA.PolicyConfig, J
    feats = _feats(64, pkg=table)
    scheduler.add_tenant("inter", object(), feats.take(2),
                         slo=SLO_INTERACTIVE)
    scheduler.add_tenant("bulk", object(), feats.take(2), slo=SLO_BULK)
    store.publish({"inter": [0, 1, 2, 3], "bulk": [0, 1, 2, 3]}, 4)
    controller = build(
        tree, store=store, scheduler=scheduler, elastic=fleet, clock=clock,
        policy_config=_config(
            cfg, p99_target_ms=REPLAY_TARGET_MS, queue_high=24,
            idle_high=0.6, min_dwell_s=1800.0, min_serving_chips=4,
            min_learner_workers=1))
    record = []
    last_publish, max_staleness = 0.0, 0.0
    for tick in range(96):
        hour = (tick * REPLAY_DT / 3600.0) % 24.0
        peak = 9.0 <= hour < 21.0
        for _ in range(30 if peak else 1):
            scheduler.submit("inter", feats.take(8))
        if not peak:
            scheduler.submit("bulk", feats.take(16))
        decision = controller.tick()
        _drain(scheduler)
        fleet.poll()
        assert fleet.fleet_size == store.current().learner_workers
        if fleet.fleet_size >= 1:
            last_publish = clock.t
        max_staleness = max(max_staleness, clock.t - last_publish)
        snap = scheduler.snapshot()
        record.append((decision.kind, decision.reason,
                       decision.learner_workers, store.generation,
                       snap["chip_idle_fraction"],
                       snap["tenants.inter.latency_p99_ms"]
                       > REPLAY_TARGET_MS))
        clock.advance(REPLAY_DT)
    return (record, controller.actuations, scheduler.shed_counts(),
            max_staleness, store.generation,
            snap["tenants.inter.latency_p99_ms"])


def test_compressed_diurnal_replay_holds_p99_and_bounds_staleness(
        stub_busy):
    trace_mod.tracer.enable(capacity=4096)
    try:
        record, actuations, shed, staleness, generation, p99 = \
            _replay("torch")
    finally:
        instants = [s for s in trace_mod.tracer.spans()
                    if s.name == "autoscale_decision"]
        trace_mod.tracer.disable()
        trace_mod.tracer.clear()
    assert len(instants) == 96
    assert all(s.ids["x_reason"] for s in instants)
    kinds = {r[0] for r in record}
    assert DECISION_SCALE_SERVING in kinds
    assert DECISION_YIELD_TO_TRAINING in kinds
    assert actuations >= 2
    assert shed[SLO_INTERACTIVE] == 0
    assert p99 < REPLAY_TARGET_MS
    assert staleness <= 2 * REPLAY_DT
    assert generation >= 1 + actuations


def test_diurnal_replay_equals_the_jax_package(stub_busy):
    """The same day through both control planes: the same decisions and
    reasons, learner extents and placement generations at every tick, the
    same chip-idle fractions (the injected busy clock), the same
    SLO-violation minutes (ticks with interactive p99 over the target,
    x 15 min) and sheds."""
    got = _replay("torch")
    want = _replay("jax")
    assert [r[:4] for r in got[0]] == [r[:4] for r in want[0]]
    idle = [r[4] for r in got[0]]
    assert idle == [r[4] for r in want[0]]
    violation_min = [sum(r[5] for r in run[0]) * REPLAY_DT / 60.0
                     for run in (got, want)]
    assert violation_min[0] == violation_min[1] == 0.0
    assert got[1:5] == want[1:5]
    assert any(0.0 < f < 1.0 for f in idle if not math.isnan(f))


def test_diurnal_replay_with_the_elastic_coordinator_equals_the_jax_package(
        stub_busy):
    """The replay with the port's own ``ElasticCoordinator`` as the learner
    fleet: every tick's decision, extent and generation, the idle
    fractions and the sheds are the JAX package's."""
    got = _replay("torch-elastic")
    want = _replay("jax")
    assert [r[:5] for r in got[0]] == [r[:5] for r in want[0]]
    assert got[1:5] == want[1:5]
