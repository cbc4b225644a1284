"""The port's serving failover (``flink_ml_tpu_torch.serving.failover``) and
the scheduler's brownout, placement and failover hooks, case by case after
``tests/test_failover.py`` and the failover cases of
``tests/test_faults.py``, on the CPU.

The fleet's chips are logical placement slots (the JAX package's
single-process harness, ``lease_timeout_s`` on an injected clock).  The
queue-mechanics cases use an echo servable; the chaos cases serve real
port models and hold every retried response bit for bit to an unfailed
run.  Against the JAX package: ``FleetHealth`` / ``FailoverDriver`` of
both packages, fed the same seeded ``FaultPlan`` on the same injected
clock, give the same transitions, placement generations, brownout levels
and failover reports (tolerance 0: all of it is host bookkeeping).

Every blocking wait has a timeout."""

import time
import types

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu import autoscale as JA
from flink_ml_tpu import serving as JSV
from flink_ml_tpu.obs import tree as JTREE
from flink_ml_tpu.robustness import faults as JF
from flink_ml_tpu_torch import autoscale as TA
from flink_ml_tpu_torch import serving as TSV
from flink_ml_tpu_torch.autoscale.placement import PlacementStore
from flink_ml_tpu_torch.obs import tree as TTREE
from flink_ml_tpu_torch.obs.tree import default_tree
from flink_ml_tpu_torch.online import DeltaEncoder, params_of_model
from flink_ml_tpu_torch.robustness import faults as TF
from flink_ml_tpu_torch.robustness.faults import (FaultPlan,
                                                  InjectedChipDown,
                                                  InjectedChipFlap)
from flink_ml_tpu_torch.robustness.retry import (DeadlineExceededError,
                                                 RetryPolicy,
                                                 default_classify)
from flink_ml_tpu_torch.serving import (
    CHIP_SCOPE,
    DISPATCH_SCOPE,
    SLO_BULK,
    SLO_CLASSES,
    SLO_INTERACTIVE,
    SLO_STANDARD,
    FailoverDriver,
    FleetHealth,
    ModelRegistry,
    ServingOverloadedError,
    SharedScheduler,
)
from flink_ml_tpu_torch.serving.metrics import HEALTH_SERVING

#: both packages' failover surfaces, for the parity cases
PKGS = {
    "torch": types.SimpleNamespace(
        Table=T.Table, SharedScheduler=TSV.SharedScheduler,
        ModelRegistry=TSV.ModelRegistry, FailoverDriver=TSV.FailoverDriver,
        FleetHealth=TSV.FleetHealth, PlacementStore=TA.PlacementStore,
        FaultPlan=TF.FaultPlan, InjectedChipDown=TF.InjectedChipDown,
        InjectedChipFlap=TF.InjectedChipFlap, default_tree=TTREE.default_tree),
    "jax": types.SimpleNamespace(
        Table=J.Table, SharedScheduler=JSV.SharedScheduler,
        ModelRegistry=JSV.ModelRegistry, FailoverDriver=JSV.FailoverDriver,
        FleetHealth=JSV.FleetHealth, PlacementStore=JA.PlacementStore,
        FaultPlan=JF.FaultPlan, InjectedChipDown=JF.InjectedChipDown,
        InjectedChipFlap=JF.InjectedChipFlap, default_tree=JTREE.default_tree),
}


# -- fixtures ----------------------------------------------------------------

class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class _StubServable:
    """Echo servable: queue/placement mechanics without model fits."""

    ready = True
    warmup_report = None

    def __init__(self, model, example, **kwargs):
        self.model = model
        self.example = example
        self.max_batch_rows = kwargs.get("max_batch_rows", 256)
        self.min_bucket = kwargs.get("min_bucket", 8)
        self.output_cols = None

    def warm_up(self):
        return self

    def check_schema(self, table):
        pass

    def bucket_for(self, rows):
        return max(8, rows)

    def predict(self, table):
        return table


def _stub_scheduler(pkg=PKGS["torch"], **kwargs):
    return pkg.SharedScheduler(
        pkg.ModelRegistry(servable_factory=_StubServable), **kwargs)


def _feats(n=256, seed=1, pkg=PKGS["torch"]):
    rng = np.random.default_rng(seed)
    return pkg.Table({"features": rng.normal(size=(n, 8))})


def _drain(scheduler, max_batches=10_000):
    batches = 0
    while batches < max_batches:
        formed = scheduler._next_batch(timeout=0.0)
        if formed is None:
            return batches
        scheduler._dispatch(*formed)
        batches += 1
    raise AssertionError("drain did not converge")


def _fleet(chips, placements, tenants, *, clock=None, pkg=PKGS["torch"],
           **driver_kw):
    clock = clock or FakeClock()
    s = _stub_scheduler(pkg, max_batch_rows=8, max_wait_ms=0.0,
                        queue_capacity=4096)
    feats = _feats(pkg=pkg)
    for name, slo in tenants:
        s.add_tenant(name, object(), feats.take(2), slo=slo)
    store = pkg.PlacementStore(max(chips) + 1)
    store.publish(placements, 0)
    driver = pkg.FailoverDriver(s, store, chips=chips, clock=clock,
                                **driver_kw)
    return s, store, driver, clock


# -- FleetHealth: the chip lease table ---------------------------------------

def test_lease_expiry_detects_silent_death_on_injected_clock():
    clock = FakeClock()
    h = FleetHealth([0, 1, 2], lease_timeout_s=5.0, clock=clock)
    clock.advance(3.0)
    assert h.heartbeat(0)
    clock.advance(3.0)
    assert h.expire() == [1, 2]
    assert h.live() == [0]
    assert h.down() == [1, 2]
    snap = h.snapshot()
    assert snap["expiries"] == 2 and snap["deaths"] == 2
    assert h.epoch == 2
    assert [k for k, _, _ in h.transitions] == ["expired", "expired"]


def test_heartbeat_from_declared_dead_chip_is_suppressed():
    h = FleetHealth([0, 1], clock=FakeClock())
    assert h.fail(1)
    assert not h.heartbeat(1)
    assert h.down() == [1]
    assert h.snapshot()["suppressed"] == 1
    assert not h.fail(1)
    assert h.recover(1)
    assert h.live() == [0, 1]
    assert h.snapshot()["recoveries"] == 1


def test_poll_translates_seeded_chip_down_to_lifo_victim():
    def run():
        h = FleetHealth([0, 1, 2], clock=FakeClock())
        with FaultPlan(seed=3).inject(CHIP_SCOPE, at=1, kind="chip_down"):
            events = [h.poll() for _ in range(3)]
        return h, events

    h, events = run()
    assert events == [[], [("down", 2)], []]
    assert h.down() == [2]
    assert h.transitions == [("down", 2, 1)]
    h2, events2 = run()
    assert events2 == events and h2.transitions == h.transitions


def test_chip_flap_recovers_after_scheduled_polls():
    h = FleetHealth([0, 1], clock=FakeClock(), flap_recovery_polls=2)
    with FaultPlan().inject(CHIP_SCOPE, at=0, kind="chip_flap"):
        assert h.poll() == [("down", 1)]
    assert h.down() == [1]
    assert h.poll() == [("up", 1)]
    assert h.live() == [0, 1]
    snap = h.snapshot()
    assert snap["flaps"] == 1 and snap["recoveries"] == 1
    assert [k for k, _, _ in h.transitions] == ["flap_down", "up"]


def test_fleet_health_validates_construction():
    with pytest.raises(ValueError):
        FleetHealth([])
    with pytest.raises(ValueError):
        FleetHealth([0], lease_timeout_s=0.0)
    with pytest.raises(ValueError):
        FleetHealth([0], flap_recovery_polls=0)
    with pytest.raises(ValueError, match="twice"):
        FleetHealth([0, 0])


# -- the failover itself -----------------------------------------------------

def test_dispatch_chip_fault_is_lossless_and_replaces_tenants():
    s, store, driver, _ = _fleet(
        [0, 1, 2, 3],
        {"inter": [0, 3], "std": [3], "bulk": [1]},
        [("inter", SLO_INTERACTIVE), ("std", SLO_STANDARD),
         ("bulk", SLO_BULK)])
    gen0 = store.generation
    std_gen = s.registry.current("std").generation
    inter_gen = s.registry.current("inter").generation
    feats = _feats()
    futures = []
    for i in range(4):
        futures.append(s.submit("inter", feats.slice(4 * i, 4 * i + 4)))
        futures.append(s.submit("std", feats.slice(32 + 4 * i,
                                                   36 + 4 * i)))
    with FaultPlan().inject(DISPATCH_SCOPE, at=0, kind="chip_down"):
        _drain(s)
    for fut in futures:
        assert fut.result(timeout=0).num_rows == 4
    assert len(driver.reports) == 1
    rep = driver.reports[0]
    assert rep.dead_chips == (3,)
    assert rep.cause == "dispatch"
    assert rep.requeued > 0
    assert rep.conflicts == 0
    assert set(rep.replicated) == {"inter"}
    assert set(rep.moved) == {"std"}
    pmap = store.current()
    assert pmap.generation == gen0 + 1 == rep.generation
    assert set(pmap.chips_for("inter")) == {0}
    assert 3 not in pmap.chips_for("std")
    assert len(pmap.chips_for("std")) == 1
    assert s.registry.current("std").generation == std_gen + 1
    assert s.registry.current("inter").generation == inter_gen
    assert driver.brownout_level == 1 and s.brownout_level == 1
    assert s.snapshot()["placement_generation"] == pmap.generation
    with pytest.raises(ServingOverloadedError, match="brownout"):
        s.submit("bulk", feats.take(4))
    fut = s.submit("inter", feats.take(4))
    _drain(s)
    assert fut.result(timeout=0).num_rows == 4


def test_brownout_ladder_raises_immediately_lowers_with_hysteresis():
    s, store, driver, clock = _fleet(
        [0, 1, 2, 3], {"inter": [0], "std": [1], "bulk": [2]},
        [("inter", SLO_INTERACTIVE), ("std", SLO_STANDARD),
         ("bulk", SLO_BULK)],
        hysteresis_s=30.0)
    feats = _feats()
    assert driver.brownout_level == 0
    fut = s.submit("bulk", feats.take(4))
    _drain(s)
    assert fut.result(timeout=0).num_rows == 4
    driver.health.fail(3)
    driver.tick()
    assert driver.brownout_level == 1
    with pytest.raises(ServingOverloadedError):
        s.submit("bulk", feats.take(4))
    fut = s.submit("std", feats.take(4))
    _drain(s)
    assert fut.result(timeout=0).num_rows == 4
    driver.health.fail(2)
    driver.tick()
    assert driver.brownout_level == 2
    with pytest.raises(ServingOverloadedError):
        s.submit("std", feats.take(4))
    fut = s.submit("inter", feats.take(4))
    _drain(s)
    assert fut.result(timeout=0).num_rows == 4
    driver.health.recover(2)
    driver.health.recover(3)
    driver.tick()
    assert driver.brownout_level == 2
    clock.advance(30.0)
    driver.tick()
    assert driver.brownout_level == 0 and s.brownout_level == 0
    assert s.health == HEALTH_SERVING
    assert s.shed_counts() == {SLO_INTERACTIVE: 0, SLO_STANDARD: 1,
                               SLO_BULK: 1}


def test_set_brownout_clamps_to_protect_the_top_class():
    s = _stub_scheduler()
    assert s.set_brownout(99) == len(SLO_CLASSES) - 1
    assert s.set_brownout(-5) == 0
    assert s.brownout_level == 0


def test_driver_validates_brownout_rungs():
    s = _stub_scheduler()
    store = PlacementStore(2)
    store.publish({}, 0)
    with pytest.raises(ValueError, match="non-decreasing"):
        FailoverDriver(s, store, chips=[0, 1],
                       brownout_deficits=(0.5, 0.25))
    with pytest.raises(ValueError, match="rungs"):
        FailoverDriver(s, store, chips=[0, 1],
                       brownout_deficits=(0.1, 0.2, 0.3))
    with pytest.raises(ValueError, match="hysteresis"):
        FailoverDriver(s, store, chips=[0, 1], hysteresis_s=-1.0)


# -- deadline-aware requeue --------------------------------------------------

def test_requeue_within_deadline_is_lossless():
    s = _stub_scheduler(max_batch_rows=8, max_wait_ms=0.0,
                        request_deadline_ms=10_000.0)
    feats = _feats()
    s.add_tenant("t", object(), feats.take(2), slo=SLO_INTERACTIVE)
    fut = s.submit("t", feats.take(4))
    formed = s._next_batch(timeout=0.0)
    assert formed is not None
    assert s._requeue(formed[1]) == 1
    assert s.tenant("t").metrics.requeued.value == 1
    _drain(s)
    out = fut.result(timeout=0)
    assert np.array_equal(out["features"], feats.take(4)["features"])


def test_requeue_past_deadline_sheds_with_fatal_error():
    s = _stub_scheduler(max_batch_rows=8, max_wait_ms=0.0,
                        request_deadline_ms=1.0)
    feats = _feats()
    s.add_tenant("t", object(), feats.take(2), slo=SLO_INTERACTIVE)
    fut = s.submit("t", feats.take(4))
    formed = s._next_batch(timeout=0.0)
    time.sleep(0.01)
    assert s._requeue(formed[1]) == 0
    with pytest.raises(DeadlineExceededError) as ei:
        fut.result(timeout=0)
    assert default_classify(ei.value) is False
    assert isinstance(ei.value, TimeoutError)
    assert s._deadline_shed.value == 1
    assert s.shed_counts()[SLO_INTERACTIVE] == 1
    assert _drain(s) == 0


def test_scheduler_validates_request_deadline():
    with pytest.raises(ValueError):
        _stub_scheduler(request_deadline_ms=0.0)


def test_deadline_exceeded_outranks_timeout_retryability():
    assert default_classify(TimeoutError("transient")) is True
    assert default_classify(DeadlineExceededError("past SLO")) is False

    class ForeignDeadline(Exception):
        deadline_exceeded = True

    assert default_classify(ForeignDeadline()) is False


def test_retry_policy_never_resurrects_a_dead_deadline():
    policy = RetryPolicy(max_attempts=5, sleep=lambda s: None)
    calls = []

    def fn():
        calls.append(1)
        raise DeadlineExceededError("answer is worthless now")

    with pytest.raises(DeadlineExceededError):
        policy.call(fn)
    assert len(calls) == 1
    assert policy.retries == 0 and policy.slept == []


# -- replication -------------------------------------------------------------

def test_replicated_tenant_fails_over_in_one_dispatch():
    s, store, driver, _ = _fleet(
        [0, 1, 2], {"hot": [2], "cold": [0]},
        [("hot", SLO_INTERACTIVE), ("cold", SLO_STANDARD)])
    pmap = driver.ensure_replicas("hot", 2)
    assert set(pmap.chips_for("hot")) == {1, 2}
    gen_after_replicas = store.generation
    assert driver.ensure_replicas("hot", 2) is store.current()
    assert store.generation == gen_after_replicas
    hot_gen = s.registry.current("hot").generation
    rep = driver.on_chip_fault(InjectedChipDown("injected chip death"))
    assert rep is not None
    assert rep.dead_chips == (2,)
    assert rep.replicated == ("hot",) and rep.moved == ()
    assert set(store.current().chips_for("hot")) == {1}
    assert set(store.current().chips_for("cold")) == {0}
    assert s.registry.current("hot").generation == hot_gen


def test_ensure_replicas_validates_count():
    s, store, driver, _ = _fleet(
        [0, 1], {"t": [0]}, [("t", SLO_INTERACTIVE)])
    with pytest.raises(ValueError):
        driver.ensure_replicas("t", 0)


# -- flap thrash bound + restore ---------------------------------------------

def test_flap_costs_one_move_per_stability_window_then_restores():
    clock = FakeClock()
    s, store, driver, _ = _fleet(
        [0, 1, 2], {"a": [2], "b": [0]},
        [("a", SLO_INTERACTIVE), ("b", SLO_STANDARD)],
        clock=clock, hysteresis_s=20.0, flap_recovery_polls=2)
    with FaultPlan().inject(CHIP_SCOPE, at=0, kind="chip_flap"):
        rep = driver.tick()
    assert rep is not None and rep.dead_chips == (2,)
    assert rep.moved == ("a",)
    gen_evict = store.generation
    assert set(store.current().chips_for("a")) == {1}
    assert driver.brownout_level == 1
    assert driver.tick() is None
    assert driver.health.live() == [0, 1, 2]
    assert store.generation == gen_evict
    clock.advance(10.0)
    driver.tick()
    assert store.generation == gen_evict
    assert driver.brownout_level == 1
    clock.advance(10.0)
    driver.tick()
    assert store.generation == gen_evict + 1
    assert set(store.current().chips_for("a")) == {2}
    assert driver.snapshot()["restores"] == 1
    assert driver.brownout_level == 0
    assert driver.snapshot()["evicted_chips_pending_restore"] == 0


# -- observability -----------------------------------------------------------

def test_default_tree_exposes_failover_fleet_view():
    s, store, driver, _ = _fleet(
        [0, 1, 2], {"t": [0]}, [("t", SLO_INTERACTIVE)])
    tree = default_tree(failover=driver, scheduler=s)
    snap = tree.snapshot()
    assert snap["failover"]["chips_live"] == 3
    assert snap["failover"]["chips_down"] == 0
    assert snap["failover"]["brownout_level"] == 0
    assert snap["scheduler"]["brownout_level"] == 0
    driver.on_chip_fault(InjectedChipFlap("injected flap"))
    snap = tree.snapshot()
    assert snap["failover"]["chips_live"] == 2
    assert snap["failover"]["chips_down"] == 1
    assert snap["failover"]["failovers"] == 1
    assert snap["failover"]["chips_lost"] == 1
    assert snap["failover"]["last_failover_wall_s"] >= 0.0
    assert snap["scheduler"]["brownout_level"] == 1
    assert snap["scheduler"]["placement_generation"] == store.generation


# -- the chaos cases (tests/test_faults.py) ----------------------------------

def test_fault_plan_chip_kinds_fire_and_randomize_deterministically():
    plan = (FaultPlan().inject(CHIP_SCOPE, at=0, kind="chip_down")
            .inject(CHIP_SCOPE, at=1, kind="chip_flap"))
    with pytest.raises(InjectedChipDown):
        plan.fire(CHIP_SCOPE)
    with pytest.raises(InjectedChipFlap):
        plan.fire(CHIP_SCOPE)
    assert plan.fires == [(CHIP_SCOPE, 0, "chip_down"),
                          (CHIP_SCOPE, 1, "chip_flap")]

    def deaths(seed, pkg=PKGS["torch"]):
        return pkg.FaultPlan(seed=seed).inject_random(
            CHIP_SCOPE, rate=0.15, horizon=60,
            kind="chip_down").scheduled(CHIP_SCOPE)

    assert deaths(11) == deaths(11) == deaths(11, PKGS["jax"])
    assert deaths(11) != deaths(12)
    assert 0 < len(deaths(11)) < 60
    transients = FaultPlan(seed=11).inject_random(
        CHIP_SCOPE, rate=0.15, horizon=60).scheduled(CHIP_SCOPE)
    assert [i for i, _ in transients] != [i for i, _ in deaths(11)]


def _lr_table(n=64, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(np.int64)
    return T.Table({"features": X, "label": y})


def _fit_lr(seed=0):
    return (T.LogisticRegression(device="cpu").set_max_iter(5)
            .fit(_lr_table(seed=seed)))


def test_chip_death_mid_sweep_drops_nothing_and_answers_bitexact():
    model_rt, model_batch = _fit_lr(seed=0), _fit_lr(seed=1)
    feats = _lr_table(n=96, seed=7).drop("label")
    requests = [feats.slice(8 * i, 8 * i + 8) for i in range(12)]

    def sweep(plan=None):
        s = SharedScheduler(ModelRegistry(device="cpu"), max_batch_rows=16,
                            max_wait_ms=0.0, queue_capacity=4096)
        s.add_tenant("rt", model_rt, feats.take(2), slo=SLO_INTERACTIVE)
        s.add_tenant("batch", model_batch, feats.take(2),
                     slo=SLO_STANDARD)
        store = PlacementStore(2)
        store.publish({"rt": [0], "batch": [1]}, 0)
        driver = FailoverDriver(s, store, chips=[0, 1])
        futures = [s.submit("rt" if i % 2 == 0 else "batch", req)
                   for i, req in enumerate(requests)]
        if plan is None:
            _drain(s)
        else:
            with plan:
                _drain(s)
        return s, store, driver, [f.result(timeout=0) for f in futures]

    _, _, _, ref = sweep()
    plan = FaultPlan(seed=20).inject(DISPATCH_SCOPE, at=1,
                                     kind="chip_down")
    s, store, driver, outs = sweep(plan)
    assert plan.fires == [(DISPATCH_SCOPE, 1, "chip_down")]
    assert len(driver.reports) == 1
    rep = driver.reports[0]
    assert rep.dead_chips == (1,)
    assert rep.cause == "dispatch"
    assert rep.requeued > 0
    assert s._requeued.value == rep.requeued
    assert s._deadline_shed.value == 0
    assert rep.moved == ("batch",)
    assert store.current().chips_for("batch") == (0,)
    assert len(outs) == len(ref) == len(requests)
    for got, want in zip(outs, ref):
        assert got.column_names == want.column_names
        for col in got.column_names:
            np.testing.assert_array_equal(np.asarray(got[col]),
                                          np.asarray(want[col]))


def test_chip_death_between_delta_cut_and_publish_reanchors():
    model = _fit_lr(seed=0)
    feats = _lr_table(seed=5).drop("label")
    s = SharedScheduler(ModelRegistry(device="cpu"), max_batch_rows=32,
                        max_wait_ms=0.0)
    s.add_tenant("t", model, feats.take(2), slo=SLO_INTERACTIVE)
    store = PlacementStore(2)
    store.publish({"t": [1]}, 0)
    driver = FailoverDriver(s, store, chips=[0, 1])
    pub = s.delta_publisher("t")
    enc = DeltaEncoder()
    p0 = params_of_model(model)
    p1 = {"w": (p0["w"] * np.float32(1.25)).astype(np.float32),
          "b": p0["b"]}
    res1 = pub.apply(enc.encode(1, p1, pub.stats))
    enc.ack()
    assert res1.mode == "full"
    gen1 = s.registry.current("t").generation
    assert gen1 == res1.generation
    w2 = p1["w"].copy()
    w2[0] += np.float32(0.5)
    p2 = {"w": w2, "b": p1["b"]}
    update2 = enc.encode(2, p2, pub.stats)
    rep = driver.on_chip_fault(InjectedChipDown("died mid-publish"))
    assert rep is not None and rep.dead_chips == (1,)
    assert rep.moved == ("t",)
    assert store.current().chips_for("t") == (0,)
    gen_readmit = s.registry.current("t").generation
    assert gen_readmit == gen1 + 1
    res2 = pub.apply(update2)
    enc.ack()
    assert res2.mode == "delta"
    assert res2.generation == gen_readmit + 1
    served = params_of_model(s.registry.current("t").servable.model)
    np.testing.assert_array_equal(served["w"], p2["w"])
    np.testing.assert_array_equal(served["b"], p2["b"])
    fut = s.submit("t", feats.take(4))
    _drain(s)
    out = fut.result(timeout=0)
    want = s.registry.current("t").servable.model.transform(feats.take(4))[0]
    np.testing.assert_array_equal(out["rawPrediction"],
                                  want["rawPrediction"])


class RacingStore(PlacementStore):
    """Injects ONE out-of-band publish (the autoscale tick re-deriving the
    learner extent) between a CAS caller's read and its conditional
    publish — the deterministic rendering of the race."""

    raced = 0

    def publish(self, servables, learner_workers, *,
                expected_generation=None):
        if expected_generation is not None and not self.raced:
            self.raced += 1
            cur = self.current()
            PlacementStore.publish(self, dict(cur.servables),
                                   cur.learner_workers + 1)
        return PlacementStore.publish(
            self, servables, learner_workers,
            expected_generation=expected_generation)


def test_autoscale_publish_racing_failover_resolves_in_one_retry():
    s = SharedScheduler(ModelRegistry(device="cpu"), max_batch_rows=32,
                        max_wait_ms=0.0)
    s.add_tenant("x", _fit_lr(seed=0), _lr_table(seed=5).drop(
        "label").take(2), slo=SLO_INTERACTIVE)
    store = RacingStore(3)
    store.publish({"x": [2], "y": [0]}, 0)
    gen0 = store.generation
    driver = FailoverDriver(s, store, chips=[0, 1, 2])
    rep = driver.on_chip_fault(InjectedChipDown("death under the tick"))
    assert rep is not None
    assert store.raced == 1
    assert rep.conflicts == 1 and driver.conflicts == 1
    pmap = store.current()
    assert pmap.generation == gen0 + 2
    assert rep.generation == pmap.generation
    assert pmap.chips_for("x") == (1,)
    assert pmap.chips_for("y") == (0,)
    assert pmap.learner_workers == 1
    assert s.brownout_level == 1


def test_controller_tick_racing_failover_converges_on_the_survivors():
    """A real AutoscaleController tick as the racer: with the fleet-health
    view shared, the tick lays out onto the survivors and the failover's
    one CAS retry lands on its map."""
    from flink_ml_tpu_torch.autoscale import (AutoscaleController,
                                              PolicyConfig)

    clock = FakeClock()
    s = _stub_scheduler(max_batch_rows=8, max_wait_ms=0.0)
    s.add_tenant("x", object(), _feats().take(2), slo=SLO_INTERACTIVE)
    sched = {"tenants.x.slo": "interactive",
             "tenants.x.latency_p99_ms": 500.0}
    tree = TTREE.MetricsTree().register("scheduler", sched)
    store = PlacementStore(4, clock=clock)
    store.publish({"x": [0, 1]}, 2)
    driver = FailoverDriver(s, store, chips=[0, 1], clock=clock)
    controller = AutoscaleController.build(
        tree, store=store, scheduler=s, health=driver.health, clock=clock,
        policy_config=PolicyConfig(p99_target_ms=50.0, total_chips=4))

    real_publish = store.publish
    raced = []

    def racing(servables, learner_workers, *, expected_generation=None):
        if expected_generation is not None and not raced:
            raced.append(None)            # the tick's own publish passes
            raced[0] = controller.tick()
        return real_publish(servables, learner_workers,
                            expected_generation=expected_generation)

    store.publish = racing
    rep = driver.on_chip_fault(InjectedChipDown("death under the tick"))
    assert raced and raced[0].kind == "scale_serving"
    assert rep.conflicts == 1 and rep.dead_chips == (1,)
    pmap = store.current()
    assert pmap.learner_workers == 1           # the tick's edit survives
    assert 1 not in pmap.chips_for("x")         # never back on the corpse
    assert s.snapshot()["placement_generation"] == pmap.generation


# -- both packages, the same schedule -----------------------------------------

def _scenario(pkg, plan_seed, replicate):
    """One seeded failover story through ``pkg``'s scheduler, placement
    store and driver on a fake clock; returns everything the two packages
    must agree on."""
    clock = FakeClock()
    s, store, driver, _ = _fleet(
        [0, 1, 2, 3], {"inter": [3], "std": [2], "bulk": [1, 2]},
        [("inter", SLO_INTERACTIVE), ("std", SLO_STANDARD),
         ("bulk", SLO_BULK)],
        clock=clock, pkg=pkg, hysteresis_s=15.0, flap_recovery_polls=3)
    if replicate:
        driver.ensure_replicas("inter", 2)
    feats = _feats(pkg=pkg)
    log = []
    plan = (pkg.FaultPlan(seed=plan_seed)
            .inject_random(CHIP_SCOPE, rate=0.2, horizon=12,
                           kind="chip_flap")
            .inject(DISPATCH_SCOPE, at=2, kind="chip_down"))
    with plan:
        for tick in range(12):
            shed = []
            for name in ("inter", "std", "bulk"):
                try:
                    s.submit(name, feats.slice(tick, tick + 2))
                except Exception as exc:  # noqa: BLE001 — brownout sheds
                    shed.append((name, type(exc).__name__))
            _drain(s)
            rep = driver.tick()
            log.append((tick, shed, driver.brownout_level,
                        s.brownout_level, store.generation,
                        {k: tuple(v) for k, v in
                         sorted(store.current().servables.items())},
                        None if rep is None else
                        (rep.dead_chips, rep.moved, rep.replicated,
                         rep.generation, rep.cause, rep.conflicts)))
            clock.advance(5.0)
    reports = [(r.dead_chips, r.moved, r.replicated, r.generation,
                r.requeued, r.conflicts, r.cause, r.wall_s)
               for r in driver.reports]
    snap = driver.snapshot()
    snap.pop("last_failover_wall_s", None)
    return dict(log=log, transitions=list(driver.health.transitions),
                reports=reports, shed=s.shed_counts(), snapshot=snap,
                fires=list(plan.fires),
                registry={n: s.registry.current(n).generation
                          for n in ("inter", "std", "bulk")})


@pytest.mark.parametrize("replicate", [False, True])
@pytest.mark.parametrize("seed", [3, 20])
def test_failover_equals_the_jax_package_on_the_same_schedule(seed,
                                                              replicate):
    got = _scenario(PKGS["torch"], seed, replicate)
    want = _scenario(PKGS["jax"], seed, replicate)
    assert got["fires"] == want["fires"]
    assert got["transitions"] == want["transitions"]
    assert got["log"] == want["log"]
    assert got["reports"] == want["reports"]
    assert got["shed"] == want["shed"]
    assert got["registry"] == want["registry"]
    assert got["snapshot"] == want["snapshot"]
    assert any(entry[-1] is not None for entry in got["log"])


def test_lease_expiry_equals_the_jax_package():
    def run(pkg):
        clock = FakeClock()
        h = pkg.FleetHealth([0, 1, 2, 3], lease_timeout_s=4.0, clock=clock)
        out = []
        for step in range(10):
            for chip in (0, 2) if step % 3 else (0,):
                out.append(("hb", chip, h.heartbeat(chip)))
            clock.advance(1.5)
            out.append(("expired", tuple(h.expire())))
            if step == 6:
                out.append(("recover", h.recover(1)))
        return out, h.transitions, h.snapshot()

    assert run(PKGS["torch"]) == run(PKGS["jax"])
