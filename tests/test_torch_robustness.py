"""The port's fault injection, retry and supervisor against the JAX
package's, on the CPU.

Seeded schedules, corruption offsets and backoff delays must be identical
in both packages for the same inputs; ``resilient_fit`` must heal an
injected crash and a corrupt newest checkpoint and land bit for bit
(tolerance 0) on the uninterrupted run.
"""

import os

import numpy as np
import pytest
import torch

import flink_ml_tpu.robustness as JR
import flink_ml_tpu_torch.iteration as TI
import flink_ml_tpu_torch.robustness as TR
from flink_ml_tpu_torch.data.datacache import DataCacheReader, DataCacheWriter
from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES


@pytest.mark.parametrize("seed", [0, 5, 7, 123])
@pytest.mark.parametrize("kind", ["transient", "crash", "torn", "preempt"])
def test_seeded_fault_schedules_equal_the_jax_package(seed, kind):
    for scope in ("source.pull", "checkpoint.write", "iterate.epoch"):
        t = TR.FaultPlan(seed=seed).inject_random(scope, rate=0.2,
                                                  horizon=80, kind=kind)
        j = JR.FaultPlan(seed=seed).inject_random(scope, rate=0.2,
                                                  horizon=80, kind=kind)
        assert t.scheduled(scope) == j.scheduled(scope)
    pinned = TR.FaultPlan(seed=7).inject_random("source.pull", rate=0.1,
                                                horizon=100)
    assert pinned.scheduled("source.pull") == [
        (3, "transient"), (57, "transient"), (70, "transient"),
        (71, "transient"), (76, "transient")]


def test_explicit_schedule_fires_in_order_and_wraps_losslessly():
    plan = TR.FaultPlan().inject("s", at=2, kind="transient", times=2)
    plan.inject("s", at=7, kind="crash")
    seen = []
    for i in range(9):
        try:
            plan.fire("s")
        except TR.InjectedTransientError:
            seen.append((i, "transient"))
        except TR.InjectedCrash:
            seen.append((i, "crash"))
    assert seen == [(2, "transient"), (3, "transient"), (7, "crash")]
    src = TR.FaultPlan().inject("source.pull", at=1).wrap_source([10, 11])
    assert next(src) == 10
    with pytest.raises(TR.InjectedTransientError):
        next(src)
    assert next(src) == 11


@pytest.mark.parametrize("mode", ["flip", "torn"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_corrupt_file_damages_the_same_bytes(tmp_path, mode, seed):
    payload = bytes(range(256)) * 9
    paths = []
    for name, fn in (("t", TR.corrupt_file), ("j", JR.corrupt_file)):
        p = str(tmp_path / name)
        open(p, "wb").write(payload)
        fn(p, mode=mode, seed=seed)
        paths.append(open(p, "rb").read())
    assert paths[0] == paths[1] != payload


def test_commit_manifests_validate_across_packages(tmp_path):
    d = tmp_path / "art"
    d.mkdir()
    (d / "a.bin").write_bytes(b"x" * 1000)
    TR.commit_dir(str(d))
    JR.verify_dir(str(d))
    TR.corrupt_file(str(d / "a.bin"), mode="flip")
    with pytest.raises(JR.CorruptStateError):
        JR.verify_dir(str(d))
    with pytest.raises(TR.CorruptStateError):
        TR.verify_dir(str(d))


def test_retry_backoff_schedule_equals_the_jax_package():
    for pkg in (TR, JR):
        slept = []
        p = pkg.RetryPolicy(max_attempts=5, base_delay=0.1, multiplier=2.0,
                            max_delay=0.5, sleep=slept.append)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 5:
                raise pkg.InjectedTransientError("again")
            return "ok"

        assert p.call(flaky) == "ok"
        assert slept == [0.1, 0.2, 0.4, 0.5] and p.retries == 4
    t, j = TR.RetryPolicy(), JR.RetryPolicy()
    assert [t.delay(i) for i in range(8)] == [j.delay(i) for i in range(8)]
    for exc in (ValueError("x"), TR.InjectedCrash("x"), TimeoutError("x"),
                OSError(28, "ENOSPC"), OSError(11, "EAGAIN")):
        assert TR.default_classify(exc) == JR.default_classify(exc)


def test_retry_fatal_fails_fast_and_exhaustion_reraises():
    slept = []
    p = TR.RetryPolicy(max_attempts=3, sleep=slept.append)
    with pytest.raises(ValueError):
        p.call(lambda: (_ for _ in ()).throw(ValueError("bad config")))
    assert slept == []
    with pytest.raises(TR.InjectedTransientError):
        p.call(lambda: (_ for _ in ()).throw(
            TR.InjectedTransientError("always")))
    assert p.attempts == 4 and len(slept) == 2


def test_persist_write_fault_seam(tmp_path):
    """A crash at ``persist.write`` leaves the previous model arrays; a
    torn write is caught at load."""
    from flink_ml_tpu_torch.utils import persist

    persist.save_model_arrays(str(tmp_path), "m", {"w": np.arange(6.0)})
    with TR.FaultPlan().inject("persist.write", at=0, kind="crash"):
        with pytest.raises(TR.InjectedCrash):
            persist.save_model_arrays(str(tmp_path), "m", {"w": np.zeros(6)})
    np.testing.assert_array_equal(
        persist.load_model_arrays(str(tmp_path), "m")["w"], np.arange(6.0))
    with TR.FaultPlan().inject("persist.write", at=0, kind="torn"):
        persist.save_model_arrays(str(tmp_path), "m", {"w": np.ones(600)})
    with pytest.raises(IOError):
        persist.load_model_arrays(str(tmp_path), "m")


def _lr_cache(tmp_path, name, n=1536, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) > 0).astype(np.float32)
    cache = str(tmp_path / name)
    w = DataCacheWriter(cache, segment_rows=512)
    w.append({"features": X, "label": y})
    w.finish()
    return cache


def test_resilient_fit_heals_crash_plus_corrupt_newest_cut(tmp_path):
    """A mid-epoch crash AND a torn newest checkpoint: the bad cut is
    quarantined, the previous one restored, the reader replayed past the
    cursor, and the fit lands bit for bit on the uninterrupted run."""
    cache = _lr_cache(tmp_path, "c1")
    cfg = TS.SGDConfig(learning_rate=0.4, max_epochs=4, tol=0.0)
    kw = dict(num_features=8, config=cfg, cache_decoded=False,
              steps_per_dispatch=2, device="cpu")

    def reader():
        return DataCacheReader(cache, batch_rows=256)

    ref, ref_log = TS.sgd_fit_outofcore(LOSSES["logistic"], reader, **kw)
    plan = (TR.FaultPlan(seed=3)
            .inject("checkpoint.write", at=8, kind="torn")
            .inject("source.pull", at=17, kind="crash"))
    report = TR.RecoveryReport()
    slept = []
    with plan:
        state, log = TR.resilient_fit(
            TS.sgd_fit_outofcore, LOSSES["logistic"],
            lambda: plan.wrap_source(reader()),
            checkpoint=TI.CheckpointConfig(str(tmp_path / "ck"),
                                           max_to_keep=4),
            checkpoint_every_steps=2, max_restarts=2,
            backoff=TR.RetryPolicy(base_delay=0.01, sleep=slept.append),
            report=report, **kw)
    assert sorted(f[0] for f in plan.fires) == ["checkpoint.write",
                                                "source.pull"]
    assert report.restarts == 1 and report.recovered and slept == [0.01]
    assert report.events[0].mttr_s is not None
    assert any(n.endswith(".corrupt") for n in os.listdir(tmp_path / "ck"))
    np.testing.assert_array_equal(state.coefficients, ref.coefficients)
    assert state.intercept == ref.intercept
    np.testing.assert_array_equal(log, ref_log)
    assert report.as_dict()["restarts"] == 1


def test_outofcore_reader_retry_heals_transient_exactly(tmp_path):
    cache = _lr_cache(tmp_path, "cretry")
    cfg = TS.SGDConfig(learning_rate=0.4, max_epochs=3, tol=0.0)
    kw = dict(num_features=8, config=cfg, cache_decoded=False, device="cpu")

    def reader():
        return DataCacheReader(cache, batch_rows=256)

    ref, ref_log = TS.sgd_fit_outofcore(LOSSES["logistic"], reader, **kw)
    plan = TR.FaultPlan().inject("source.pull", at=9, kind="transient",
                                 times=2)
    slept = []
    state, log = TS.sgd_fit_outofcore(
        LOSSES["logistic"], lambda: plan.wrap_source(reader()),
        retry_policy=TR.RetryPolicy(max_attempts=4, base_delay=0.01,
                                    sleep=slept.append), **kw)
    assert len(slept) == 2
    np.testing.assert_array_equal(state.coefficients, ref.coefficients)
    np.testing.assert_array_equal(log, ref_log)
    plan2 = TR.FaultPlan().inject("source.pull", at=9, kind="transient")
    with pytest.raises(TR.InjectedTransientError):
        TS.sgd_fit_outofcore(LOSSES["logistic"],
                             lambda: plan2.wrap_source(reader()), **kw)


def test_resilient_fit_gives_up_and_does_not_retry_logic_errors(tmp_path):
    calls = {"n": 0}

    def crashing(checkpoint, resume):
        calls["n"] += 1
        raise TR.InjectedCrash("boom")

    report = TR.RecoveryReport()
    with pytest.raises(TR.InjectedCrash):
        TR.resilient_fit(crashing,
                         checkpoint=TI.CheckpointConfig(str(tmp_path / "a")),
                         max_restarts=2, report=report,
                         backoff=TR.RetryPolicy(sleep=lambda s: None))
    assert report.restarts == 2 and calls["n"] == 3

    def buggy(checkpoint, resume):
        calls["n"] += 1
        raise ValueError("deterministic logic bug")

    calls["n"] = 0
    with pytest.raises(ValueError):
        TR.resilient_fit(buggy,
                         checkpoint=TI.CheckpointConfig(str(tmp_path / "b")),
                         max_restarts=3,
                         backoff=TR.RetryPolicy(sleep=lambda s: None))
    assert calls["n"] == 1
    with pytest.raises(TypeError, match="CheckpointConfig"):
        TR.resilient_fit(buggy, checkpoint=None)
    # under an elastic fleet too: one attempt, and the fleet stays put
    # (a logic error is not a dead worker)
    from flink_ml_tpu_torch.parallel.elastic import ElasticCoordinator

    def buggy_fleet(checkpoint, resume, membership, mesh):
        return buggy(checkpoint, resume)

    calls["n"] = 0
    fleet = ElasticCoordinator(devices=[0, 1], initial_workers=2)
    with pytest.raises(ValueError, match="logic bug"):
        TR.resilient_fit(buggy_fleet, checkpoint=TI.CheckpointConfig(
            str(tmp_path / "c")), elastic=fleet, max_restarts=3,
            backoff=TR.RetryPolicy(sleep=lambda s: None))
    assert calls["n"] == 1 and fleet.fleet_size == 2


def test_resilient_fit_time_to_recover_uses_injected_clock(tmp_path):
    ticks = {"t": 0.0}

    def fake_clock():
        ticks["t"] += 1.0
        return ticks["t"]

    mgr = TI.CheckpointManager(TI.CheckpointConfig(str(tmp_path)))
    mgr.save(0, {"w": torch.zeros(2)})
    calls = {"n": 0}

    def fit(checkpoint, resume):
        calls["n"] += 1
        if calls["n"] == 1:
            raise TR.InjectedCrash("boom")
        checkpoint.latest()
        return "ok"

    report = TR.RecoveryReport()
    assert TR.resilient_fit(fit, checkpoint=mgr, max_restarts=1,
                            backoff=TR.RetryPolicy(sleep=lambda s: None),
                            report=report, clock=fake_clock) == "ok"
    [event] = report.events
    assert 0 < event.mttr_s < 10 and event.restored_step == 0


@pytest.mark.parametrize("w", [1, 4])
def test_anchor_iteration_heals_a_crash_bit_for_bit(tmp_path, w):
    """The BASELINE anchor under failover: 4 x 1000 records, 5 rounds, a
    crash injected at epoch 3 of a checkpointed hosted iteration (at W = 4
    the seam fires once a chunk: the second chunk); every round still
    sums to 1,998,000 and the final state equals the uninterrupted
    run's."""
    data = torch.from_numpy(np.concatenate([np.arange(1000)] * 4)
                            .astype(np.float32))
    sums = []

    class Sums(TI.IterationListener):
        def on_epoch_watermark_incremented(self, epoch, ctx):
            sums.append(float(ctx.outputs))

    def body(state, epoch, d):
        s = d.sum()
        return TI.IterationBodyResult(
            {"rounds": state["rounds"] + 1, "acc": state["acc"] * 0.5 + s},
            outputs=s)

    def run(checkpoint=None, resume=False):
        return TI.iterate(
            body, {"rounds": torch.zeros((), dtype=torch.int64),
                   "acc": torch.zeros(())}, data, max_epochs=5,
            steps_per_dispatch=w, listeners=[Sums()],
            config=TI.IterationConfig(mode="hosted"),
            checkpoint=checkpoint, resume=resume)

    oracle = run()
    assert sums == [1998000.0] * (5 if w == 1 else 2)
    sums.clear()
    report = TR.RecoveryReport()
    with TR.FaultPlan().inject("iterate.epoch", at=3 if w == 1 else 1,
                               kind="crash"):
        res = TR.resilient_fit(
            run, checkpoint=TI.CheckpointConfig(str(tmp_path), interval=1),
            max_restarts=1, report=report,
            backoff=TR.RetryPolicy(sleep=lambda s: None))
    assert report.restarts == 1
    assert set(sums) == {1998000.0}
    assert res.num_epochs == 5 and int(res.state["rounds"]) == 5
    assert torch.equal(res.state["acc"], oracle.state["acc"])
