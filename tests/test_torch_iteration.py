"""The port's iteration runtime against the JAX package's, on the CPU.

Each body is written once in ``jnp`` and once in torch and run through
both packages' ``iterate``; states, outputs, epoch counts, traces and
listener calls must agree (exactly: every body here is integer-valued or
a power-of-two scaling in f32, so both packages compute the same bits).
The 4 x 1000 exact-sum anchor is the reference's
``BoundedAllRoundStreamIterationITCase.java:96-101`` (1,998,000 a round).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flink_ml_tpu.iteration as JI
import flink_ml_tpu_torch.iteration as TI
from flink_ml_tpu_torch.robustness import FaultPlan, InjectedCrash

MODES = ("fused", "hosted", "auto")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _both(make_body, init, data=None, **kw):
    """Run ``make_body(xp)`` through both packages: ``xp`` is ``jnp`` for
    the JAX package and ``torch`` for the port; ``init``/``data`` are
    numpy trees converted per package."""
    def conv(tree, to):
        if isinstance(tree, dict):
            return {k: conv(v, to) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(conv(v, to) for v in tree)
        if isinstance(tree, np.ndarray):
            return to(tree)
        return tree

    jcfg = kw.pop("config", None)
    res_j = JI.iterate(make_body(jnp), conv(init, jnp.asarray),
                       conv(data, jnp.asarray),
                       config=JI.IterationConfig(**jcfg) if jcfg else None,
                       **kw)
    res_t = TI.iterate(make_body(torch), conv(init, torch.from_numpy),
                       conv(data, torch.from_numpy),
                       config=TI.IterationConfig(**jcfg) if jcfg else None,
                       **kw)
    return res_j, res_t


def _result(xp):
    return TI.IterationBodyResult if xp is torch else JI.IterationBodyResult


def _anchor_body(xp):
    R = _result(xp)

    def body(state, epoch, d):
        return R(state + 1, outputs=xp.sum(d))
    return body


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("w", [1, 4])
def test_reduce_sum_anchor_exact(mode, w):
    """4 sources x records 0..999, 5 rounds: every round sums to exactly
    1,998,000 in both packages (tolerance 0), hosted at W 1 and 4."""
    records = np.concatenate([np.arange(1000)] * 4).astype(np.float32)
    res_j, res_t = _both(_anchor_body, np.zeros((), np.int32), records,
                         max_epochs=5, steps_per_dispatch=w,
                         config={"mode": mode})
    assert res_t.num_epochs == res_j.num_epochs == 5
    got = [float(o) for o in (res_t.outputs if isinstance(res_t.outputs,
                                                          list)
                              else res_t.outputs)]
    want = [float(o) for o in (res_j.outputs if isinstance(res_j.outputs,
                                                           list)
                               else np.asarray(res_j.outputs))]
    assert got == want == [1998000.0] * 5
    assert int(res_t.state) == int(res_j.state) == 5


def _doubling_vote(xp):
    R = _result(xp)

    def body(x, epoch):
        return R(feedback=x * 2, outputs=x, termination=epoch < 3)
    return body


@pytest.mark.parametrize("mode", MODES)
def test_termination_criteria_matches(mode):
    ctx = (pytest.warns(UserWarning, match="LAST epoch's outputs")
           if mode == "fused" else contextlib.nullcontext())
    with ctx:
        res_j, res_t = _both(_doubling_vote, np.ones((), np.float32),
                             max_epochs=100, config={"mode": mode})
    assert res_t.num_epochs == res_j.num_epochs == 4
    assert float(res_t.state) == float(res_j.state) == 16.0
    if mode == "fused":
        np.testing.assert_array_equal(
            res_t.side["epoch_trace"]["termination"],
            res_j.side["epoch_trace"]["termination"])
        assert np.isnan(res_t.side["epoch_trace"]["active_fraction"]).all()
    else:
        # auto keeps hosted semantics where a vote exists: every output
        assert res_t.side["termination_reason"] == "criteria"
        assert [float(o) for o in res_t.outputs] == \
            [float(o) for o in res_j.outputs] == [1, 2, 4, 8]


def test_zero_feedback_terminates_immediately():
    def make(xp):
        R = _result(xp)
        return lambda x, e: R(x, None, xp.asarray(False) if xp is jnp
                              else torch.tensor(False))
    res_j, res_t = _both(make, np.full((), 7.0, np.float32), max_epochs=10,
                         config={"mode": "hosted"})
    assert res_t.num_epochs == res_j.num_epochs == 1
    assert float(res_t.state) == 7.0


@pytest.mark.parametrize("w", [1, 2, 3])
def test_listeners_fire_like_the_jax_package(w):
    """Per epoch at W = 1, at chunk boundaries (with the last epoch's
    context) at W > 1; on termination once, with the final epoch."""
    logs = {}
    for pkg, xp in ((JI, jnp), (TI, torch)):
        seen, terminated = [], []

        class Recorder(pkg.IterationListener):
            def on_epoch_watermark_incremented(self, epoch, ctx):
                seen.append((epoch, float(ctx.state)))

            def on_iteration_terminated(self, ctx):
                terminated.append(ctx.epoch)

        res = pkg.iterate(lambda x, e: x + 1, xp.zeros(()), max_epochs=5,
                          listeners=[Recorder()], steps_per_dispatch=w)
        logs[pkg.__name__] = (seen, terminated, res.num_epochs)
    assert logs["flink_ml_tpu_torch.iteration"] == \
        logs["flink_ml_tpu.iteration"]
    assert logs["flink_ml_tpu_torch.iteration"][1] == [5]


def test_fn_listener_side_outputs():
    def on_epoch(epoch, ctx):
        ctx.output("epochs", epoch)

    res = TI.iterate(lambda x, e: x + 1, torch.zeros(()), max_epochs=3,
                     listeners=[TI.FnListener(on_epoch=on_epoch)])
    res_j = JI.iterate(lambda x, e: x + 1, jnp.zeros(()), max_epochs=3,
                       listeners=[JI.FnListener(on_epoch=on_epoch)])
    assert res.side["epochs"] == res_j.side["epochs"] == [0, 1, 2]


def test_per_round_lifecycle():
    """PER_ROUND: every epoch starts from the re-initialised state."""
    calls = {}
    for pkg, xp in ((JI, jnp), (TI, torch)):
        seen = calls.setdefault(pkg.__name__, [])

        def body(state, epoch, seen=seen):
            seen.append(float(state))
            return pkg.IterationBodyResult(state + 10, outputs=None)

        res = pkg.iterate(body, xp.zeros(()), max_epochs=3,
                          config=pkg.IterationConfig(
                              lifecycle=pkg.OperatorLifeCycle.PER_ROUND,
                              mode="hosted", jit=False))
        assert float(res.state) == 10.0
    assert calls["flink_ml_tpu_torch.iteration"] == [0.0, 0.0, 0.0]
    assert calls["flink_ml_tpu.iteration"] == [0.0, 0.0, 0.0]


def test_stream_end_terminates():
    out = {}
    for pkg, xp in ((JI, jnp), (TI, torch)):
        batches = iter([xp.ones(4), xp.ones(4) * 2, xp.ones(4) * 3])
        res = pkg.iterate(
            lambda acc, e, d: pkg.IterationBodyResult(acc + d.sum()),
            xp.zeros(()), batches, max_epochs=100,
            config=pkg.IterationConfig(mode="hosted"))
        out[pkg.__name__] = (res.num_epochs, float(res.state),
                             res.side["termination_reason"])
    assert out["flink_ml_tpu_torch.iteration"] == \
        out["flink_ml_tpu.iteration"] == (3, 24.0, "stream_end")


def test_auto_mode_with_criteria_keeps_all_outputs():
    def make(xp):
        R = _result(xp)
        return lambda x, e: R(x + 1, outputs=x, termination=e < 3)
    res_j, res_t = _both(make, np.zeros((), np.float32), max_epochs=10)
    assert len(res_t.outputs) == len(res_j.outputs) == 4


def test_tuple_state_never_unpacked():
    def make(xp):
        return lambda s, e: (s[0] + 1, s[1] * 2)
    res_j, res_t = _both(make, (np.zeros((), np.float32),
                                np.ones((), np.float32)), max_epochs=3,
                         config={"mode": "hosted"})
    assert float(res_t.state[0]) == float(res_j.state[0]) == 3.0
    assert float(res_t.state[1]) == float(res_j.state[1]) == 8.0


def test_mixed_replayed_and_per_epoch_inputs():
    out = {}
    for pkg, xp in ((JI, jnp), (TI, torch)):
        replayed = xp.arange(8, dtype=xp.float32)
        stream = iter([xp.asarray(1.0), xp.asarray(2.0), xp.asarray(3.0)])
        seen = []

        def body(acc, epoch, data, seen=seen):
            seen.append((float(data["train"].sum()), float(data["delta"])))
            return pkg.IterationBodyResult(
                acc + data["train"].sum() * data["delta"])

        res = pkg.iterate(body, xp.zeros(()),
                          {"train": pkg.Replayed(replayed),
                           "delta": pkg.PerEpoch(stream)},
                          max_epochs=100,
                          config=pkg.IterationConfig(mode="hosted",
                                                     jit=False))
        out[pkg.__name__] = (res.num_epochs, seen, float(res.state),
                             res.side["termination_reason"])
    assert out["flink_ml_tpu_torch.iteration"] == out["flink_ml_tpu.iteration"]
    assert out["flink_ml_tpu_torch.iteration"][2] == 28.0 * 6


@pytest.mark.parametrize("mode", ["hosted", "fused"])
def test_per_epoch_callable_and_replayed_markers(mode):
    out = {}
    for pkg, xp in ((JI, jnp), (TI, torch)):
        if mode == "hosted":
            data = {"x": pkg.PerEpoch(lambda epoch: xp.asarray(float(epoch)))}
        else:
            data = {"x": pkg.Replayed(xp.arange(4, dtype=xp.float32))}
        res = pkg.iterate(
            lambda acc, e, d: pkg.IterationBodyResult(acc + d["x"].sum()),
            xp.zeros(()), data, max_epochs=4,
            config=pkg.IterationConfig(mode=mode))
        out[pkg.__name__] = float(res.state)
    assert out["flink_ml_tpu_torch.iteration"] == out["flink_ml_tpu.iteration"]


@pytest.mark.parametrize("mode", ["hosted", "fused"])
def test_mixed_lifecycle_per_round_subtree(mode):
    def make(xp):
        R = _result(xp)

        def body(state, epoch, d):
            round_sum = state["scratch"] + d.sum() + state["carried"]
            return R({"carried": state["carried"] + 1.0,
                      "scratch": round_sum}, outputs=round_sum)
        return body

    init = {"carried": np.zeros((), np.float32),
            "scratch": np.zeros((), np.float32)}
    res_j, res_t = _both(make, init, np.arange(4.0, dtype=np.float32),
                         max_epochs=4, per_round=("scratch",),
                         config={"mode": mode})
    outs = (res_t.outputs if mode == "hosted" else list(res_t.outputs))
    assert [float(o) for o in outs] == [6.0, 7.0, 8.0, 9.0]
    assert float(res_t.state["carried"]) == float(res_j.state["carried"])
    assert float(res_t.state["scratch"]) == float(res_j.state["scratch"]) \
        == 9.0


def test_mixed_lifecycle_validates_keys():
    with pytest.raises(KeyError, match="nope"):
        TI.iterate(lambda s, e: s, {"a": torch.zeros(())}, max_epochs=1,
                   per_round=("nope",))
    with pytest.raises(TypeError, match="dict"):
        TI.iterate(lambda s, e: s, torch.zeros(()), max_epochs=1,
                   per_round=("a",))


def _counter_ws(xp):
    pkg = TI if xp is torch else JI

    def body(state, ws, epoch, data):
        new = state + ws.mask
        keep = (new < data)
        keep = keep.to(torch.float32) if xp is torch \
            else keep.astype(jnp.float32)
        return pkg.IterationBodyResult((new, pkg.Workset(keep, ws.bounds)))
    return body


def _ws(pkg, xp, n, bounds=None):
    return pkg.Workset(xp.ones(n, dtype=xp.float32), bounds)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tol", [0.0, 0.3])
def test_workset_matches_including_trace(mode, tol):
    targets = np.asarray([2.0, 5.0, 3.0, 7.0] if tol == 0.0
                         else [2.0, 5.0, 3.0, 20.0], np.float32)
    res = {}
    for pkg, xp in ((JI, jnp), (TI, torch)):
        r = pkg.iterate(_counter_ws(xp), xp.zeros(4),
                        xp.asarray(targets) if xp is jnp
                        else torch.from_numpy(targets),
                        max_epochs=50, workset=_ws(pkg, xp, 4),
                        workset_tol=tol,
                        config=pkg.IterationConfig(mode=mode))
        res[pkg is TI] = r
    j, t = res[False], res[True]
    assert t.num_epochs == j.num_epochs == (7 if tol == 0.0 else 5)
    np.testing.assert_array_equal(_np(t.state), _np(j.state))
    np.testing.assert_array_equal(_np(t.workset.mask), _np(j.workset.mask))
    for key in ("active_fraction", "termination"):
        np.testing.assert_array_equal(t.side["epoch_trace"][key],
                                      j.side["epoch_trace"][key])


def test_workset_body_vote_ands_with_active_fraction():
    def body(state, ws, epoch, data):
        return TI.IterationBodyResult((state + 1, ws), termination=epoch < 3)

    res = TI.iterate(body, torch.zeros(4), torch.ones(4), max_epochs=50,
                     workset=TI.Workset(torch.ones(4)))
    assert res.num_epochs == 4
    assert float(res.workset.mask.sum()) == 4.0


def test_workset_rejects_per_round_and_wrong_type():
    with pytest.raises(TypeError, match="Workset"):
        TI.iterate(_counter_ws(torch), torch.zeros(2), torch.ones(2),
                   max_epochs=3, workset=torch.ones(2))
    with pytest.raises(ValueError, match="per-round"):
        TI.iterate(_counter_ws(torch), {"a": torch.zeros(2)}, torch.ones(2),
                   max_epochs=3, workset=TI.Workset(torch.ones(2)),
                   per_round=["a"])


def test_invalid_mode_and_fused_static_data_rejected():
    with pytest.raises(ValueError):
        TI.IterationConfig(mode="warp")
    with pytest.raises(ValueError):
        TI.IterationConfig(steps_per_dispatch=0)
    with pytest.raises(ValueError, match="static"):
        TI.iterate(lambda x, e, d: x, torch.zeros(()), iter([1, 2]),
                   max_epochs=2, config=TI.IterationConfig(mode="fused"))


def _noisy_vote(xp):
    """A state that moves by non-trivial f32 steps and votes to stop at
    epoch 6 (so W = 4 stops mid-chunk)."""
    R = _result(xp)

    def body(s, epoch, d):
        new = {"w": s["w"] * 0.75 + d * 0.125, "n": s["n"] + 1}
        return R(new, outputs=new["w"].sum(), termination=epoch < 6)
    return body


@pytest.mark.parametrize("w", [1, 2, 3, 4, 7, 16])
def test_steps_per_dispatch_sweep_bit_exact(w):
    """Any W gives the W = 1 state bit for bit (dead epochs of the last
    chunk are discarded), the same epochs, outputs and chunk-boundary
    listener calls as the JAX package at the same W."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=64).astype(np.float32)
    init = {"w": rng.normal(size=64).astype(np.float32),
            "n": np.zeros((), np.int32)}
    base = TI.iterate(_noisy_vote(torch),
                      {k: torch.from_numpy(v) for k, v in init.items()},
                      torch.from_numpy(d), max_epochs=50,
                      config=TI.IterationConfig(mode="hosted"))
    calls = {}
    res = {}
    for pkg, xp, conv in ((JI, jnp, jnp.asarray), (TI, torch,
                                                   torch.from_numpy)):
        seen = calls.setdefault(pkg.__name__, [])
        res[pkg.__name__] = pkg.iterate(
            _noisy_vote(xp), {k: conv(v) for k, v in init.items()},
            conv(d), max_epochs=50, steps_per_dispatch=w,
            listeners=[pkg.FnListener(
                on_epoch=lambda e, ctx, seen=seen: seen.append(e))],
            config=pkg.IterationConfig(mode="hosted"))
    t, j = res["flink_ml_tpu_torch.iteration"], res["flink_ml_tpu.iteration"]
    assert t.num_epochs == base.num_epochs == j.num_epochs == 7
    assert torch.equal(t.state["w"], base.state["w"])
    assert int(t.state["n"]) == int(j.state["n"]) == 7
    np.testing.assert_allclose(t.state["w"].numpy(), np.asarray(j.state["w"]),
                               rtol=1e-6, atol=1e-7)
    assert len(t.outputs) == len(j.outputs) == 7
    assert calls["flink_ml_tpu_torch.iteration"] == \
        calls["flink_ml_tpu.iteration"]


def test_iterate_epoch_fault_seam():
    """A FaultPlan crash at ``iterate.epoch`` kills the hosted loop at the
    scheduled epoch in both packages."""
    from flink_ml_tpu.robustness import FaultPlan as JFaultPlan
    from flink_ml_tpu.robustness import InjectedCrash as JInjectedCrash

    seen = []
    with FaultPlan().inject("iterate.epoch", at=3, kind="crash"):
        with pytest.raises(InjectedCrash):
            TI.iterate(lambda x, e: seen.append(e) or x + 1, torch.zeros(()),
                       max_epochs=10, config=TI.IterationConfig(mode="hosted"))
    assert seen == [0, 1, 2]
    with JFaultPlan().inject("iterate.epoch", at=3, kind="crash"):
        with pytest.raises(JInjectedCrash):
            JI.iterate(lambda x, e: x + 1, jnp.zeros(()), max_epochs=10,
                       config=JI.IterationConfig(mode="hosted"))
