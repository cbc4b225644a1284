"""The port's validated checkpoints against the JAX package's, on the CPU.

Same on-disk layout (``leaves.npz`` + ``structure.json`` under the CRC
manifest and commit marker), so a cut written by either package restores
in the other bit for bit (tolerance 0: the leaves are the bytes written);
torn or flipped newest cuts are quarantined and the previous cut restored,
as in the JAX package's ``tests/test_faults.py:148-243``.
"""

import collections
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flink_ml_tpu.iteration as JI
import flink_ml_tpu_torch.iteration as TI
from flink_ml_tpu.iteration import checkpoint as JC
from flink_ml_tpu_torch.iteration import checkpoint as TC
from flink_ml_tpu_torch.robustness import (
    CorruptStateError,
    FaultPlan,
    InjectedCrash,
    corrupt_file,
    verify_dir,
)

# a namedtuple both packages resolve by this module's path
Pair = collections.namedtuple("Pair", ["w", "b"])


def _state(rng):
    return {"w": rng.normal(size=(5, 3)).astype(np.float32),
            "b": np.float32(rng.normal()),
            "steps": np.int32(7),
            "by_int": {3: [np.arange(4, dtype=np.int64),
                           (np.ones(2, np.float16),)], 1: np.int8(-2)},
            "pair": Pair(np.arange(3.0, dtype=np.float32), np.float32(2.5)),
            "none": None}


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif want is None:
        assert got is None
    else:
        g = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
        w = np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_jax_written_cut_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    state = _state(rng)
    jax_state = dict(state, w=jnp.asarray(state["w"]))
    JC.save_pytree(str(tmp_path / "cut"), jax_state, {"epoch": 3, "x": "y"})
    got, meta = TC.load_pytree(str(tmp_path / "cut"))
    assert meta == {"epoch": 3, "x": "y"}
    _assert_tree_equal(got, state)
    assert isinstance(got["pair"], Pair)


def test_port_written_cut_restores_in_the_jax_package(tmp_path):
    rng = np.random.default_rng(1)
    state = _state(rng)
    port_state = dict(state, w=torch.from_numpy(state["w"]),
                      b=torch.tensor(float(state["b"])))
    TC.save_pytree(str(tmp_path / "cut"), port_state, {"epoch": 4})
    got, meta = JC.load_pytree(str(tmp_path / "cut"))
    assert meta == {"epoch": 4}
    want = dict(state, b=np.asarray(state["b"]))
    _assert_tree_equal(got, want)


def test_jax_class_paths_resolve_to_the_port():
    from flink_ml_tpu_torch.ops.retrieve import FlatPlan

    assert TC._resolve_namedtuple(
        "flink_ml_tpu.ops.retrieve.FlatPlan") is FlatPlan
    assert TC._resolve_namedtuple(f"{__name__}.Pair") is Pair


def test_manager_round_trip_gc_interval_and_async(tmp_path):
    mgr = TI.CheckpointManager(TI.CheckpointConfig(str(tmp_path / "a"),
                                                   max_to_keep=2,
                                                   interval=2))
    assert [e for e in range(6) if mgr.should_save(e)] == [0, 2, 4]
    for e in range(4):
        mgr.save(e, {"w": torch.full((3,), float(e))})
    assert mgr.list_epochs() == [2, 3]
    epoch, state, meta = mgr.latest()
    assert epoch == 3 and meta["epoch"] == 3
    np.testing.assert_array_equal(state["w"], [3.0, 3.0, 3.0])
    amgr = TI.CheckpointManager(TI.CheckpointConfig(str(tmp_path / "b"),
                                                    async_save=True))
    live = {"w": torch.zeros(3)}
    amgr.save_async(0, live, {"k": 1})
    live["w"].add_(5.0)   # the async save copied to the host first
    amgr.wait()
    _, saved, meta = amgr.latest()
    np.testing.assert_array_equal(saved["w"], [0.0, 0.0, 0.0])
    assert meta["k"] == 1


def _save_epochs(mgr, n):
    for e in range(n):
        mgr.save(e, {"w": torch.arange(4.0) * (e + 1), "b": float(e)})


@pytest.mark.parametrize("mode", ["flip", "torn"])
@pytest.mark.parametrize("fname", ["leaves.npz", "structure.json"])
def test_corrupt_newest_cut_quarantined_and_previous_restored(
        tmp_path, mode, fname):
    mgr = TI.CheckpointManager(TI.CheckpointConfig(str(tmp_path),
                                                   max_to_keep=5))
    _save_epochs(mgr, 3)
    corrupt_file(str(tmp_path / "ckpt-00000002" / fname), mode=mode)
    with pytest.raises(CorruptStateError):
        verify_dir(str(tmp_path / "ckpt-00000002"))
    epoch, state, _ = mgr.latest()
    assert epoch == 1
    np.testing.assert_array_equal(state["w"], np.arange(4.0) * 2)
    assert "ckpt-00000002.corrupt" in os.listdir(tmp_path)
    assert mgr.list_epochs() == [0, 1]
    # the JAX package reads the same directory the same way
    assert JC.CheckpointManager(JC.CheckpointConfig(str(tmp_path))
                                ).latest()[0] == 1


def test_legacy_cut_missing_payload_quarantined(tmp_path):
    from flink_ml_tpu_torch.robustness.durability import (COMMIT_MARKER,
                                                          MANIFEST_NAME)

    mgr = TI.CheckpointManager(TI.CheckpointConfig(str(tmp_path),
                                                   max_to_keep=5))
    _save_epochs(mgr, 2)
    newest = tmp_path / "ckpt-00000001"
    os.remove(newest / "leaves.npz")
    for name in (MANIFEST_NAME, COMMIT_MARKER):
        os.remove(newest / name)
    assert mgr.latest()[0] == 0
    assert "ckpt-00000001.corrupt" in os.listdir(tmp_path)


@pytest.mark.parametrize("kind", ["crash", "torn", "enospc"])
def test_checkpoint_write_faults(tmp_path, kind):
    """A crash mid-commit never publishes; a torn write commits a cut the
    restore quarantines; ENOSPC is fatal (not retryable)."""
    from flink_ml_tpu_torch.robustness.retry import default_classify

    mgr = TI.CheckpointManager(TI.CheckpointConfig(str(tmp_path),
                                                   max_to_keep=5))
    _save_epochs(mgr, 2)
    with FaultPlan().inject("checkpoint.write", at=0, kind=kind):
        if kind == "torn":
            mgr.save(2, {"w": torch.zeros(4), "b": 0.0})
        else:
            with pytest.raises((InjectedCrash, OSError)) as ei:
                mgr.save(2, {"w": torch.zeros(4), "b": 0.0})
            assert not default_classify(ei.value)
    assert mgr.latest()[0] == 1


def _counter_ws(pkg, xp):
    def body(state, ws, epoch, data):
        new = state + ws.mask
        keep = new < data
        keep = keep.to(torch.float32) if xp is torch \
            else keep.astype(jnp.float32)
        return pkg.IterationBodyResult(
            (new, pkg.Workset(keep, {"seen": ws.bounds["seen"] + 1})))
    return body


def test_jax_workset_cut_resumes_in_the_port(tmp_path):
    """A hosted workset iteration cut by the JAX package (state and the
    Workset's mask and bounds) resumes in the port and ends where the
    uninterrupted JAX run ends, bit for bit."""
    targets = np.asarray([2.0, 9.0, 3.0, 7.0, 12.0], np.float32)

    def jrun(max_epochs, checkpoint=None):
        return JI.iterate(
            _counter_ws(JI, jnp), jnp.zeros(5), jnp.asarray(targets),
            max_epochs=max_epochs,
            workset=JI.Workset(jnp.ones(5), {"seen": jnp.zeros(5)}),
            config=JI.IterationConfig(mode="hosted"), checkpoint=checkpoint)

    oracle = jrun(50)
    ck = JI.CheckpointConfig(str(tmp_path / "ck"), interval=2)
    jrun(4, ck)   # the JAX package cuts at epochs 2 and 4
    res = TI.iterate(
        _counter_ws(TI, torch), torch.zeros(5), torch.from_numpy(targets),
        max_epochs=50,
        workset=TI.Workset(torch.ones(5), {"seen": torch.zeros(5)}),
        config=TI.IterationConfig(mode="hosted"),
        checkpoint=TI.CheckpointConfig(str(tmp_path / "ck"), interval=2),
        resume=True)
    assert res.num_epochs == oracle.num_epochs == 12
    np.testing.assert_array_equal(res.state.numpy(), np.asarray(oracle.state))
    np.testing.assert_array_equal(res.workset.mask.numpy(),
                                  np.asarray(oracle.workset.mask))
    np.testing.assert_array_equal(res.workset.bounds["seen"].numpy(),
                                  np.asarray(oracle.workset.bounds["seen"]))


class _Cursor:
    """A per-epoch source with the snapshot/restore protocol."""

    def __init__(self, values):
        self.values, self.pos = values, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.pos >= len(self.values):
            raise StopIteration
        self.pos += 1
        return self.values[self.pos - 1]

    def snapshot(self):
        return {"cursor": self.pos}

    def restore(self, snap):
        self.pos = int(snap["cursor"])


@pytest.mark.parametrize("async_save", [False, True])
def test_resume_restores_state_and_stream_cursor(tmp_path, async_save):
    vals = [torch.tensor(float(i) * 0.5) for i in range(10)]

    def run(n, ck=None, resume=False):
        return TI.iterate(lambda acc, e, d: acc * 0.5 + d, torch.zeros(()),
                          TI.PerEpoch(_Cursor(vals)), max_epochs=n,
                          checkpoint=ck, resume=resume)

    oracle = run(10)
    ck = TI.CheckpointConfig(str(tmp_path), interval=3,
                             async_save=async_save)
    run(7, ck)
    res = run(10, ck, resume=True)
    assert res.num_epochs == 10
    assert torch.equal(res.state, oracle.state)


def test_resume_of_terminated_run_does_not_rerun_body(tmp_path):
    calls = []

    def body(x, e):
        calls.append(e)
        return TI.IterationBodyResult(x + 1, termination=e < 2)

    ck = TI.CheckpointConfig(str(tmp_path))
    first = TI.iterate(body, torch.zeros(()), max_epochs=10, checkpoint=ck,
                       config=TI.IterationConfig(mode="hosted"))
    calls.clear()
    again = TI.iterate(body, torch.zeros(()), max_epochs=10, checkpoint=ck,
                       resume=True, config=TI.IterationConfig(mode="hosted"))
    assert calls == [] and again.num_epochs == first.num_epochs == 3
    assert float(again.state) == 3.0


def test_checkpoint_hook_fires_after_durable_cut(tmp_path):
    landed = []

    class Hook(TI.IterationListener):
        def on_checkpoint_saved(self, epoch, ctx):
            landed.append((epoch, sorted(os.listdir(tmp_path))[-1]))

    TI.iterate(lambda x, e: x + 1, torch.zeros(()), max_epochs=4,
               listeners=[Hook()],
               checkpoint=TI.CheckpointConfig(str(tmp_path), interval=2,
                                              async_save=True))
    assert landed == [(1, "ckpt-00000002"), (3, "ckpt-00000004")]


def test_multi_process_save_raises_naming_a10(tmp_path, monkeypatch):
    """The multi-host branches of the JAX package's save: in a process
    group of two ranks, rank 1 writes nothing and waits at the group's
    barrier; rank 0 writes the cut, then meets the barrier; ``THIS_RANK``
    writes with no barrier."""
    barriers = []
    rank = {"r": 1}
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 2)
    monkeypatch.setattr(torch.distributed, "get_rank",
                        lambda group=None: rank["r"])
    monkeypatch.setattr(torch.distributed, "barrier",
                        lambda group=None: barriers.append(
                            os.path.exists(tmp_path / "cut")))
    TC.save_pytree(str(tmp_path / "cut"), {"w": torch.zeros(2)})
    assert not os.path.exists(tmp_path / "cut") and barriers == [False]
    rank["r"] = 0
    TC.save_pytree(str(tmp_path / "cut"), {"w": torch.ones(2)})
    assert barriers == [False, True]
    got, _ = TC.load_pytree(str(tmp_path / "cut"))
    np.testing.assert_array_equal(got["w"], np.ones(2, np.float32))
    rank["r"] = 1
    TC.save_pytree(str(tmp_path / "mine"), {"w": torch.zeros(2)},
                   group=TC.THIS_RANK)
    assert os.path.exists(tmp_path / "mine") and len(barriers) == 2
