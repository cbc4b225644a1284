"""The port's write-ahead window log (``flink_ml_tpu_torch.data.wal``)
against the JAX package's ``data/wal.py``: a log either package wrote
replays in the other; the torn tail is truncated and a corrupt window that
is not the tail raises (``tests/test_faults.py:261-295``); transient append
failures retry; a crash at ``source.pull`` heals through ``resilient_fit``
bit for bit (``tests/test_faults.py:547-585``); ``WindowBatchReader``
rides the log's cursor.  Windows are compared bit for bit (tolerance 0)."""

import os

import numpy as np
import pytest
import torch

from flink_ml_tpu.data import wal as JW
from flink_ml_tpu.data.table import Table as JTable
from flink_ml_tpu_torch.data import wal as TW
from flink_ml_tpu_torch.data.table import Table as TTable
from flink_ml_tpu_torch.iteration import (CheckpointConfig,
                                          IterationBodyResult,
                                          IterationConfig, iterate)
from flink_ml_tpu_torch.robustness import (
    CorruptStateError,
    FaultPlan,
    InjectedTransientError,
    RecoveryReport,
    RetryPolicy,
    corrupt_file,
    resilient_fit,
)


def _windows(lo, hi, rows=4, Table=TTable):
    for i in range(lo, hi):
        yield Table({"x": np.full((rows,), float(i), np.float32),
                     "i": np.full((rows,), i, np.int64)})


def _ids(log):
    return [int(t["i"][0]) for t in log]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_log_replays_across_packages(tmp_path, writer):
    """Six windows logged by one package, a cut at 2: the other package
    replays windows 2..5 from the log and then the live source, with the
    same bytes."""
    d = str(tmp_path / "wal")
    W, R = (JW, TW) if writer == "jax" else (TW, JW)
    Tw = JTable if writer == "jax" else TTable
    written = list(W.WindowLog(_windows(0, 6, Table=Tw), d))
    resumed = R.WindowLog(_windows(6, 8), d)
    resumed.restore({"consumed": 2})
    got = list(resumed)
    assert [int(t["i"][0]) for t in got] == [2, 3, 4, 5, 6, 7]
    for a, b in zip(written[2:], got):
        np.testing.assert_array_equal(np.asarray(a["x"]), b["x"])
        assert np.asarray(b["i"]).dtype == np.int64


def test_tee_snapshot_and_truncation(tmp_path):
    d = str(tmp_path / "wal")
    log = TW.WindowLog(_windows(0, 8), d, keep_snapshots=2)
    it = iter(log)
    for k in (2, 4, 6):
        while log._consumed < k:
            next(it)
        assert log.snapshot() == {"consumed": k}
    assert sorted(os.listdir(d)) == [f"win-{i:08d}.npz" for i in (4, 5)]
    ok = TW.WindowLog(_windows(6, 8), d)
    ok.restore({"consumed": 4})
    assert _ids(ok) == [4, 5, 6, 7]
    bad = TW.WindowLog(_windows(6, 8), d)
    bad.restore({"consumed": 2})
    with pytest.raises(ValueError, match="truncation horizon"):
        next(iter(bad))
    with pytest.raises(ValueError, match="keep_snapshots"):
        TW.WindowLog(iter(()), d, keep_snapshots=0)


def test_torn_tail_is_truncated_and_stream_heals(tmp_path):
    d = str(tmp_path / "wal")
    assert len(list(TW.WindowLog(_windows(0, 6), d))) == 6
    corrupt_file(os.path.join(d, "win-00000005.npz"), mode="torn")
    # replays 0..4, drops the torn tail (its consumer never saw it), then
    # continues live
    assert _ids(TW.WindowLog(_windows(5, 8), d)) == list(range(8))


def test_corrupt_non_tail_raises(tmp_path):
    d = str(tmp_path / "wal")
    assert len(list(TW.WindowLog(_windows(0, 6), d))) == 6
    corrupt_file(os.path.join(d, "win-00000002.npz"))
    with pytest.raises(CorruptStateError, match="window 2"):
        list(TW.WindowLog(iter(()), d))


def test_append_retries_transient_then_lands(tmp_path):
    d = str(tmp_path / "wal")
    slept = []
    plan = FaultPlan().inject("wal.append", at=1, kind="transient", times=2)
    log = TW.WindowLog(_windows(0, 4), d, retry_policy=RetryPolicy(
        max_attempts=4, base_delay=0.01, sleep=slept.append))
    with plan:
        assert len(list(log)) == 4
    assert len(slept) == 2
    assert len([f for f in os.listdir(d) if f.endswith(".npz")]) == 4
    plan2 = FaultPlan().inject("wal.append", at=1, kind="transient")
    with plan2:
        with pytest.raises(InjectedTransientError):
            list(TW.WindowLog(_windows(0, 4), str(tmp_path / "wal2")))


def _body(state, epoch, window):
    # order-sensitive: a lost, repeated or reordered window changes it
    x = torch.from_numpy(np.asarray(window["x"], np.float32))
    return IterationBodyResult(state * 0.9 + torch.sum(x) * (epoch + 1))


def test_resilient_iterate_replays_wal_past_cursor_bitexact(tmp_path):
    """A hosted iteration over a live feed crashed at ``source.pull`` 7:
    recovery restores the interval-4 cut and replays the logged windows
    past the cursor; the state equals the uninterrupted run's bit for bit
    (and the JAX package's, whose f32 arithmetic is the same)."""
    import jax.numpy as jnp

    from flink_ml_tpu.iteration import (IterationBodyResult as JBR,
                                        IterationConfig as JConfig,
                                        iterate as jiterate)

    oracle = iterate(_body, torch.tensor(0.0),
                     TW.WindowLog(_windows(0, 12), str(tmp_path / "o")),
                     config=IterationConfig(mode="hosted"))
    assert oracle.num_epochs == 12
    feed = _windows(0, 12)      # ONE generator: consumed windows are gone
    plan = FaultPlan().inject("source.pull", at=7, kind="crash")

    def fit(checkpoint, resume):
        return iterate(_body, torch.tensor(0.0),
                       TW.WindowLog(plan.wrap_source(feed),
                                    str(tmp_path / "chaos")),
                       config=IterationConfig(mode="hosted"),
                       checkpoint=checkpoint, resume=resume)

    report = RecoveryReport()
    with plan:
        result = resilient_fit(
            fit, checkpoint=CheckpointConfig(str(tmp_path / "ck"),
                                             interval=4),
            max_restarts=1, report=report,
            backoff=RetryPolicy(base_delay=0.0, sleep=lambda s: None))
    assert report.restarts == 1 and result.num_epochs == 12
    assert torch.equal(result.state, oracle.state)

    def jbody(state, epoch, window):
        x = jnp.asarray(np.asarray(window["x"], np.float32))
        return JBR(state * 0.9 + jnp.sum(x) * (epoch + 1))

    want = jiterate(jbody, jnp.asarray(0.0),
                    JW.WindowLog(_windows(0, 12, Table=JTable),
                                 str(tmp_path / "j")),
                    config=JConfig(mode="hosted", jit=False))
    np.testing.assert_array_equal(result.state.numpy(), np.asarray(want.state))


def test_window_batch_reader_matches_jax(tmp_path):
    """``seek`` maps a row cursor onto the log's window cursor; a ragged
    window and a seek off the window grid raise; a plain iterable seeks
    forward only."""
    d = str(tmp_path / "wal")
    list(TW.WindowLog(_windows(0, 6, rows=16), d))
    got = {}
    for name, W in (("jax", JW), ("port", TW)):
        reader = W.WindowBatchReader(W.WindowLog(iter(()), d), 16,
                                     max_windows=5)
        with pytest.raises(ValueError, match="window boundaries"):
            reader.seek(17)
        reader.seek(2 * 16)
        got[name] = [b["i"][0] for b in reader]
    assert got["port"] == got["jax"] == [2, 3, 4]

    ragged = TW.WindowBatchReader(TW.WindowLog(iter(
        [TTable({"x": np.zeros(16)}), TTable({"x": np.zeros(7)})]),
        str(tmp_path / "r")), 16)
    it = iter(ragged)
    next(it)
    with pytest.raises(ValueError, match="fixed window grid"):
        next(it)

    plain = TW.WindowBatchReader(list(_windows(0, 4, rows=16)), 16)
    plain.seek(16)
    assert [int(b["i"][0]) for b in plain] == [1, 2, 3]
    with pytest.raises(ValueError, match="rewinds"):
        plain.seek(0)
    with pytest.raises(ValueError, match="batch_rows"):
        TW.WindowBatchReader([], 0)
