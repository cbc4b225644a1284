"""The port's stream windows (``flink_ml_tpu_torch.data.stream``) against
the JAX package's ``data/stream.py`` (``tests/test_stream.py:18-156``): the
same sources give the same windows, watermark closes, late drops and
snapshot/restore skips in both.  Windows are host tables, compared bit for
bit (tolerance 0)."""

import numpy as np
import pytest

from flink_ml_tpu.data import stream as JS
from flink_ml_tpu.data.table import Table as JTable
from flink_ml_tpu_torch.data import stream as TS
from flink_ml_tpu_torch.data.table import Table as TTable


def _cols(n, start=0):
    return {"x": np.arange(start, start + n, dtype=np.float64)}


def _timed(ts, vals=None):
    ts = np.asarray(ts, np.float64)
    return {"ts": ts, "v": np.asarray(vals if vals is not None else ts)}


def _both(make):
    """``make(pkg, Table)`` run for the JAX package and the port: the
    windows of each as lists of column dicts."""
    out = []
    for pkg, table in ((JS, JTable), (TS, TTable)):
        out.append([{c: np.asarray(w[c]) for c in w.column_names}
                    for w in make(pkg, table)])
    return out


def _assert_same(jax_windows, port_windows):
    assert len(jax_windows) == len(port_windows)
    for a, b in zip(jax_windows, port_windows):
        assert sorted(a) == sorted(b)
        for c in a:
            np.testing.assert_array_equal(a[c], b[c])


@pytest.mark.parametrize("case", ["table", "feed", "table_restore",
                                  "feed_restore"])
def test_count_windows_match_jax(case):
    def make(pkg, Table):
        if case == "table":
            return list(pkg.CountWindows(Table(_cols(10)), 4))
        if case == "feed":
            feed = [Table(_cols(3, 0)), Table(_cols(5, 3)),
                    Table(_cols(2, 8))]
            return list(pkg.CountWindows(iter(feed), 4))

        def source():
            if case == "table_restore":
                return Table(_cols(10))
            return (Table(_cols(4, s)) for s in (0, 4, 8))

        src = pkg.CountWindows(source(), 4)
        it = iter(src)
        next(it)
        if case == "feed_restore":
            next(it)
        snap = src.snapshot()
        fresh = pkg.CountWindows(source(), 4)
        fresh.restore(snap)
        return list(fresh)

    jw, tw = _both(make)
    _assert_same(jw, tw)
    if case == "table":
        assert [len(w["x"]) for w in tw] == [4, 4, 2]
    if case == "feed_restore":
        np.testing.assert_array_equal(tw[0]["x"], [8, 9, 10, 11])


def test_count_windows_snapshot_and_validation():
    src = TS.CountWindows(TTable(_cols(10)), 4)
    next(iter(src))
    assert src.snapshot() == {"cursor": 4}
    with pytest.raises(ValueError, match="out of range"):
        TS.CountWindows(TTable(_cols(10)), 4).restore({"cursor": 11})
    with pytest.raises(ValueError, match="positive"):
        TS.CountWindows(TTable(_cols(4)), 0)


@pytest.mark.parametrize("stream,lateness", [
    ([[1, 5, 3], [12, 8], [25]], 0.0),      # closes on the watermark
    ([[1, 11], [2, 13]], 0.0),              # a late row dropped
    ([[1, 11], [2, 13]], 20.0),             # allowed lateness keeps it
    ([[1, 15], [12]], 0.0),                 # out of order, window open
])
def test_event_time_windows_match_jax(stream, lateness):
    jw, tw = _both(lambda pkg, Table: list(pkg.EventTimeWindows(
        [Table(_timed(s)) for s in stream], "ts", 10.0,
        allowed_lateness=lateness)))
    _assert_same(jw, tw)
    got = np.concatenate([w["ts"] for w in tw])
    if stream[0] == [1, 11]:
        assert (2.0 in got) == (lateness > 0)


def test_event_time_snapshot_restore_matches_jax():
    def make(pkg, Table):
        def stream():
            return [Table(_timed([1, 5])), Table(_timed([12])),
                    Table(_timed([25]))]

        src = pkg.EventTimeWindows(stream(), "ts", 10.0)
        next(iter(src))
        snap = src.snapshot()
        fresh = pkg.EventTimeWindows(stream(), "ts", 10.0)
        fresh.restore(snap)
        return list(fresh)

    jw, tw = _both(make)
    _assert_same(jw, tw)
    assert len(tw) == 2


def test_windows_of_and_cursor_source_match_jax():
    def make(pkg, Table):
        out = list(pkg.windows_of(Table(_cols(5)), 2))
        out += list(pkg.windows_of(iter([Table(_cols(3)),
                                         Table(_cols(5))]), 2))
        out += list(pkg.windows_of(pkg.CountWindows(Table(_cols(5)), 4),
                                   999))
        return out

    jw, tw = _both(make)
    _assert_same(jw, tw)
    assert [len(w["x"]) for w in tw] == [2, 2, 1, 3, 5, 4, 1]
    wrapped = TS.ensure_cursor_source(TTable(_cols(5)), 2)
    assert isinstance(wrapped, TS.CountWindows)
    with pytest.raises(ValueError, match="cursor"):
        TS.ensure_cursor_source(iter([TTable(_cols(5))]), 2)


def test_cursor_adapter_delegates_the_cursor():
    src = TS.CountWindows(TTable(_cols(6)), 2)
    adapter = TS.cursor_adapter(src, lambda: (w.num_rows for w in src))
    assert list(adapter) == [2, 2, 2]
    assert adapter.snapshot() == {"cursor": 6}
    adapter.restore({"cursor": 2})
    assert list(adapter) == [2, 2]
    bare = TS.cursor_adapter(iter(()), lambda: iter(()))
    assert not hasattr(bare, "snapshot")


def test_online_estimator_consumes_event_time_windows():
    """A time-windowed stream feeds an online estimator directly in both
    packages: three closed windows, three versions, equal weights."""
    from flink_ml_tpu.models.classification.online_logisticregression \
        import OnlineLogisticRegression as JOLR

    from flink_ml_tpu_torch import OnlineLogisticRegression as TOLR

    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    ts = np.arange(300, dtype=np.float64)

    def stream(pkg, Table):
        return pkg.EventTimeWindows(
            [Table({"features": X[i:i + 50], "label": y[i:i + 50],
                    "ts": ts[i:i + 50]}) for i in range(0, 300, 50)],
            "ts", 100.0)

    jm = JOLR().fit(stream(JS, JTable))
    tm = TOLR(device="cpu").fit(stream(TS, TTable))
    assert tm.model_version == jm.model_version == 3
    np.testing.assert_allclose(tm._state.coefficients,
                               jm._state.coefficients, rtol=1e-5, atol=1e-7)
