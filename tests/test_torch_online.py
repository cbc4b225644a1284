"""The port's online learners against the JAX package's on the same
windows, on the CPU: ``OnlineLogisticRegression`` (streaming FTRL) on
dense, sparse (``SparseVector`` and pair columns) and mixed input, warm
start, L1 sparsity, the version history and interval, and
``OnlineKMeans`` (the decayed mini-batch update, warm start, decay).

Tolerances: the final weights and every emitted version within
``rtol=1e-5, atol=1e-7`` of the JAX package's (f32 sums in another order:
the matrix products and the scatter-add); OnlineKMeans' centroids within
``rtol=1e-5, atol=1e-6``.  Within the port, a fit killed mid-stream and
resumed through a ``WindowLog`` equals the uninterrupted fit bit for bit
(``tests/test_online_logisticregression.py:128-197``), and the versions
and L1 zero pattern equal the JAX package's exactly.  A model the JAX
package saved loads in the port with its ``modelVersion``."""

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu.linalg import Vectors as JVectors
from flink_ml_tpu.models.classification.online_logisticregression import (
    OnlineLogisticRegression as JOLR,
)
from flink_ml_tpu.models.clustering.online_kmeans import (
    OnlineKMeans as JOKM,
    OnlineKMeansModel as JOKMModel,
)
from flink_ml_tpu_torch.data.stream import CountWindows
from flink_ml_tpu_torch.data.wal import WindowLog
from flink_ml_tpu_torch.iteration import CheckpointConfig
from flink_ml_tpu_torch.linalg import Vectors as TVectors

W_TOL = dict(rtol=1e-5, atol=1e-7)
C_TOL = dict(rtol=1e-5, atol=1e-6)


def _tables(cols_list, pkg):
    Table = J.Table if pkg == "jax" else T.Table
    return [Table(dict(c)) for c in cols_list]


def _dense_windows(n=12, b=64, d=4, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(d,))
    out = []
    for _ in range(n):
        X = rng.normal(size=(b, d))
        out.append({"features": X, "label": (X @ w_true > 0).astype(
            np.int64)})
    return out


def _pair_windows(n=10, b=64, d=1 << 10, nnz=6, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = rng.integers(0, d, size=(b, nnz)).astype(np.int32)
        vals = rng.normal(size=(b, nnz)).astype(np.float32)
        out.append({"features_indices": idx, "features_values": vals,
                    "label": (vals[:, 0] > 0).astype(np.float32)})
    return out


def _mixed_windows(n=10, b=64, nd=3, nc=5, d=1 << 9, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        dense = rng.normal(size=(b, nd)).astype(np.float32)
        cat = rng.integers(nd, d, size=(b, nc)).astype(np.int32)
        out.append({"features_dense": dense, "features_indices": cat,
                    "label": (dense[:, 0] > 0).astype(np.float32)})
    return out


def _sparse_vector_windows(n=8, b=32, d=50, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows, y = [], []
        for _ in range(b):
            idx = np.sort(rng.choice(d, size=4, replace=False))
            vals = rng.normal(size=4)
            rows.append((idx, vals))
            y.append(float(vals[0] > 0))
        out.append((rows, np.asarray(y)))
    return out


def _sv_tables(windows, pkg, d=50):
    V = JVectors if pkg == "jax" else TVectors
    Table = J.Table if pkg == "jax" else T.Table
    return [Table({"features": np.array([V.sparse(d, i, v) for i, v in rows],
                                        dtype=object), "label": y})
            for rows, y in windows]


def _lr_pair(configure, j_input, t_input):
    jm = configure(JOLR()).fit(j_input)
    tm = configure(T.OnlineLogisticRegression(device="cpu")).fit(t_input)
    return jm, tm


@pytest.mark.parametrize("layout", ["dense", "pair", "mixed", "vector"])
def test_online_lr_matches_jax(layout):
    """The same windows through both packages: weights, model version and
    every emitted version (interval 3)."""
    if layout == "vector":
        wins = _sparse_vector_windows()
        j_in, t_in = _sv_tables(wins, "jax"), _sv_tables(wins, "port")
    else:
        wins = {"dense": _dense_windows, "pair": _pair_windows,
                "mixed": _mixed_windows}[layout]()
        j_in, t_in = _tables(wins, "jax"), _tables(wins, "port")
    d = {"dense": 0, "pair": 1 << 10, "mixed": 1 << 9, "vector": 0}[layout]

    def configure(est):
        est = est.set_alpha(0.5).set_beta(1.0).set_reg(1e-3) \
            .set_elastic_net(0.5) \
            .set("modelSaveInterval", 3)
        return est.set_num_features(d) if d else est

    jm, tm = _lr_pair(configure, iter(j_in), iter(t_in))
    assert tm.model_version == jm.model_version == len(wins)
    np.testing.assert_allclose(tm._state.coefficients,
                               jm._state.coefficients, **W_TOL)
    assert len(tm.version_history) == len(jm.version_history) \
        == len(wins) // 3
    for a, b in zip(tm.version_history, jm.version_history):
        np.testing.assert_allclose(a.coefficients, b.coefficients, **W_TOL)


def test_online_lr_bounded_table_warm_start_and_transform():
    """A bounded Table windowed by globalBatchSize (100 rows / 32: four
    windows, the last ragged), from warm-start weights."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(100, 3))
    cols = {"features": X, "label": (X[:, 0] > 0).astype(np.int64)}
    w0 = np.array([0.5, -0.5, 0.25])

    def configure(est):
        return est.set_global_batch_size(32).set_alpha(0.5) \
            .set_initial_model_data(
                (J.Table if isinstance(est, JOLR) else T.Table)(
                    {"coefficients": w0[None, :]}))

    jm, tm = _lr_pair(configure, J.Table(cols), T.Table(cols))
    assert tm.model_version == jm.model_version == 4
    np.testing.assert_allclose(tm._state.coefficients,
                               jm._state.coefficients, **W_TOL)
    got = tm.transform(T.Table({"features": X}))[0]
    want = jm.transform(J.Table({"features": X}))[0]
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=1e-6)


def test_online_lr_l1_sparsity_matches_jax():
    rng = np.random.default_rng(7)
    wins = []
    for _ in range(40):
        X = rng.normal(size=(64, 10))
        wins.append({"features": X, "label": (X[:, 0] > 0).astype(np.int64)})

    def configure(est):
        return est.set_reg(0.2).set_elastic_net(1.0).set_alpha(0.5)

    jm, tm = _lr_pair(configure, iter(_tables(wins, "jax")),
                      iter(_tables(wins, "port")))
    coef = tm._state.coefficients
    np.testing.assert_array_equal(coef == 0, jm._state.coefficients == 0)
    assert np.sum(coef[1:] == 0) >= 5 and abs(coef[0]) > 0.1
    np.testing.assert_allclose(coef, jm._state.coefficients, **W_TOL)


def _lr_est():
    return (T.OnlineLogisticRegression(device="cpu").set_num_features(4)
            .set_global_batch_size(32))


def _lr_windows(lo, hi, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(hi):
        X = rng.normal(size=(32, 4))
        t = T.Table({"features": X, "label": (X[:, 0] > 0).astype(
            np.float64)})
        if i >= lo:
            out.append(t)
    return out


def test_online_lr_kill_and_resume_through_wal_bitexact(tmp_path):
    """A live feed dies handing out window 7; the cuts are at windows 3
    and 6 (interval 3), so the log replays window 6 and windows 7-9 come
    live: the resumed weights equal the uninterrupted fit's bit for bit."""
    windows = _lr_windows(0, 10)
    oracle = _lr_est().fit(iter(windows))

    class Killed(RuntimeError):
        pass

    def killing_feed(wins, die_at):
        for i, w in enumerate(wins):
            if i == die_at:
                raise Killed()
            yield w

    wal = str(tmp_path / "wal")
    ckpt = CheckpointConfig(str(tmp_path / "ckpt"), interval=3)
    with pytest.raises(Killed):
        _lr_est().fit(WindowLog(killing_feed(windows, 7), wal),
                      checkpoint=ckpt)
    resumed = _lr_est().fit(WindowLog(iter(windows[7:]), wal),
                            checkpoint=ckpt, resume=True)
    np.testing.assert_array_equal(resumed._state.coefficients,
                                  oracle._state.coefficients)
    assert resumed.model_version == oracle.model_version == 10
    # the versions emitted after the resume only
    assert len(resumed.version_history) == 4


def test_online_lr_bounded_table_checkpoint_resume(tmp_path):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(320, 4))
    t = T.Table({"features": X, "label": (X[:, 0] > 0).astype(np.float64)})
    oracle = _lr_est().fit(t)
    ckpt = CheckpointConfig(str(tmp_path / "ckpt"), interval=4)
    full = _lr_est().fit(t, checkpoint=ckpt)
    np.testing.assert_array_equal(full._state.coefficients,
                                  oracle._state.coefficients)
    # from the last cut (window 8 of 10): the cursor replays windows 8-9
    resumed = _lr_est().fit(t, checkpoint=ckpt, resume=True)
    np.testing.assert_array_equal(resumed._state.coefficients,
                                  oracle._state.coefficients)


def test_online_lr_errors(tmp_path):
    with pytest.raises(ValueError, match="empty stream"):
        T.OnlineLogisticRegression(device="cpu").fit(iter([]))
    with pytest.raises(ValueError, match="cursor"):
        _lr_est().fit(iter(_lr_windows(0, 3)),
                      checkpoint=CheckpointConfig(str(tmp_path / "a")))
    src = CountWindows(iter(_lr_windows(0, 2)), 32)   # has a cursor
    with pytest.raises(ValueError, match="set_num_features"):
        T.OnlineLogisticRegression(device="cpu").fit(
            src, checkpoint=CheckpointConfig(str(tmp_path / "b")))
    with pytest.raises(ValueError, match="numFeatures"):
        (T.OnlineLogisticRegression(device="cpu").set_num_features(10)
         .fit(iter(_lr_windows(0, 2))))
    with pytest.raises(ValueError, match="numFeatures"):
        T.OnlineLogisticRegression(device="cpu").fit(
            iter(_tables(_pair_windows(n=1), "port")))
    with pytest.raises(Exception):
        T.OnlineLogisticRegression(device="cpu").set_alpha(0.0)


def test_online_lr_jax_saved_model_loads(tmp_path):
    wins = _dense_windows(n=5)
    jm = JOLR().fit(iter(_tables(wins, "jax")))
    path = str(tmp_path / "olr")
    jm.save(path)
    loaded = T.OnlineLogisticRegressionModel.load(path, device="cpu")
    assert isinstance(loaded, T.OnlineLogisticRegressionModel)
    assert loaded.model_version == 0     # the JAX model saves no version
    X = np.random.default_rng(0).normal(size=(16, 4))
    np.testing.assert_array_equal(
        loaded.transform(T.Table({"features": X}))[0]["prediction"],
        jm.transform(J.Table({"features": X}))[0]["prediction"])
    tm = T.OnlineLogisticRegression(device="cpu").fit(
        iter(_tables(wins, "port")))
    tm.save(str(tmp_path / "port"))
    back = T.OnlineLogisticRegressionModel.load(str(tmp_path / "port"),
                                                device="cpu")
    assert back.model_version == 5
    np.testing.assert_array_equal(back._state.coefficients,
                                  tm._state.coefficients)


# ------------------------------------------------------------ OnlineKMeans

def _cluster_windows(n=20, b=128, seed=0, drift=0.0):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [10.0, 10.0]])
    out = []
    for i in range(n):
        assign = rng.integers(0, 2, size=b)
        pts = centers[assign] + rng.normal(scale=0.5, size=(b, 2)) \
            + drift * i
        out.append({"features": pts})
    return out


@pytest.mark.parametrize("decay,warm", [(1.0, False), (0.2, False),
                                        (0.8, True)])
def test_online_kmeans_matches_jax(decay, warm):
    wins = _cluster_windows(drift=0.3)
    init = np.array([[1.0, 1.0], [9.0, 9.0]])

    def configure(est, Table):
        est = est.set_k(2).set_seed(1).set_decay_factor(decay)
        if warm:
            est = est.set_initial_model_data(Table({"centroids": init[None]}))
        return est

    jm = configure(JOKM(), J.Table).fit(iter(_tables(wins, "jax")))
    tm = configure(T.OnlineKMeans(device="cpu"), T.Table).fit(
        iter(_tables(wins, "port")))
    assert tm.model_version == jm.model_version == len(wins)
    np.testing.assert_allclose(
        tm.get_model_data()[0]["centroids"][0],
        np.asarray(jm.get_model_data()[0]["centroids"][0]), **C_TOL)


def test_online_kmeans_bounded_table_windows_match_jax():
    """A bounded Table is windowed by max(k, 256) rows in both."""
    pts = np.random.default_rng(4).normal(size=(700, 3))
    jm = JOKM().set_k(3).set_seed(2).fit(J.Table({"features": pts}))
    tm = T.OnlineKMeans(device="cpu").set_k(3).set_seed(2).fit(
        T.Table({"features": pts}))
    assert tm.model_version == jm.model_version == 3
    np.testing.assert_allclose(
        tm.get_model_data()[0]["centroids"][0],
        np.asarray(jm.get_model_data()[0]["centroids"][0]), **C_TOL)


def _okm_est():
    init = T.Table({"centroids": np.array([[1.0, 1.0], [10.0, 1.0]])[None]})
    return (T.OnlineKMeans(device="cpu").set_k(2).set_decay_factor(0.8)
            .set_initial_model_data(init))


def test_online_kmeans_kill_and_resume_through_wal_bitexact(tmp_path):
    rng = np.random.default_rng(1)
    centers = np.array([[0.0, 0.0], [12.0, 0.0]])
    windows = [T.Table({"features": np.concatenate(
        [c + rng.normal(size=(40, 2)) for c in centers])}) for _ in range(9)]
    oracle = _okm_est().fit(iter(windows))

    class Killed(RuntimeError):
        pass

    def dying(ws, k):
        for i, w in enumerate(ws):
            if i == k:
                raise Killed()
            yield w

    wal = str(tmp_path / "wal")
    ckpt = CheckpointConfig(str(tmp_path / "ckpt"), interval=3)
    with pytest.raises(Killed):
        _okm_est().fit(WindowLog(dying(windows, 7), wal), checkpoint=ckpt)
    resumed = _okm_est().fit(WindowLog(iter(windows[7:]), wal),
                             checkpoint=ckpt, resume=True)
    np.testing.assert_array_equal(resumed.get_model_data()[0]["centroids"],
                                  oracle.get_model_data()[0]["centroids"])
    assert resumed.model_version == oracle.model_version == 9


def test_online_kmeans_errors_and_persistence(tmp_path):
    ckpt = CheckpointConfig(str(tmp_path / "c"))
    t = T.Table({"features": np.zeros((8, 2))})
    with pytest.raises(ValueError, match="set_initial_model_data"):
        T.OnlineKMeans(device="cpu").set_k(2).fit(iter([t]), checkpoint=ckpt)
    with pytest.raises(ValueError, match="cursor"):
        _okm_est().fit(iter([t]), checkpoint=ckpt)
    with pytest.raises(ValueError, match="empty stream"):
        T.OnlineKMeans(device="cpu").fit(iter([]))
    with pytest.raises(ValueError, match="2 centroids but k=3"):
        _okm_est().set_k(3).fit(iter([t]))

    wins = _cluster_windows(n=5)
    jm = JOKM().set_k(2).set_seed(1).fit(iter(_tables(wins, "jax")))
    jm.save(str(tmp_path / "jax"))
    loaded = T.OnlineKMeansModel.load(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, T.OnlineKMeansModel)
    assert loaded.model_version == 5
    pts = T.Table({"features": np.array([[0.1, 0.1], [9.9, 9.8]])})
    np.testing.assert_array_equal(
        loaded.transform(pts)[0]["prediction"],
        jm.transform(J.Table({"features": np.array(
            [[0.1, 0.1], [9.9, 9.8]])}))[0]["prediction"])
    tm = T.OnlineKMeans(device="cpu").set_k(2).set_seed(1).fit(
        iter(_tables(wins, "port")))
    tm.save(str(tmp_path / "port"))
    back = JOKMModel.load(str(tmp_path / "port"))
    assert back.model_version == 5
    np.testing.assert_array_equal(
        np.asarray(back.get_model_data()[0]["centroids"]),
        tm.get_model_data()[0]["centroids"])
