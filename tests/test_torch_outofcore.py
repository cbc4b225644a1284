"""The port's out-of-core path against the JAX package's, on the CPU: the
data cache, the decoded replay cache, the prefetch pipeline, the streamed
LR fit (``sgd_fit_outofcore``) on the dense, sparse and mixed layouts and
``fit_outofcore`` over a Criteo TSV reader.

Tolerances: data caches, block orders and fingerprints are compared bit
for bit (tolerance 0).  Streamed fits against the JAX package on the same
``DataCacheReader`` (its mesh pinned to one device) agree within
``atol=1e-5`` on the coefficients and ``rtol=1e-6`` on the loss log
(``tests/test_outofcore.py:298-343``'s tolerances: f32 summation order
only).  Within the port, the W sweep, cached vs uncached epochs and a
killed-and-resumed fit are bit for bit.  The host build of the sample
routing (``scripts/routing_build_times.py``, the yardstick for the card's)
equals ``sample_routing`` array for array.
"""

import importlib.util
import os
import threading

import jax
import numpy as np
import pytest
import torch

from flink_ml_tpu.data import datacache as JD
from flink_ml_tpu.data import replay_cache as JRC
from flink_ml_tpu.models.common import sgd as JS
from flink_ml_tpu.models.common.losses import logistic_loss as j_logistic
from flink_ml_tpu.parallel.mesh import device_mesh
from flink_ml_tpu_torch.data import datacache as TD
from flink_ml_tpu_torch.data import replay_cache as TRC
from flink_ml_tpu_torch.data.prefetch import (
    PrefetchStats,
    masked_chunk_scan,
    prefetch_to_device,
)
from flink_ml_tpu_torch.iteration import CheckpointConfig
from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES
from flink_ml_tpu_torch.obs import StepProbe
from flink_ml_tpu_torch.ops import ell_scatter as E
from flink_ml_tpu_torch.robustness import (
    FaultPlan,
    InjectedTransientError,
    RecoveryReport,
    RetryPolicy,
    resilient_fit,
)

COEF_ATOL = 1e-5
LOSS_RTOL = 1e-6
D_MIXED = 128 * 128

_spec = importlib.util.spec_from_file_location(
    "routing_build_times",
    os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                 "routing_build_times.py"))
routing_build_times = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(routing_build_times)


def _mesh1():
    return device_mesh({"data": 1}, devices=jax.devices()[:1])


# ------------------------------------------------------------ data cache

def _cols(rng, n):
    return {"x": rng.normal(size=(n, 5)).astype(np.float32),
            "i": rng.integers(0, 1 << 20, size=(n, 3)).astype(np.int32),
            "label": rng.integers(0, 2, size=n).astype(np.float32)}


def _batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


@pytest.fixture(params=["native", "numpy"])
def io_path(request, monkeypatch):
    if request.param == "numpy":
        for mod in (TD, JD):
            monkeypatch.setattr(mod, "_native_lib", lambda: None)
    elif TD._native_lib() is None or JD._native_lib() is None:
        pytest.skip("the native datacache library could not be built here")
    return request.param


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("workers", [1, 3])
def test_cache_reads_batch_for_batch_across_packages(tmp_path, io_path,
                                                     writer, workers):
    rng = np.random.default_rng(0)
    W, R = (JD, TD) if writer == "jax" else (TD, JD)
    w = W.DataCacheWriter(str(tmp_path / "c"), segment_rows=300,
                          workers=workers)
    for n in (250, 400, 77):
        w.append(_cols(rng, n))
    w.finish()
    for batch_rows in (64, 300, 1000):
        got = list(R.DataCacheReader(str(tmp_path / "c"),
                                     batch_rows=batch_rows))
        want = list(W.DataCacheReader(str(tmp_path / "c"),
                                      batch_rows=batch_rows))
        _batches_equal(got, want)
    r = R.DataCacheReader(str(tmp_path / "c"), batch_rows=100, cursor=200)
    assert r.snapshot() == {"cursor": 200}
    first = r.read_batch()
    np.testing.assert_array_equal(first["x"], want[0]["x"][200:300])


def test_native_and_numpy_paths_agree(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    cols = _cols(rng, 700)
    out = {}
    for name in ("native", "numpy"):
        if name == "numpy":
            monkeypatch.setattr(TD, "_native_lib", lambda: None)
        elif TD._native_lib() is None:
            pytest.skip("the native datacache library could not be built")
        w = TD.DataCacheWriter(str(tmp_path / name), segment_rows=256)
        w.append(cols)
        w.finish()
        out[name] = list(TD.DataCacheReader(str(tmp_path / name),
                                            batch_rows=100))
    _batches_equal(out["native"], out["numpy"])


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (11, 3)])
def test_shuffled_reader_block_order_equals_the_jax_package(tmp_path, seed,
                                                            epoch):
    rng = np.random.default_rng(2)
    w = TD.DataCacheWriter(str(tmp_path / "c"), segment_rows=256)
    w.append(_cols(rng, 1000))
    w.finish()
    t = TD.ShuffledCacheReader(str(tmp_path / "c"), batch_rows=64,
                               seed=seed, epoch=epoch)
    j = JD.ShuffledCacheReader(str(tmp_path / "c"), batch_rows=64,
                               seed=seed, epoch=epoch)
    assert t.block_order == j.block_order
    _batches_equal(list(t), list(j))
    t.seek(128)
    assert t.cursor == 128
    with pytest.raises(ValueError, match="visit boundary"):
        t.seek(100)


def test_snapshot_embeds_and_recovers(tmp_path):
    rng = np.random.default_rng(3)
    w = TD.DataCacheWriter(str(tmp_path / "c"), segment_rows=128)
    w.append(_cols(rng, 300))
    segs = w.finish()
    TD.DataCacheSnapshot.write(segs, str(tmp_path / "snap"), embed=True,
                               cursor=64)
    restored, cursor = TD.DataCacheSnapshot.recover(
        str(tmp_path / "snap"), str(tmp_path / "restored"))
    assert cursor == 64
    _batches_equal(list(TD.DataCacheReader(restored, batch_rows=50)),
                   list(TD.DataCacheReader(str(tmp_path / "c"),
                                           batch_rows=50)))
    with pytest.raises(ValueError, match="fresh directory"):
        TD.DataCacheWriter(str(tmp_path / "c"))


def test_replay_cache_and_fingerprints_match_the_jax_package():
    rng = np.random.default_rng(4)
    batch = _cols(rng, 32)
    assert TRC.batch_fingerprint(batch) == JRC.batch_fingerprint(batch)
    assert TRC.batch_fingerprint([batch["x"]]) == \
        JRC.batch_fingerprint([batch["x"]])
    item = (np.zeros(10, np.float32), np.ones(6, np.int32))
    for pkg in (TRC, JRC):
        c = pkg.DecodedReplayCache(3 * 64)
        for i in (0, 2, 1, 3):
            c.offer(i, item)
        c.finish(5)
        assert c.prefix_batches == 3 and c.n_batches == 5
        assert len(list(c.replay())) == 3


# ------------------------------------------------------------- prefetch

@pytest.mark.parametrize("workers,put_workers", [(1, 1), (3, 1), (2, 2)])
def test_prefetch_keeps_order_values_and_stats(workers, put_workers):
    src = [{"x": np.full((4, 3), i, np.float32), "n": np.arange(4) + i}
           for i in range(11)]
    st = PrefetchStats()
    out = list(prefetch_to_device(iter(src), device="cpu", workers=workers,
                                  put_workers=put_workers, stats=st,
                                  transform=lambda b: (b["x"] * 2, b["n"])))
    assert [float(o[0][0, 0]) for o in out] == [2.0 * i for i in range(11)]
    assert all(isinstance(o[1], torch.Tensor) for o in out)
    assert st.batches == 11
    st = PrefetchStats()
    chunks = list(prefetch_to_device(iter(src), device="cpu", chunks=4,
                                     workers=workers,
                                     put_workers=put_workers, stats=st))
    assert [c[2] for c in chunks] == [4, 4, 3]
    chunk, mask, n_valid = chunks[-1]
    assert mask.tolist() == [1, 1, 1, 0]
    # the short chunk pads by repeating its last batch
    assert chunk["x"][:, 0, 0].tolist() == [8, 9, 10, 10]
    assert st.chunks == 3 and st.pad_fraction() == pytest.approx(1 / 12)
    assert set(st.as_dict()) >= {"read_s", "transform_s", "put_s",
                                 "consumer_wait_s", "chunks"}


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetch_errors_arrive_in_stream_order(workers):
    def bad(b):
        if b == 5:
            raise ValueError("boom at 5")
        return np.full(2, b)

    got = []
    with pytest.raises(ValueError, match="boom at 5"):
        for b in prefetch_to_device(range(10), device="cpu", transform=bad,
                                    workers=workers, put_workers=2):
            got.append(int(b[0]))
    assert got == [0, 1, 2, 3, 4]


def test_prefetch_retries_transient_source_pulls():
    plan = FaultPlan().inject("source.pull", at=3, kind="transient",
                              times=2)
    slept = []
    out = list(prefetch_to_device(
        plan.wrap_source([np.full(2, i) for i in range(6)]), device="cpu",
        retry_policy=RetryPolicy(sleep=slept.append)))
    assert [int(o[0]) for o in out] == list(range(6)) and len(slept) == 2
    plan = FaultPlan().inject("source.pull", at=1, kind="transient")
    with pytest.raises(InjectedTransientError):
        list(prefetch_to_device(
            plan.wrap_source([np.zeros(1)] * 3), device="cpu"))


def test_prefetch_abandon_does_not_hang_and_rejects_bad_args():
    def endless():
        i = 0
        while True:
            yield np.full(3, i)
            i += 1

    it = prefetch_to_device(endless(), device="cpu", depth=2, workers=2)
    assert int(next(it)[0]) == 0
    it.close()   # joins the reader and put threads
    assert not [t for t in threading.enumerate()
                if t.name.startswith("flink-ml-torch-prefetch")]
    # a mesh places every unit on this rank's device
    from flink_ml_tpu_torch.parallel.mesh import local_mesh

    assert next(prefetch_to_device(
        [np.ones(2)], device="meta",
        sharding=local_mesh(device="cpu"))).device.type == "cpu"
    with pytest.raises(TypeError, match="sharding"):
        next(prefetch_to_device([1], device="cpu", sharding=object()))
    with pytest.raises(ValueError):
        next(prefetch_to_device([1], device="cpu", depth=0))


def test_masked_chunk_scan_skips_dead_steps_and_probe_records():
    calls = []

    def step(s, x):
        calls.append(float(x))
        return s + x, x * 2

    chunk = (torch.tensor([1.0, 2.0, 3.0, 3.0]),)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    s, loss = masked_chunk_scan(step, torch.zeros(()), torch.zeros(()),
                                chunk, mask)
    assert calls == [1.0, 2.0, 3.0] and float(s) == 6 and float(loss) == 12
    probe = StepProbe.create(("loss", "other"), 4)
    s, loss, probe = masked_chunk_scan(step, torch.zeros(()),
                                       torch.zeros(()), chunk, mask,
                                       probe=probe, n_valid=2)
    got = probe.fetch()
    np.testing.assert_array_equal(got["loss"], [2.0, 4.0])
    assert np.isnan(got["other"]).all()
    assert probe.reset().cursor == 0
    with pytest.raises(ValueError, match="unknown probe channel"):
        probe.record(nope=1.0)


# ------------------------------------------------ streamed fits vs JAX

def _dense_cache(tmp_path, n=1536, d=8, seed=0, writer=TD):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) > 0).astype(np.float32)
    cache = str(tmp_path / f"dense{seed}")
    w = writer.DataCacheWriter(cache, segment_rows=512)
    w.append({"features": X, "label": y,
              "wt": rng.uniform(0.5, 1.5, size=n).astype(np.float32)})
    w.finish()
    return cache


def _mixed_cache(tmp_path, n=3000, nd=4, nc=6, seed=4):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, nd)).astype(np.float32)
    cat = rng.integers(0, D_MIXED, size=(n, nc)).astype(np.int32)
    cat[:, 0] = 777                    # a heavy hitter in every row
    y = rng.integers(0, 2, size=n).astype(np.float32)
    cat[:, 1] = np.where(y == 1, 16, 17)
    cache = str(tmp_path / f"mixed{seed}")
    w = TD.DataCacheWriter(cache, segment_rows=1024)
    w.append({"d": dense, "c": cat, "label": y})
    w.finish()
    return cache


def _sparse_cache(tmp_path, n=2048, d=1 << 14, nnz=6, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(4, d, size=(n, nnz)).astype(np.int32)
    y = rng.integers(0, 2, size=n).astype(np.float32)
    idx[:, 0] = np.where(y == 1, 1, 2)
    cache = str(tmp_path / "sparse")
    w = TD.DataCacheWriter(cache, segment_rows=1024)
    w.append({"features_indices": idx,
              "features_values": rng.uniform(0.5, 1.5, size=(n, nnz))
              .astype(np.float32), "label": y})
    w.finish()
    return cache


def _port_fit(cache, batch_rows, **kw):
    kw.setdefault("device", "cpu")
    return TS.sgd_fit_outofcore(
        LOSSES["logistic"],
        lambda: TD.DataCacheReader(cache, batch_rows=batch_rows), **kw)


def _jax_fit(cache, batch_rows, config, **kw):
    jcfg = JS.SGDConfig(learning_rate=config.learning_rate, reg=config.reg,
                        elastic_net=config.elastic_net,
                        max_epochs=config.max_epochs, tol=config.tol)
    return JS.sgd_fit_outofcore(
        j_logistic, lambda: JD.DataCacheReader(cache, batch_rows=batch_rows),
        config=jcfg, mesh=_mesh1(), **kw)


def _close(port, jax_fit):
    (ts, tlog), (js, jlog) = port, jax_fit
    np.testing.assert_allclose(ts.coefficients, js.coefficients,
                               atol=COEF_ATOL)
    assert ts.intercept == pytest.approx(js.intercept, abs=COEF_ATOL)
    np.testing.assert_allclose(tlog, jlog, rtol=LOSS_RTOL)


@pytest.mark.parametrize("w", [1, 8])
@pytest.mark.parametrize("reg,alpha", [(0.0, 0.0), (0.01, 0.5)])
def test_dense_stream_matches_the_jax_package(tmp_path, w, reg, alpha):
    cache = _dense_cache(tmp_path)
    cfg = TS.SGDConfig(learning_rate=0.4, reg=reg, elastic_net=alpha,
                       max_epochs=3, tol=0)
    kw = dict(num_features=8, weight_key="wt", steps_per_dispatch=w)
    port = _port_fit(cache, 256, config=cfg, **kw)
    assert port[0].planned_impl == "dense-stream"
    _close(port, _jax_fit(cache, 256, cfg, **kw))


def test_sparse_stream_matches_the_jax_package(tmp_path):
    cache = _sparse_cache(tmp_path)
    cfg = TS.SGDConfig(learning_rate=0.8, max_epochs=3, tol=0)
    kw = dict(num_features=1 << 14, indices_key="features_indices",
              values_key="features_values")
    port = _port_fit(cache, 256, config=cfg, **kw)
    assert port[0].planned_impl == "xla-stream"
    _close(port, _jax_fit(cache, 256, cfg, **kw))


@pytest.mark.parametrize("jax_plan", ["ell", "xla"])
def test_mixed_stream_matches_the_jax_package(tmp_path, monkeypatch,
                                              jax_plan):
    """The port's ELL stream (B1, B2 on every step) against the JAX
    package's mixed stream with its plan forced to "ell" and to "xla"."""
    cache = _mixed_cache(tmp_path)
    cfg = TS.SGDConfig(learning_rate=0.4, max_epochs=3, tol=0)
    kw = dict(num_features=D_MIXED, dense_key="d", indices_key="c")
    port = _port_fit(cache, 640, config=cfg, prefetch_workers=2, **kw)
    assert port[0].planned_impl == "ell-stream"
    monkeypatch.setattr(JS, "plan_mixed_impl", lambda *a, **k: jax_plan)
    want = _jax_fit(cache, 640, cfg, **kw)
    assert want[0].planned_impl == f"{jax_plan}-stream"
    _close(port, want)


def test_jax_streamed_cut_resumes_in_the_port(tmp_path):
    """A mid-epoch cut of the JAX package's streamed fit resumes in the
    port and ends where the JAX package's uninterrupted fit ends."""
    cache = _dense_cache(tmp_path, writer=JD)
    cfg = TS.SGDConfig(learning_rate=0.4, max_epochs=3, tol=0)
    kw = dict(num_features=8, steps_per_dispatch=2, cache_decoded=False)
    want = _jax_fit(cache, 256, cfg, **kw)
    from flink_ml_tpu.iteration import CheckpointConfig as JCC
    from flink_ml_tpu.robustness import FaultPlan as JFaultPlan
    from flink_ml_tpu.robustness import InjectedCrash as JCrash

    ck = str(tmp_path / "ck")
    plan = JFaultPlan().inject("source.pull", at=10, kind="crash")
    with plan, pytest.raises(JCrash):
        JS.sgd_fit_outofcore(
            j_logistic,
            lambda: plan.wrap_source(JD.DataCacheReader(cache,
                                                        batch_rows=256)),
            config=JS.SGDConfig(learning_rate=0.4, max_epochs=3, tol=0),
            mesh=_mesh1(), checkpoint=JCC(ck, max_to_keep=10),
            checkpoint_every_steps=2, **kw)
    port = _port_fit(cache, 256, config=cfg,
                     checkpoint=CheckpointConfig(ck, max_to_keep=10),
                     checkpoint_every_steps=2, resume=True, **kw)
    _close(port, want)


# ------------------------------------------- within the port, bit for bit

@pytest.fixture
def mixed_cache(tmp_path):
    return _mixed_cache(tmp_path, n=2600)


MIXED = dict(num_features=D_MIXED, dense_key="d", indices_key="c",
             config=TS.SGDConfig(learning_rate=0.4, max_epochs=3, tol=0))


def _same(a, b):
    np.testing.assert_array_equal(a[0].coefficients, b[0].coefficients)
    assert a[0].intercept == b[0].intercept
    assert a[1] == b[1]


def test_mixed_stream_w_sweep_bit_for_bit(mixed_cache):
    base = _port_fit(mixed_cache, 320, steps_per_dispatch=1, **MIXED)
    for w in (2, 3, 8, 16):
        info = {}
        got = _port_fit(mixed_cache, 320, steps_per_dispatch=w,
                        stream_info=info, **MIXED)
        _same(got, base)
        assert info["dispatches_per_epoch"] == [-(-9 // w)] * 3


def test_cached_epochs_and_plain_bit_for_bit(mixed_cache):
    info = {}
    cached = _port_fit(mixed_cache, 320, stream_info=info, **MIXED)
    assert info["decoded_cache_batches"] == 9
    assert info["decoded_cache_recorded_epochs"] == 1
    _same(cached, _port_fit(mixed_cache, 320, cache_decoded=False, **MIXED))
    _same(cached, _port_fit(mixed_cache, 320, plain=True, **MIXED))
    # every step of the CPU run took the plain versions the kernels
    # replace: no CUDA launch is counted
    assert E.LAUNCHES["ell_margin"] == 0


@pytest.mark.parametrize("layout", ["dense", "mixed"])
def test_midepoch_kill_and_resume_bit_for_bit(tmp_path, mixed_cache,
                                              layout):
    if layout == "dense":
        cache, rows, kw = _dense_cache(tmp_path), 256, dict(
            num_features=8, config=TS.SGDConfig(learning_rate=0.4,
                                                max_epochs=3, tol=0))
    else:
        cache, rows, kw = mixed_cache, 320, dict(MIXED)
    ref = _port_fit(cache, rows, **kw)
    plan = FaultPlan().inject("source.pull", at=13, kind="crash")
    report = RecoveryReport()
    with plan:
        got = resilient_fit(
            TS.sgd_fit_outofcore, LOSSES["logistic"],
            lambda: plan.wrap_source(TD.DataCacheReader(cache,
                                                        batch_rows=rows)),
            checkpoint=CheckpointConfig(str(tmp_path / "ck")),
            checkpoint_every_steps=4, steps_per_dispatch=4, device="cpu",
            max_restarts=1, report=report,
            backoff=RetryPolicy(sleep=lambda s: None), **kw)
    assert report.restarts == 1 and report.events[0].restored_step
    _same(got, ref)


def test_over_cap_batches_raise_with_sizing_guidance(tmp_path):
    rng = np.random.default_rng(5)
    n = 600
    cat = np.stack([np.full(n, 300), np.full(n, 301),
                    rng.integers(0, D_MIXED, size=n)], axis=1
                   ).astype(np.int32)
    cache = str(tmp_path / "cap")
    w = TD.DataCacheWriter(cache, segment_rows=1024)
    w.append({"d": rng.normal(size=(n, 2)).astype(np.float32), "c": cat,
              "label": rng.integers(0, 2, size=n).astype(np.float32)})
    w.finish()
    kw = dict(num_features=D_MIXED, dense_key="d", indices_key="c",
              config=TS.SGDConfig(max_epochs=1, tol=0))
    with pytest.raises(ValueError, match="heavy indices > forced cap.*"
                       "ell_heavy_cap"):
        _port_fit(cache, 600, ell_heavy_cap=1, **kw)
    with pytest.raises(ValueError, match="overflow needs.*ell_ovf_cap"):
        _port_fit(cache, 300, ell_ovf_cap=4, ell_heavy_cap=0, **kw)


@pytest.mark.parametrize("d,batch,nc,pad", [
    (D_MIXED, 256, 6, 0), (1 << 20, 4096, 26, 300), (128 * 1001, 2048, 26,
                                                      0),
    (D_MIXED, 640, 6, 17), (D_MIXED, 2048, 8, 5)])
def test_host_routing_equals_sample_routing(d, batch, nc, pad):
    """The routing built on the host from the indices and the layout (the
    timing script's yardstick for the card's build) equals
    ``sample_routing`` of the same layout array for array (heavy indices,
    overflow runs with repeats inside a sample, padding sentinels); padded
    to a fixed height, the extra rows are -1."""
    rng = np.random.default_rng(d + batch)
    cat = rng.integers(32, d, size=(batch, nc)).astype(np.int32)
    cat[:, 0] = np.where(rng.integers(0, 2, batch) == 1, 16, 17)
    cat[: batch // 7, 1] = 40          # a dense run into the overflow
    cat[: 150, 2] = cat[: 150, 3] = 41   # repeats inside a sample, too
    if pad:
        cat[-pad:] = d                 # padding rows: sentinels
    lay = E.ell_layout(cat[None], d)
    assert lay.need_ovf[0] > 0
    assert (lay.need_heavy[0] > 0) == (batch >= 2048)
    want, _ = E.sample_routing(*(torch.from_numpy(a[0]) for a in
                                 (lay.src, lay.pos, lay.mask)), batch)
    got = routing_build_times.sample_routing_host(cat, lay)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want.numpy())
    fixed = routing_build_times.sample_routing_host(cat, lay, nnz=nc + 2)
    np.testing.assert_array_equal(fixed[:got.shape[0]], got)
    assert (fixed[got.shape[0]:] == -1).all()
    with pytest.raises(ValueError, match="in-grid slots"):
        routing_build_times.sample_routing_host(cat, lay, nnz=1)


def test_stream_options_probe_publish_and_unported_branches(tmp_path):
    cache = _dense_cache(tmp_path)
    cfg = TS.SGDConfig(learning_rate=0.4, max_epochs=2, tol=0)
    info, published = {}, []
    st, log = _port_fit(cache, 256, num_features=8, config=cfg,
                        steps_per_dispatch=4, step_probe=True,
                        stream_info=info, checkpoint_every_steps=4,
                        publish_cb=lambda step, fn: published.append(
                            (step, fn()["w"].shape)))
    assert info["step_trace"]["loss"].shape == (12,)
    assert np.mean(info["step_trace"]["loss"][:6]) == pytest.approx(
        log[0], rel=1e-6)
    assert [p[0] for p in published] == [4, 6, 10, 12]
    seen = []

    def by_epoch(epoch):
        seen.append(epoch)
        return TD.ShuffledCacheReader(cache, batch_rows=256, seed=1,
                                      epoch=epoch)

    info = {}
    TS.sgd_fit_outofcore(LOSSES["logistic"], by_epoch, num_features=8,
                         config=cfg, device="cpu", stream_info=info)
    assert seen[-2:] == [0, 1] and info["decoded_cache_mode"] == "block"
    # the multi-rank and elastic branches train (tests/
    # test_torch_sharded_linear.py and tests/test_torch_elastic.py hold
    # them to the JAX package); a mesh must be the port's, and membership
    # needs its fleet's mesh
    with pytest.raises(TypeError, match="Mesh"):
        _port_fit(cache, 256, num_features=8, config=cfg, mesh=object())
    with pytest.raises(ValueError, match="fleet's mesh"):
        _port_fit(cache, 256, num_features=8, config=cfg,
                  membership=object())
    # a dense grad_reduce trains (tests/test_torch_grad_reduce.py holds
    # it to the JAX package); the hashed layouts refuse one
    from flink_ml_tpu_torch.parallel.grad_reduce import GradReduceConfig

    gr = GradReduceConfig(mode="topk")
    st_gr, log_gr = _port_fit(cache, 256, num_features=8,
                              config=TS.SGDConfig(max_epochs=2,
                                                  grad_reduce=gr))
    assert st_gr.planned_impl == "dense-stream-reduced"
    assert len(log_gr) == 2 and np.all(np.isfinite(log_gr))
    with pytest.raises(ValueError, match="sparse by construction"):
        _port_fit(cache, 256, num_features=D_MIXED, dense_key="d",
                  indices_key="c", config=TS.SGDConfig(grad_reduce=gr))
    with pytest.raises(ValueError, match="empty epoch"):
        TS.sgd_fit_outofcore(LOSSES["logistic"], lambda: iter([]),
                             num_features=4, config=cfg, device="cpu")


# ------------------------------------------------ estimators end to end

def _tsv(path, rows, rng):
    lines = []
    for _ in range(rows):
        y = int(rng.random() < 0.5)
        ints = rng.integers(-2, 4, size=13)
        cats = [("aa11bb22", "cc33dd44")[y]] + [
            f"{rng.integers(0, 1 << 32):08x}" for _ in range(25)]
        lines.append(("\t".join([str(y)] + [str(v) for v in ints] + cats)
                      + "\n").encode())
    path.write_bytes(b"".join(lines))


def test_logistic_regression_fit_outofcore_over_criteo_tsv(tmp_path):
    """TSV -> CriteoTSVReader -> fit_outofcore(mixed=True): the port's
    estimator (ELL stream) against the JAX package's."""
    import flink_ml_tpu.models as JM
    import flink_ml_tpu_torch as T
    from flink_ml_tpu.data.criteo import CriteoTSVReader as JReader
    from flink_ml_tpu.parallel.mesh import use_mesh
    from flink_ml_tpu_torch.data.criteo import CriteoTSVReader as TReader

    path = tmp_path / "train.tsv"
    _tsv(path, 512, np.random.default_rng(2))
    hs = D_MIXED - 13
    info = {}
    t_model = (T.LogisticRegression(device="cpu").set_max_iter(4)
               .set_learning_rate(0.5).set_tol(0)
               .fit_outofcore(lambda: TReader(str(path), batch_rows=64,
                                              hash_space=hs),
                              num_features=D_MIXED, mixed=True,
                              stream_info=info))
    assert info["impl"] == "ell-stream"
    with use_mesh(_mesh1()):
        j_model = (JM.LogisticRegression().set_max_iter(4)
                   .set_learning_rate(0.5).set_tol(0)
                   .fit_outofcore(lambda: JReader(str(path), batch_rows=64,
                                                  hash_space=hs),
                                  num_features=D_MIXED, mixed=True))
    np.testing.assert_allclose(t_model.loss_log, j_model.loss_log,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        t_model.get_model_data()[0]["coefficients"][0],
        np.asarray(j_model.get_model_data()[0]["coefficients"][0]),
        atol=COEF_ATOL)
    assert t_model.loss_log[-1] < 0.6 * t_model.loss_log[0]


@pytest.mark.parametrize("name", ["LinearRegression", "LinearSVC"])
def test_dense_estimators_fit_outofcore(tmp_path, monkeypatch, name):
    import flink_ml_tpu.models as JM
    import flink_ml_tpu_torch as T

    cache = _dense_cache(tmp_path, seed=3)
    t = (getattr(T, name)(device="cpu").set_max_iter(2).set_tol(0)
         .set_learning_rate(0.1)
         .fit_outofcore(lambda: TD.DataCacheReader(cache, batch_rows=256),
                        num_features=8))
    from flink_ml_tpu.parallel.mesh import use_mesh

    with use_mesh(_mesh1()):
        j = (getattr(JM, name)().set_max_iter(2).set_tol(0)
             .set_learning_rate(0.1)
             .fit_outofcore(lambda: JD.DataCacheReader(cache,
                                                       batch_rows=256),
                            num_features=8))
    np.testing.assert_allclose(t.loss_log, j.loss_log, rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        t.get_model_data()[0]["coefficients"][0],
        np.asarray(j.get_model_data()[0]["coefficients"][0]),
        atol=COEF_ATOL)
    # the estimator's default device is the card: without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        getattr(T, name)().fit_outofcore(
            lambda: TD.DataCacheReader(cache, batch_rows=256),
            num_features=8)


@pytest.mark.parametrize("cap,batch", [(64, 40), (4096, 300), (50, 700)])
def test_overflow_padding_spread_keeps_every_live_bit(cap, batch):
    """The fixed-order overflow scatter sends each pad entry to a slot of
    its own as -0.0: every slot the live entries reach, and every other
    slot, keeps the bits of the plain scatter (the pads' target, the
    discarded slot ``batch``, aside)."""
    rng = np.random.default_rng(cap + batch)
    n_live = cap // 3
    target = np.full(cap, batch, np.int32)
    target[:n_live] = rng.integers(0, batch, size=n_live)   # repeats
    vals = torch.from_numpy(rng.normal(size=cap).astype(np.float32))
    idx = torch.from_numpy(target)
    base = torch.from_numpy(rng.normal(size=batch + 5).astype(np.float32))
    base[::7] = -0.0
    want = base.clone().index_add_(0, idx, vals)
    got = TS._overflow_scatter_(base.clone(), idx, vals, idx, batch)
    keep = torch.ones(batch + 5, dtype=torch.bool)
    keep[batch] = False
    assert torch.equal(got[keep].view(torch.int32),
                       want[keep].view(torch.int32))
