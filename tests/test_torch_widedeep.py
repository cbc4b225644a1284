"""The port's Wide&Deep (``flink_ml_tpu_torch.models.recommendation``) against
the JAX package's on seeded numpy data: the init draws, the forward, one
training step of every mode from converted JAX parameters and optimizer
state, one-epoch fits and an 8-epoch envelope, transform, save and load
across the two packages, and the validation errors.  The port runs on the
CPU (its fold wrapper takes the plain version there); the JAX fits run on a
one-device mesh, as the port is single-device (the suite's 8-device mesh
changes the batch rounding and the order of the sums)."""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu.models.recommendation import widedeep as JWD
from flink_ml_tpu.ops.emb_grad import emb_grad_route as jax_route
from flink_ml_tpu.parallel.mesh import device_mesh, use_mesh
from flink_ml_tpu_torch.models.common import adam as TA
from flink_ml_tpu_torch.models.recommendation import widedeep as TWD
from flink_ml_tpu_torch.ops.emb_grad import emb_grad_route as port_route
from flink_ml_tpu_torch.utils.convert import (
    adam_state_from_jax,
    widedeep_params_from_jax,
)

# __graft_entry__.py's small configuration
VOCAB = (100, 50, 20)
EMB, HIDDEN, D_DENSE = 8, (32, 16), 16
TABLE_KEYS = ("emb", "wide_cat", "wide_dense", "wide_b")


def _one_device():
    return use_mesh(device_mesh({"data": 1}, devices=jax.devices()[:1]))


def _ctr_cols(n=512, seed=0):
    """``tests/test_widedeep.py::_ctr_table``'s data: clicks driven by one
    categorical field and one dense feature."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 4)).astype(np.float32)
    cat = np.stack([rng.integers(0, 10, size=n),
                    rng.integers(0, 7, size=n)], axis=1).astype(np.int32)
    logit = (cat[:, 0] - 4.5) * 1.2 + dense[:, 0] * 2.0
    label = (logit + 0.3 * rng.normal(size=n) > 0).astype(np.int64)
    return {"denseFeatures": dense, "catFeatures": cat, "label": label}


def _batch(rng, b, steps=None):
    """Graft-config batches with ids offset into the stacked vocab."""
    lead = (b,) if steps is None else (steps, b)
    cat = (np.stack([rng.integers(0, v, size=lead) for v in VOCAB], axis=-1)
           + JWD._field_offsets(VOCAB)).astype(np.int32)
    dense = rng.normal(size=lead + (D_DENSE,)).astype(np.float32)
    y = rng.integers(0, 2, size=lead).astype(np.float32)
    mask = np.ones(lead, np.float32)
    return dense, cat, y, mask


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _assert_tree_close(port_tree, jax_tree, rtol, atol, keys=None):
    want = _host(jax_tree)
    for k in keys or sorted(want):
        got_l = TA.tree_leaves(port_tree[k])
        want_l = jax.tree_util.tree_leaves(want[k])
        assert len(got_l) == len(want_l)
        for a, b in zip(got_l, want_l):
            a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
            np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                                       atol=atol, err_msg=k)


@pytest.mark.parametrize("vocab,emb,hidden,d", [
    (VOCAB, EMB, HIDDEN, D_DENSE), ((10, 7), 8, (64, 32), 4)])
def test_init_params_same_draws(vocab, emb, hidden, d):
    want = JWD.init_params(np.random.default_rng(5), d, vocab, emb, hidden)
    got = TWD.init_params(np.random.default_rng(5), d, vocab, emb, hidden)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_forward_and_loss_match_jax():
    rng = np.random.default_rng(0)
    host = JWD.init_params(rng, D_DENSE, VOCAB, EMB, HIDDEN)
    host["wide_cat"] = rng.normal(size=host["wide_cat"].shape).astype(
        np.float32)
    host["wide_dense"] = rng.normal(size=D_DENSE).astype(np.float32)
    host["wide_b"] = np.float32(0.3)
    dense, cat, y, mask = _batch(rng, 256)
    want = JWD.forward(jax.tree_util.tree_map(jnp.asarray, host),
                       jnp.asarray(dense), jnp.asarray(cat))
    params = widedeep_params_from_jax(host, device="cpu")
    got = TWD.forward(params, torch.from_numpy(dense), torch.from_numpy(cat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    mask[-10:] = 0.0
    np.testing.assert_allclose(
        float(TWD.bce_loss(params, *(torch.from_numpy(a) for a in
                                     (dense, cat, y, mask)))),
        float(JWD.bce_loss(jax.tree_util.tree_map(jnp.asarray, host),
                           dense, cat, y, mask)), rtol=1e-6)


def test_adam_update_matches_optax():
    """The hand-written Adam against ``optax.adam`` over three steps of a
    small tree (one f32 rounding at most per element)."""
    rng = np.random.default_rng(2)
    host = {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": [{"w": rng.normal(size=4).astype(np.float32)}],
            "c": np.float32(0.5)}
    opt = optax.adam(0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, host)
    js = opt.init(jp)
    tp = TWD.params_to_device(host, "cpu")
    ts = TA.adam_init(tp)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda x: rng.normal(size=np.shape(x)).astype(np.float32), host)
        upd, js = opt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = TA.adam_update(TWD.params_to_device(g, "cpu"), ts, tp, 0.01)
    assert ts.count == int(js[0].count) == 3
    for got, want in ((tp, jp), (ts.mu, js[0].mu), (ts.nu, js[0].nu)):
        for a, b in zip(TA.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("mode", ["gather", "scatter", "off", "lazy"])
def test_one_train_step_from_converted_jax_state(mode):
    """One JAX step makes a non-trivial state; both packages then take the
    next step from it (the port from the converted parameters and Adam
    state): loss rtol 1e-5, parameters and moments rtol 1e-4 / atol 1e-5
    (the JAX package's sharded-vs-reference tolerances)."""
    rng = np.random.default_rng(11)
    dense, cat, y, mask = _batch(rng, 96, steps=2)
    mask[1, -5:] = 0.0                  # padding rows in the second step
    cat[1, :40, 0] = 3                  # a heavy run: fold_passes >= 5
    total = int(np.sum(VOCAB))
    routed = mode in ("gather", "scatter")
    lazy = mode == "lazy"
    jr = jax_route(cat, total, placement=mode) if routed else None
    tr = port_route(cat, total, placement=mode) if routed else None
    step, jp, jo = JWD.build_reference_train_step(
        D_DENSE, VOCAB, EMB, HIDDEN, lazy_embeddings=lazy, route=jr)

    def jax_step(p, o, s):
        extra = tuple(jnp.asarray(np.asarray(a)) for a in jr.step_slice(s)) \
            if routed else ()
        return step(p, o, dense[s], cat[s], y[s], mask[s], *extra)

    jp, jo, _ = jax_step(jp, jo, 0)
    tp = widedeep_params_from_jax(_host(jp), device="cpu")
    to = adam_state_from_jax(_host(jo), device="cpu")
    t_step, _ = TWD._make_train_ops(tp, 1e-2, lazy, route=tr)
    jp, jo, jl = jax_step(jp, jo, 1)
    tp, to, tl = t_step(tp, to, *(torch.from_numpy(a[1])
                                  for a in (dense, cat, y, mask)),
                        *(tr.step_slice(1) if routed else ()))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    _assert_tree_close(tp, jp, rtol=1e-4, atol=1e-5)
    if lazy:
        assert to["t"] == int(jo["t"]) == 2
        _assert_tree_close(to["m"], jo["m"], rtol=1e-4, atol=1e-5)
        _assert_tree_close(to["v"], jo["v"], rtol=1e-4, atol=1e-5)
    else:
        assert to.count == int(jo[0].count) == 2
        _assert_tree_close(to.mu, jo[0].mu, rtol=1e-4, atol=1e-5)
        _assert_tree_close(to.nu, jo[0].nu, rtol=1e-4, atol=1e-5)


def _fits(cols, iters, mode, lazy=False, seed=0):
    with _one_device():
        jm = (J.models.recommendation.widedeep.WideDeep()
              .set_vocab_sizes([10, 7]).set_max_iter(iters).set_seed(seed)
              .set(JWD.WideDeep.ROUTED_EMB_GRAD, mode)
              .set(JWD.WideDeep.LAZY_EMB_OPT, lazy).fit(J.Table(cols)))
    est = (T.WideDeep(device="cpu").set_vocab_sizes([10, 7])
           .set_max_iter(iters).set_seed(seed)
           .set(T.WideDeep.ROUTED_EMB_GRAD, mode)
           .set(T.WideDeep.LAZY_EMB_OPT, lazy))
    return est, est.fit(T.Table(cols)), jm


@pytest.mark.parametrize("mode,lazy", [("auto", False), ("off", False),
                                       ("auto", True)])
def test_one_epoch_fit_matches_jax(mode, lazy):
    """One epoch (16 Adam steps): the JAX package's one-epoch contract
    (``tests/test_widedeep.py::test_routed_fit_matches_dense_scatter_fit``):
    loss rtol 2e-5, parameters rtol 1e-3 / atol 1e-3."""
    est, tm, jm = _fits(_ctr_cols(), 1, mode, lazy)
    routed = mode == "auto" and not lazy
    assert (est.route_info is not None) == routed
    if routed:
        assert est.route_info["placement"] == "gather"
        assert est.route_info["fold_passes"] >= 1
    assert len(tm.loss_log) == 1
    np.testing.assert_allclose(tm.loss_log, jm._loss_log, rtol=2e-5,
                               atol=1e-6)
    for k in TABLE_KEYS:
        np.testing.assert_allclose(tm._params[k], np.asarray(jm._params[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("mode,lazy", [("auto", False), ("off", False),
                                       ("auto", True)])
def test_eight_epoch_envelope_and_accuracy(mode, lazy):
    """Adam amplifies the f32 summation-order differences ~10-20x an
    epoch, so 8 epochs are held to the JAX package's trajectory envelope
    (loss rtol 5e-2, parameters rtol 0.5 / atol 5e-2) and to the same
    quality: accuracy above 0.85 in both, within 0.02 of each other."""
    cols = _ctr_cols()
    _, tm, jm = _fits(cols, 8, mode, lazy)
    np.testing.assert_allclose(tm.loss_log, jm._loss_log, rtol=5e-2,
                               atol=1e-4)
    assert tm.loss_log[-1] < tm.loss_log[0]
    for k in TABLE_KEYS:
        np.testing.assert_allclose(tm._params[k], np.asarray(jm._params[k]),
                                   rtol=0.5, atol=5e-2, err_msg=k)
    acc = [np.mean(tm.transform(T.Table(cols))[0]["prediction"]
                   == cols["label"]),
           np.mean(jm.transform(J.Table(cols))[0]["prediction"]
                   == cols["label"])]
    assert min(acc) > 0.85 and abs(acc[0] - acc[1]) < 0.02, acc


def _numpy_scores(params, dense, cat, vocab):
    """float64 numpy forward of fitted parameters."""
    ids = cat + JWD._field_offsets(vocab)[None, :]
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    d = dense.astype(np.float64)
    wide = d @ p["wide_dense"] + p["wide_cat"][ids].sum(1) + p["wide_b"]
    deep = np.concatenate([d, p["emb"][ids].reshape(len(d), -1)], axis=1)
    for i, layer in enumerate(p["mlp"]):
        deep = deep @ layer["w"] + layer["b"]
        if i + 1 < len(p["mlp"]):
            deep = np.maximum(deep, 0.0)
    return 1.0 / (1.0 + np.exp(-(wide + deep[:, 0])))


def test_transform_matches_numpy_forward():
    cols = _ctr_cols(n=200, seed=3)
    _, tm, _ = _fits(cols, 3, "auto")
    (out,) = tm.transform(T.Table(cols))
    want = _numpy_scores(tm._params, cols["denseFeatures"],
                         cols["catFeatures"], (10, 7))
    assert out["rawPrediction"].dtype == np.float64
    assert out["prediction"].dtype == np.int64
    np.testing.assert_allclose(out["rawPrediction"], want, atol=1e-6)
    np.testing.assert_array_equal(out["prediction"],
                                  (out["rawPrediction"] > 0.5).astype(int))


def test_save_load_across_packages(tmp_path):
    cols = _ctr_cols(n=128)
    _, tm, jm = _fits(cols, 2, "auto")
    jm.save(str(tmp_path / "jax"))
    from_jax = T.WideDeepModel.load(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_allclose(
        from_jax.transform(T.Table(cols))[0]["rawPrediction"],
        jm.transform(J.Table(cols))[0]["rawPrediction"], rtol=1e-5,
        atol=1e-6)
    tm.save(str(tmp_path / "port"))
    # the metadata names the saving package's class; pointed at the JAX
    # class, the JAX loader reads the port's files as they are
    meta_path = tmp_path / "port" / "metadata"
    meta = json.loads(meta_path.read_text())
    assert meta["className"] == \
        "flink_ml_tpu_torch.models.recommendation.widedeep.WideDeepModel"
    shutil.copytree(tmp_path / "port", tmp_path / "for_jax")
    meta["className"] = "flink_ml_tpu.models.recommendation.widedeep." \
        "WideDeepModel"
    (tmp_path / "for_jax" / "metadata").write_text(json.dumps(meta))
    from_port = JWD.WideDeepModel.load(str(tmp_path / "for_jax"))
    assert type(from_port) is JWD.WideDeepModel
    np.testing.assert_allclose(
        from_port.transform(J.Table(cols))[0]["rawPrediction"],
        tm.transform(T.Table(cols))[0]["rawPrediction"], rtol=1e-5,
        atol=1e-6)
    again = T.WideDeepModel.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(
        again.transform(T.Table(cols))[0]["rawPrediction"],
        tm.transform(T.Table(cols))[0]["rawPrediction"])
    assert again.get(T.WideDeep.VOCAB_SIZES) == (10, 7)
    est = T.WideDeep(device="cpu").set_vocab_sizes([10, 7]).set_max_iter(4)
    est.save(str(tmp_path / "est"))
    assert T.WideDeep.load(str(tmp_path / "est"),
                           device="cpu").get_max_iter() == 4


@pytest.mark.parametrize("mode,lazy", [("auto", False), ("off", False),
                                       ("auto", True)])
def test_fit_leaves_no_tensor_in_a_reference_cycle(mode, lazy):
    """Every tensor a fit's steps make is freed when its last reference
    goes, never held in a reference cycle until Python's collector runs:
    on the card the peak memory would then move with the collector's
    timing (the trees of ``models/common/adam.py``)."""
    import gc

    cols = _ctr_cols()
    est = (T.WideDeep(device="cpu").set_vocab_sizes([10, 7]).set_max_iter(2)
           .set(T.WideDeep.ROUTED_EMB_GRAD, mode)
           .set(T.WideDeep.LAZY_EMB_OPT, lazy))
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        est.fit(T.Table(cols))
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []


def test_validation_errors():
    cols = _ctr_cols(n=64)
    with pytest.raises(ValueError, match="vocabSizes"):
        T.WideDeep(device="cpu").fit(T.Table(cols))
    with pytest.raises(ValueError, match="vocab range"):
        T.WideDeep(device="cpu").set_vocab_sizes([5, 7]).fit(T.Table(cols))
    with pytest.raises(ValueError, match="fields"):
        T.WideDeep(device="cpu").set_vocab_sizes([10, 7, 3]).fit(
            T.Table(cols))
    with pytest.raises(ValueError, match="dense-Adam"):
        (T.WideDeep(device="cpu").set_vocab_sizes([10, 7]).set_max_iter(2)
         .set(T.WideDeep.LAZY_EMB_OPT, True)
         .set(T.WideDeep.ROUTED_EMB_GRAD, "on").fit(T.Table(cols)))
    model = (T.WideDeep(device="cpu").set_vocab_sizes([10, 7])
             .set_max_iter(1).fit(T.Table(cols)))
    bad = dict(cols, catFeatures=cols["catFeatures"] + 10)
    with pytest.raises(ValueError, match="vocab range"):
        model.transform(T.Table(bad))
    with pytest.raises(RuntimeError, match="no model data"):
        T.WideDeepModel(device="cpu").transform(T.Table(cols))


def test_unported_paths_name_their_queue():
    """The paths over ranks are ported (``tests/test_torch_widedeep_ranks
    .py`` runs them); what is not a mesh of a process group is refused
    before any work."""
    est = T.WideDeep(device="cpu").set_vocab_sizes([4])
    with pytest.raises(TypeError, match="Mesh"):
        est.fit_outofcore(lambda: iter([]), mesh=object())
    with pytest.raises(ValueError, match="fleet's mesh"):
        est.fit_outofcore(lambda: iter([]), membership=object())
    with pytest.raises(TypeError, match="Mesh"):
        TWD.build_sharded_train_step(None, 4, [4], 2, (2,))
    # the chain terminal is ported: it needs model data, and declines a
    # schema without the dense and categorical columns
    with pytest.raises(RuntimeError, match="no model data"):
        T.WideDeepModel(device="cpu").transform_kernel({})


def test_reference_step_uses_seed_zero_init():
    step, params, state = TWD.build_reference_train_step(
        D_DENSE, VOCAB, EMB, HIDDEN, device="cpu")
    want = JWD.init_params(np.random.default_rng(0), D_DENSE, VOCAB, EMB,
                           HIDDEN)
    for a, b in zip(TA.tree_leaves(params), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert state.count == 0
    dense, cat, y, mask = _batch(np.random.default_rng(1), 32)
    new, state, loss = step(params, state, *(torch.from_numpy(a) for a in
                                              (dense, cat, y, mask)))
    assert state.count == 1 and np.isfinite(float(loss))
    assert not torch.equal(new["emb"], params["emb"])
