"""The port's composition layer against the JAX package's, after
``tests/test_graph.py``, ``test_model_selection.py`` and
``test_pipeline.py``: Graph / GraphBuilder / GraphModel wiring and
persistence, ParamGridBuilder grids, CrossValidator and
TrainValidationSplit with the JAX package's seeded folds (the same folds,
the same chosen candidate, metrics within 1e-4), candidate cloning
(devices carried), the fused path inside the fold scoring, PipelineModel
persistence across the packages, and ``pipeline_model_from_jax``.  The
port runs on the CPU."""

import json
import os
import shutil

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu.api import model_selection as JMS
from flink_ml_tpu.models.classification import LogisticRegression as JLR
from flink_ml_tpu.models.evaluation.binary_evaluator import (
    BinaryClassificationEvaluator as JBCE,
)
from flink_ml_tpu.models.feature import scalers as JS
from flink_ml_tpu.models.feature import transforms as JT
from flink_ml_tpu_torch.api import chain as TC
from flink_ml_tpu_torch.api import model_selection as TMS
from flink_ml_tpu_torch.models.classification import LogisticRegression
from flink_ml_tpu_torch.models.evaluation import (
    BinaryClassificationEvaluator,
)
from flink_ml_tpu_torch.models.feature import (
    Normalizer,
    StandardScaler,
    VectorAssembler,
)
from flink_ml_tpu_torch.utils.convert import pipeline_model_from_jax

METRIC_TOL = 1e-4


def _data(n=400, d=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] - 0.5 * X[:, 1] > 0).astype(np.float64)
    return X, y


def _lr(pkg="port"):
    lr = LogisticRegression(device="cpu") if pkg == "port" else JLR()
    return lr.set_max_iter(15).set_learning_rate(0.5) \
        .set_global_batch_size(128)


def _auc(pkg="port"):
    ev = (BinaryClassificationEvaluator(device="cpu") if pkg == "port"
          else JBCE())
    return ev.set_raw_prediction_col("rawPrediction") \
        .set_metrics("areaUnderROC")


def _blobs(n_per=40, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=5.0, size=(2, 4))
    X = np.concatenate([centers[i] + rng.normal(size=(n_per, 4))
                        for i in range(2)]).astype(np.float64)
    y = np.repeat([0, 1], n_per)
    return T.Table({"features": X, "label": y}), X, y


# -- Graph --------------------------------------------------------------------

def test_linear_graph_equals_pipeline():
    table, X, y = _blobs()
    b = T.GraphBuilder()
    src = b.source()
    scaled = b.add_stage(StandardScaler(device="cpu")
                         .set_output_col("features"), [src])[0]
    pred = b.add_stage(T.SoftmaxRegression(device="cpu").set_max_iter(30),
                       [scaled])[0]
    model = b.build(inputs=[src], outputs=[pred]).fit(table)
    out = model.transform(table)[0]
    assert (np.asarray(out["prediction"]) == y).mean() > 0.95
    pipe_out = T.Pipeline([
        StandardScaler(device="cpu").set_output_col("features"),
        T.SoftmaxRegression(device="cpu").set_max_iter(30),
    ]).fit(table).transform(table)[0]
    np.testing.assert_array_equal(np.asarray(out["prediction"]),
                                  np.asarray(pipe_out["prediction"]))


def test_graph_kmeans_equals_pipeline_bits():
    """source -> StandardScaler -> KMeans through the Graph gives the
    fused pipeline's bits (chip_smoke's phase 29 at a small size)."""
    table, X, _ = _blobs(seed=3)
    b = T.GraphBuilder()
    src = b.source()
    scaled = b.add_stage(StandardScaler(device="cpu")
                         .set_output_col("scaled"), [src])[0]
    pred = b.add_stage(T.KMeans(device="cpu").set_k(3).set_max_iter(4)
                       .set_features_col("scaled"), [scaled])[0]
    gm = b.build([src], [pred]).fit(table)
    pm = T.PipelineModel([node.stage for node in gm._nodes])
    (g,) = gm.transform(table)
    (p,) = pm.transform(table)
    assert pm._chain_plan([table]).describe() == [("segment", 2)]
    for c in p.column_names:
        assert np.array_equal(np.asarray(g[c]), np.asarray(p[c]))


def test_diamond_graph_two_branches():
    table, X, y = _blobs()
    b = T.GraphBuilder()
    src = b.source()
    s1 = b.add_stage(StandardScaler(device="cpu").set_output_col("std"),
                     [src])[0]
    s2 = b.add_stage(Normalizer(device="cpu").set_output_col("unit")
                     .set_features_col("features"), [s1])[0]
    merged = b.add_stage(VectorAssembler(device="cpu")
                         .set_input_cols("std", "unit")
                         .set_features_col("both"), [s2])[0]
    pred = b.add_stage(T.SoftmaxRegression(device="cpu")
                       .set_features_col("both").set_max_iter(30),
                       [merged])[0]
    out = b.build([src], [pred]).fit(table).transform(table)[0]
    assert np.asarray(out["both"]).shape == (len(y), 8)
    assert (np.asarray(out["prediction"]) == y).mean() > 0.95


def test_multi_output_and_passthrough_graph():
    table, X, y = _blobs()
    b = T.GraphBuilder()
    src = b.source()
    scaled = b.add_stage(StandardScaler(device="cpu")
                         .set_output_col("features"), [src])[0]
    clustered = b.add_stage(T.KMeans(device="cpu").set_max_iter(5),
                            [scaled])[0]
    model = b.build([src], [src, scaled, clustered]).fit(table)
    raw, scaled_t, clustered_t = model.transform(table)
    assert "prediction" in clustered_t
    assert abs(float(np.asarray(scaled_t["features"]).mean())) < 1e-6
    np.testing.assert_array_equal(np.asarray(raw["features"]), X)


def test_graph_save_load_across_packages(tmp_path):
    """A Graph saved by the JAX package loads in the port (and back)."""
    X, y = _data(n=120, seed=4)
    jb = J.GraphBuilder()
    src = jb.source()
    scaled = jb.add_stage(JS.StandardScaler().set_output_col("scaled"),
                          [src])[0]
    norm = jb.add_stage(JT.Normalizer().set_features_col("scaled")
                        .set_output_col("unit"), [scaled])[0]
    jgm = jb.build([src], [norm]).fit(J.Table({"features": X}))
    jgm.save(str(tmp_path / "jax"))
    tgm = T.GraphModel.load(str(tmp_path / "jax"))
    for node in tgm._nodes:
        node.stage.device = "cpu"
    (a,) = jgm.transform(J.Table({"features": X}))
    (b,) = tgm.transform(T.Table({"features": X}))
    np.testing.assert_allclose(np.asarray(b["unit"]), np.asarray(a["unit"]),
                               rtol=1e-6, atol=1e-6)
    tgm.save(str(tmp_path / "port"))
    again = T.GraphModel.load(str(tmp_path / "port"))
    for node in again._nodes:
        node.stage.device = "cpu"
    (c,) = again.transform(T.Table({"features": X}))
    np.testing.assert_array_equal(np.asarray(c["unit"]),
                                  np.asarray(b["unit"]))


def test_graph_estimator_save_load(tmp_path):
    table, X, y = _blobs()
    b = T.GraphBuilder()
    src = b.source()
    scaled = b.add_stage(StandardScaler(device="cpu")
                         .set_output_col("features"), [src])[0]
    pred = b.add_stage(T.SoftmaxRegression(device="cpu").set_max_iter(20),
                       [scaled])[0]
    b.build([src], [pred]).save(str(tmp_path / "g"))
    graph = T.Graph.load(str(tmp_path / "g"))
    for node in graph._nodes:
        node.stage.device = "cpu"
    model = graph.fit(table)
    p1 = np.asarray(model.transform(table)[0]["prediction"])
    model.save(str(tmp_path / "gm"))
    re_model = T.GraphModel.load(str(tmp_path / "gm"))
    for node in re_model._nodes:
        node.stage.device = "cpu"
    np.testing.assert_array_equal(
        p1, np.asarray(re_model.transform(table)[0]["prediction"]))


class _JoinColumns(T.AlgoOperator):
    def transform(self, *inputs):
        a, b = inputs
        return [a.with_column("extra", np.asarray(b["extra"]) * 10.0)]


@pytest.mark.parametrize("case", ["unknown_input", "unproduced_output",
                                  "arity", "non_stage", "forgotten_source"])
def test_graph_errors(case):
    table, _, _ = _blobs()
    b = T.GraphBuilder()
    src = b.source()
    if case == "unknown_input":
        with pytest.raises(ValueError, match="Unknown input"):
            b.add_stage(StandardScaler(device="cpu"), [T.TableId(999)])
    elif case == "unproduced_output":
        with pytest.raises(ValueError, match="produced by no node"):
            b.build([src], [T.TableId(7)])
    elif case == "arity":
        out = b.add_stage(StandardScaler(device="cpu"), [src])[0]
        with pytest.raises(ValueError, match="Expected 1 input"):
            b.build([src], [out]).fit(table, table)
    elif case == "non_stage":
        with pytest.raises(TypeError):
            b.add_stage(object(), [])
    else:
        s1 = b.source()
        out = b.add_stage(_JoinColumns(), [src, s1])[0]
        with pytest.raises(ValueError, match="neither a build"):
            b.build([src], [out])


def test_multi_input_node_fan_in_and_order():
    rng = np.random.default_rng(0)
    t_a = T.Table({"features": rng.normal(size=(5, 2))})
    t_b = T.Table({"extra": np.arange(5, dtype=np.float64)})
    b = T.GraphBuilder()
    sa, sb = b.source(), b.source()
    joined = b.add_stage(_JoinColumns(), [sa, sb])[0]
    out = b.build([sa, sb], [joined]).fit(t_a, t_b).transform(t_a, t_b)[0]
    np.testing.assert_allclose(np.asarray(out["extra"]), np.arange(5) * 10.0)


# -- Pipeline -----------------------------------------------------------------

class _SumModel(T.Model):
    """``tests/example_stages.py``'s SumModel in the port: adds the learned
    delta to column 'x'."""

    DELTA = T.IntParam("delta", "Value added to inputs", default=0)

    def transform(self, *inputs):
        (table,) = inputs
        return [table.with_column("x", table["x"] + self.get(_SumModel.DELTA))]

    def set_model_data(self, *inputs):
        (table,) = inputs
        self.set(_SumModel.DELTA, int(table["delta"][0]))
        return self

    def get_model_data(self):
        return [T.Table({"delta": np.array([self.get(_SumModel.DELTA)])})]

    def save(self, path):
        from flink_ml_tpu_torch.utils import persist

        persist.save_metadata(self, path)
        persist.save_model_arrays(path, "model",
                                  {"delta": np.array([self.get(_SumModel.DELTA)])})

    @classmethod
    def load(cls, path):
        from flink_ml_tpu_torch.utils import persist

        model = persist.load_stage_param(path)
        data = persist.load_model_arrays(path, "model")
        return model.set(_SumModel.DELTA, int(data["delta"][0]))


class _SumEstimator(T.Estimator):
    def fit(self, *inputs):
        (table,) = inputs
        return _SumModel().set(_SumModel.DELTA, int(np.sum(table["x"])))


class _PlusOne(T.Transformer):
    def transform(self, *inputs):
        (table,) = inputs
        return [table.with_column("x", table["x"] + 1)]


def _x(values):
    return T.Table({"x": np.asarray(values, dtype=np.int64)})


@pytest.mark.parametrize("stages,fit_on,apply_to,want", [
    # fit transforms inputs up to the last estimator only
    ((_PlusOne, _SumEstimator, _PlusOne), [1, 2, 3], [10], [21]),
    ((_SumEstimator,), [1, 2, 3], [0, 1], [6, 7]),
])
def test_pipeline_fit_transform(stages, fit_on, apply_to, want):
    model = T.Pipeline([s() for s in stages]).fit(_x(fit_on))
    assert isinstance(model, T.PipelineModel)
    # no stage has a chain kernel: the stagewise path
    assert model._chain_plan([_x(apply_to)]) is None
    np.testing.assert_array_equal(model.transform(_x(apply_to))[0]["x"],
                                  want)


def test_pipeline_model_chaining_and_save_load(tmp_path):
    from flink_ml_tpu_torch.utils import persist

    chained = T.PipelineModel([_SumModel().set(_SumModel.DELTA, 1),
                               _SumModel().set(_SumModel.DELTA, 10)])
    np.testing.assert_array_equal(chained.transform(_x([5]))[0]["x"], [16])
    pipe = T.Pipeline([_PlusOne(), _SumEstimator()])
    pipe.save(str(tmp_path / "pipeline"))
    loaded = T.Pipeline.load(str(tmp_path / "pipeline"))
    assert [type(s) for s in loaded.stages] == [_PlusOne, _SumEstimator]
    model = loaded.fit(_x([1, 2, 3]))
    np.testing.assert_array_equal(model.transform(_x([0]))[0]["x"], [10])
    model.save(str(tmp_path / "pm"))
    again = T.PipelineModel.load(str(tmp_path / "pm"))
    np.testing.assert_array_equal(again.transform(_x([0]))[0]["x"], [10])
    assert isinstance(persist.load_stage(str(tmp_path / "pm")),
                      T.PipelineModel)
    (data,) = _SumModel().set_model_data(
        T.Table({"delta": np.array([7])})).get_model_data()
    assert int(data["delta"][0]) == 7


def test_pipeline_fit_transform_and_persistence_across_packages(tmp_path):
    """assemble -> scale -> LR: a JAX-saved PipelineModel of feature stages
    plus LR loads in the port with the same predictions; the port's save
    loads in the JAX package."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=128)
    b = rng.normal(size=(128, 2)) * 100
    y = ((a + b[:, 0] / 100) > 0).astype(np.int64)
    cols = {"a": a, "b": b, "label": y}
    from flink_ml_tpu.models.feature import encoders as JE

    jpm = J.Pipeline([
        JE.VectorAssembler().set_input_cols("a", "b").set_features_col("raw"),
        JS.StandardScaler().set_features_col("raw").set_output_col(
            "features"),
        JLR().set_max_iter(30).set_learning_rate(0.5),
    ]).fit(J.Table(cols))
    (jout,) = jpm.transform(J.Table(cols))
    assert np.mean(np.asarray(jout["prediction"]) == y) > 0.9
    jpm.save(str(tmp_path / "jax"))
    tpm = T.PipelineModel.load(str(tmp_path / "jax"), device="cpu")
    assert [s.device for s in tpm.stages] == ["cpu"] * 3
    (tout,) = tpm.transform(T.Table(cols))
    np.testing.assert_array_equal(np.asarray(tout["prediction"]),
                                  np.asarray(jout["prediction"]))
    np.testing.assert_allclose(np.asarray(tout["rawPrediction"]),
                               np.asarray(jout["rawPrediction"]),
                               rtol=1e-6, atol=1e-6)
    assert tpm._chain_plan([T.Table(cols)]).describe() == [("segment", 3)]
    conv = pipeline_model_from_jax(jpm, device="cpu")
    (cout,) = conv.transform(T.Table(cols))
    for c in tout.column_names:
        assert np.array_equal(np.asarray(cout[c]), np.asarray(tout[c])), c

    tpm.save(str(tmp_path / "port"))
    shutil.copytree(tmp_path / "port", tmp_path / "for_jax")
    for root, _, files in os.walk(tmp_path / "for_jax"):
        if "metadata" in files:
            path = os.path.join(root, "metadata")
            meta = json.load(open(path))
            assert meta["className"].startswith("flink_ml_tpu_torch.")
            meta["className"] = "flink_ml_tpu." + \
                meta["className"][len("flink_ml_tpu_torch."):]
            json.dump(meta, open(path, "w"))
    back = J.PipelineModel.load(str(tmp_path / "for_jax"))
    assert type(back.stages[-1]).__module__.startswith("flink_ml_tpu.")
    (bout,) = back.transform(J.Table(cols))
    np.testing.assert_array_equal(np.asarray(bout["prediction"]),
                                  np.asarray(jout["prediction"]))


def test_pipeline_estimator_save_load_with_device(tmp_path):
    X, y = _data(n=100)
    pipe = T.Pipeline([StandardScaler(device="cpu")
                       .set_output_col("features"), _lr()])
    pipe.save(str(tmp_path / "p"))
    loaded = T.Pipeline.load(str(tmp_path / "p"), device="cpu")
    assert [s.device for s in loaded.stages] == ["cpu", "cpu"]
    model = loaded.fit(T.Table({"features": X, "label": y}))
    assert isinstance(model, T.PipelineModel)


def test_plan_cache_guard_and_mixed_schemas():
    X, y = _data(n=64)
    tt = T.Table({"features": X, "label": y})
    s1 = StandardScaler(device="cpu").set_output_col("std").fit(tt)
    nz = (Normalizer(device="cpu").set_features_col("std")
          .set_output_col("n"))
    pm = T.PipelineModel([s1, nz])
    for p in np.linspace(1.0, 4.0, 40):       # param churn
        nz.set_p(float(p))
        pm.transform(tt)
    assert len(pm.__dict__["_chain_plans"]) <= 33
    # a flow of tables with different schemas stays stagewise
    assert pm._chain_plan([tt, tt.drop("label")]) is None


# -- model selection ----------------------------------------------------------

def test_param_grid_builder():
    grid = (T.ParamGridBuilder()
            .add_grid(LogisticRegression.REG, [0.0, 0.1])
            .add_grid(LogisticRegression.MAX_ITER, [5, 10, 20])
            .build())
    assert len(grid) == 6
    assert T.ParamGridBuilder().build() == [{}]
    with pytest.raises(TypeError):
        T.ParamGridBuilder().add_grid("reg", [1])
    with pytest.raises(ValueError):
        T.ParamGridBuilder().add_grid(LogisticRegression.REG, [])
    grid = (T.ParamGridBuilder()
            .add_grid(LogisticRegression.REG, [0.0, 1.0])
            .add_grid(LogisticRegression.REG, [2.0, 3.0]).build())
    assert [g[LogisticRegression.REG] for g in grid] == [2.0, 3.0]


@pytest.mark.parametrize("folds,n", [(4, 103), (3, 400)])
def test_folds_equal_the_jax_packages(folds, n):
    X, y = _data(n=n)
    jcv = JMS.CrossValidator(_lr("jax"), _auc("jax")).set_num_folds(folds) \
        .set_seed(1)
    tcv = TMS.CrossValidator(_lr(), _auc()).set_num_folds(folds).set_seed(1)
    js = jcv._splits(J.Table({"features": X, "label": y}))
    ts = tcv._splits(T.Table({"features": X, "label": y}))
    assert len(ts) == folds
    for (jtr, jva), (ttr, tva) in zip(js, ts):
        assert np.array_equal(np.asarray(jtr["features"]),
                              np.asarray(ttr["features"]))
        assert np.array_equal(np.asarray(jva["features"]),
                              np.asarray(tva["features"]))
    assert sum(v.num_rows for _, v in ts) == n


_GRID = [(1, 1e-4), (20, 0.5)]


@pytest.mark.parametrize("selector", ["cv", "tvs"])
def test_selection_matches_the_jax_package(selector):
    X, y = _data()

    def grid(cls):
        return [{cls.MAX_ITER: it, cls.LEARNING_RATE: lr}
                for it, lr in _GRID]

    if selector == "cv":
        jsel = JMS.CrossValidator(_lr("jax"), _auc("jax"), grid(JLR)) \
            .set_num_folds(3).set_seed(7)
        tsel = TMS.CrossValidator(_lr(), _auc(),
                                  grid(LogisticRegression)) \
            .set_num_folds(3).set_seed(7)
    else:
        jsel = JMS.TrainValidationSplit(_lr("jax"), _auc("jax"), grid(JLR)) \
            .set_train_ratio(0.7).set_seed(3)
        tsel = TMS.TrainValidationSplit(_lr(), _auc(),
                                        grid(LogisticRegression)) \
            .set_train_ratio(0.7).set_seed(3)
    jm = jsel.fit(J.Table({"features": X, "label": y}))
    tm = tsel.fit(T.Table({"features": X, "label": y}))
    assert tm.best_index == jm.best_index == 1
    np.testing.assert_allclose(tm.avg_metrics, jm.avg_metrics,
                               atol=METRIC_TOL)
    assert [np.mean(f) for f in tm.fold_metrics] == tm.avg_metrics
    assert tm.best_model.device == "cpu"
    pred = np.asarray(tm.transform(T.Table({"features": X}))[0]
                      ["prediction"]).ravel()
    assert (pred == y).mean() > 0.9


def test_selector_errors():
    with pytest.raises(ValueError, match="folds"):
        TMS.CrossValidator(_lr(), _auc()).set_num_folds(5).fit(
            T.Table({"features": np.zeros((3, 2)), "label": np.zeros(3)}))
    with pytest.raises(ValueError, match="set_estimator"):
        TMS.CrossValidator().fit(T.Table({"features": np.zeros((3, 2))}))
    with pytest.raises(ValueError, match="empty split"):
        X, y = _data(n=10)
        TMS.TrainValidationSplit(_lr(), _auc()).set_train_ratio(0.001).fit(
            T.Table({"features": X, "label": y}))
    with pytest.raises(ValueError, match="best model"):
        TMS.CrossValidatorModel().transform(T.Table({"x": np.zeros(1)}))


def test_cv_model_save_delegates_to_best(tmp_path):
    X, y = _data()
    t = T.Table({"features": X, "label": y})
    model = TMS.CrossValidator(_lr(), _auc()).set_num_folds(2).fit(t)
    model.save(str(tmp_path / "best"))
    loaded = T.LogisticRegressionModel.load(str(tmp_path / "best"),
                                            device="cpu")
    np.testing.assert_array_equal(
        np.asarray(loaded.transform(t)[0]["prediction"]),
        np.asarray(model.transform(t)[0]["prediction"]))


def test_cv_over_pipeline_clones_children_and_devices():
    X, y = _data()
    t = T.Table({"features": X, "label": y})
    grid = (T.ParamGridBuilder()
            .add_grid(LogisticRegression.MAX_ITER, [1, 20]).build())
    pipe = T.Pipeline([StandardScaler(device="cpu")
                       .set_output_col("features"), _lr()])
    model = (TMS.CrossValidator(pipe, _auc(), grid)
             .set_num_folds(2).set_seed(2).fit(t))
    assert model.best_params[LogisticRegression.MAX_ITER] == 20
    assert [s.device for s in model.best_model.stages] == ["cpu", "cpu"]
    assert pipe.stages[1].get_max_iter() == 15
    pred = np.asarray(model.transform(t)[0]["prediction"]).ravel()
    assert (pred == y).mean() > 0.9


def test_cv_pipeline_binding_rules():
    from flink_ml_tpu_torch.models.clustering.kmeans import KMeansParams
    from flink_ml_tpu_torch.params.shared import HasFeaturesCol

    X, y = _data()
    t = T.Table({"features": X, "label": y, "feat2": X})
    with pytest.raises(ValueError, match="matches no pipeline stage"):
        TMS.CrossValidator(T.Pipeline([_lr()]), _auc(),
                           [{KMeansParams.K: 4}]).set_num_folds(2).fit(t)
    inner = T.Pipeline([_lr()])
    nested = T.Pipeline([StandardScaler(device="cpu")
                         .set_output_col("features"), inner])
    grid = (T.ParamGridBuilder()
            .add_grid(LogisticRegression.MAX_ITER, [1, 20]).build())
    assert (TMS.CrossValidator(nested, _auc(), grid).set_num_folds(2)
            .set_seed(4).fit(t).best_params[LogisticRegression.MAX_ITER]
            == 20)
    pipe = T.Pipeline([StandardScaler(device="cpu").set_output_col("scaled"),
                       _lr()])
    TMS.CrossValidator(pipe, _auc(),
                       [{(1, HasFeaturesCol.FEATURES_COL): "scaled"}]) \
        .set_num_folds(2).fit(t)
    assert pipe.stages[0].get_features_col() == "features"


def test_cv_pipeline_transformer_grid_param_does_not_mutate_original():
    X, y = _data()
    t = T.Table({"features": X, "label": y})
    norm = Normalizer(device="cpu").set_p(2.0).set_output_col("features")
    pipe = T.Pipeline([norm, _lr()])
    c = TMS._clone_with(pipe, {Normalizer.P: 1.0})
    assert c.stages[0].get_p() == 1.0 and norm.get_p() == 2.0
    assert c.stages[0] is not norm and c.stages[0].device == "cpu"
    grid = (T.ParamGridBuilder().add_grid(Normalizer.P, [1.0, 3.0])
            .add_grid(LogisticRegression.MAX_ITER, [1, 20]).build())
    model = (TMS.CrossValidator(pipe, _auc(), grid)
             .set_num_folds(2).set_seed(5).fit(t))
    assert norm.get_p() == 2.0
    assert model.best_params[Normalizer.P] in (1.0, 3.0)


def test_cv_pipeline_fused_scoring_equals_stagewise():
    """Pipeline candidates score through fused segments: fold metrics
    identical to the stagewise path, and every fold's scoring transform
    one dispatch."""
    X, y = _data()
    t = T.Table({"features": X, "label": y})
    grid = (T.ParamGridBuilder()
            .add_grid(LogisticRegression.MAX_ITER, [2, 8]).build())

    def _cv():
        pipe = T.Pipeline([StandardScaler(device="cpu")
                           .set_output_col("features"), _lr()])
        return (TMS.CrossValidator(pipe, _auc(), grid)
                .set_num_folds(4).set_seed(6))

    with TC.chain_disabled():
        ref = _cv().fit(t)
    fused = _cv().fit(t)
    assert fused.fold_metrics == ref.fold_metrics
    assert fused.best_index == ref.best_index
    for train, val in _cv()._splits(t):
        m = T.Pipeline([StandardScaler(device="cpu")
                        .set_output_col("features"),
                        _lr().set_max_iter(2)]).fit(train)
        m.transform(val)
        d0 = TC.dispatch_count()
        (pred,) = m.transform(val)
        assert TC.dispatch_count() - d0 == 1
        with TC.chain_disabled():
            (sw,) = m.transform(val)
        for c in sw.column_names:
            assert np.array_equal(np.asarray(sw[c]), np.asarray(pred[c]))
