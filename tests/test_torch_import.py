"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points refuse to run on the CPU unless asked, and
``chip_smoke.py`` fails without a card."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import flink_ml_tpu_torch as T
from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES
from flink_ml_tpu_torch.utils.convert import params_from_jax
from flink_ml_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "flink_ml_tpu_torch")


def _forbidden(name: str) -> bool:
    # exact package names: flink_ml_tpu_torch itself starts with the
    # JAX package's name
    return name.split(".")[0] in ("jax", "jaxlib", "flink_ml_tpu")


def test_import_leaves_jax_out():
    code = ("import sys, flink_ml_tpu_torch, flink_ml_tpu_torch.utils.convert,"
            " flink_ml_tpu_torch.kernels.build,"
            " flink_ml_tpu_torch.ops.emb_grad, flink_ml_tpu_torch.retrieval,"
            " flink_ml_tpu_torch.ops.retrieve, flink_ml_tpu_torch.data.criteo,"
            " flink_ml_tpu_torch.models.evaluation; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=300).stdout.split()
    assert "flink_ml_tpu_torch" in out
    assert [m for m in out if _forbidden(m)] == []


NEW_RUNTIME_MODULES = (
    "flink_ml_tpu_torch.robustness", "flink_ml_tpu_torch.obs",
    "flink_ml_tpu_torch.data.prefetch", "flink_ml_tpu_torch.data.datacache",
    "flink_ml_tpu_torch.data.replay_cache",
    "flink_ml_tpu_torch.iteration.checkpoint",
    "flink_ml_tpu_torch.robustness.supervisor",
    "flink_ml_tpu_torch.obs.probe")


def test_runtime_modules_import_without_jax():
    """The iteration runtime, robustness, observability and out-of-core
    data modules load neither JAX nor the JAX package."""
    code = ("import sys, " + ", ".join(NEW_RUNTIME_MODULES) + "; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=300).stdout.split()
    assert set(NEW_RUNTIME_MODULES) <= set(out)
    assert [m for m in out if _forbidden(m)] == []


STREAM_MODULES = (
    "flink_ml_tpu_torch.data.stream", "flink_ml_tpu_torch.data.wal",
    "flink_ml_tpu_torch.models.classification.online_logisticregression",
    "flink_ml_tpu_torch.models.clustering.online_kmeans")


def test_stream_and_online_modules_import_without_jax():
    """The stream windows, the write-ahead window log and the two online
    estimators load neither JAX nor the JAX package."""
    code = ("import sys, " + ", ".join(STREAM_MODULES) + "; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=300).stdout.split()
    assert set(STREAM_MODULES) <= set(out)
    assert [m for m in out if _forbidden(m)] == []


COMPOSITION_MODULES = (
    "flink_ml_tpu_torch.api.chain", "flink_ml_tpu_torch.api.graph",
    "flink_ml_tpu_torch.api.model_selection",
    "flink_ml_tpu_torch.models.feature",
    "flink_ml_tpu_torch.models.feature.transforms",
    "flink_ml_tpu_torch.models.feature.scalers",
    "flink_ml_tpu_torch.models.feature.online_scaler",
    "flink_ml_tpu_torch.models.feature.pca",
    "flink_ml_tpu_torch.models.feature.vector_ops",
    "flink_ml_tpu_torch.models.feature.encoders",
    "flink_ml_tpu_torch.models.feature.randomsplitter")


def test_composition_and_feature_modules_import_without_jax():
    """The chain, Graph, model selection and the feature stages load
    neither JAX nor the JAX package."""
    code = ("import sys, " + ", ".join(COMPOSITION_MODULES) + "; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=300).stdout.split()
    assert set(COMPOSITION_MODULES) <= set(out)
    assert [m for m in out if _forbidden(m)] == []


SERVING_MODULES = (
    "flink_ml_tpu_torch.serving", "flink_ml_tpu_torch.serving.batcher",
    "flink_ml_tpu_torch.serving.executor",
    "flink_ml_tpu_torch.serving.registry",
    "flink_ml_tpu_torch.serving.endpoint",
    "flink_ml_tpu_torch.serving.scheduler",
    "flink_ml_tpu_torch.serving.embcache",
    "flink_ml_tpu_torch.serving.metrics", "flink_ml_tpu_torch.obs.tree",
    "flink_ml_tpu_torch.utils.metrics", "flink_ml_tpu_torch.ops.int8_serving",
    "flink_ml_tpu_torch.kernels.quantize")


ONLINE_MODULES = (
    "flink_ml_tpu_torch.online", "flink_ml_tpu_torch.online.delta",
    "flink_ml_tpu_torch.online.publish", "flink_ml_tpu_torch.online.staleness",
    "flink_ml_tpu_torch.online.driver", "flink_ml_tpu_torch.autoscale",
    "flink_ml_tpu_torch.autoscale.placement",
    "flink_ml_tpu_torch.autoscale.signals",
    "flink_ml_tpu_torch.autoscale.policy",
    "flink_ml_tpu_torch.autoscale.controller",
    "flink_ml_tpu_torch.serving.failover")


TEXT_SELECTION_MODULES = (
    "flink_ml_tpu_torch.utils.native_text",
    "flink_ml_tpu_torch.models.feature.tokenize",
    "flink_ml_tpu_torch.models.feature.text",
    "flink_ml_tpu_torch.models.feature.sqltransformer",
    "flink_ml_tpu_torch.models.feature.selectors",
    "flink_ml_tpu_torch.models.stats",
    "flink_ml_tpu_torch.models.stats.anovatest",
    "flink_ml_tpu_torch.models.stats.chisqtest",
    "flink_ml_tpu_torch.models.stats.fvaluetest")


@pytest.mark.parametrize("first", [TEXT_SELECTION_MODULES[0],
                                   "flink_ml_tpu_torch.models.stats"])
def test_text_and_selection_modules_import_without_jax(first):
    """The tokenizers, the hashers, SQLTransformer, the selectors and the
    stats tests load neither JAX nor the JAX package, whichever of the
    stats and feature packages is imported first."""
    code = ("import sys, " + first + ", " + ", ".join(TEXT_SELECTION_MODULES)
            + "; print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=300).stdout.split()
    assert set(TEXT_SELECTION_MODULES) <= set(out)
    assert [m for m in out if _forbidden(m)] == []


def test_text_and_selection_device_stages_need_cuda_unless_cpu_asked(
        monkeypatch):
    """IDF's model, the variance and univariate selectors' fits, ANOVATest,
    FValueTest and their scoring functions raise without a card unless the
    CPU is asked for; the host stages take no device."""
    from flink_ml_tpu_torch.models import feature as TF
    from flink_ml_tpu_torch.models import stats as TS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(12, 3))
    y = np.arange(12) % 3
    table = T.Table({"features": X, "label": y})
    counts = T.Table({"features": np.abs(X).round()})
    idf = TF.IDF().fit(counts)
    with pytest.raises(RuntimeError, match="no GPU"):
        idf.transform(counts)
    uni = (TF.UnivariateFeatureSelector().set_feature_type("continuous"))
    calls = [
        lambda: TF.VarianceThresholdSelector().fit(table),
        lambda: uni.set_label_type("categorical").fit(table),
        lambda: uni.set_label_type("continuous").fit(table),
        lambda: TS.ANOVATest().transform(table),
        lambda: TS.FValueTest().transform(table),
        lambda: TS.anova_f_scores(X, y),
        lambda: TS.f_regression_scores(X, y.astype(float)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no GPU"):
            call()
    idf.device = "cpu"
    assert idf.transform(counts)[0]["output"].dtype == np.float64
    cpu_uni = (TF.UnivariateFeatureSelector(device="cpu")
               .set_feature_type("continuous").set_label_type("categorical")
               .set_selection_threshold(1))
    assert cpu_uni.fit(table).get_model_data()[0]["indices"].shape == (1,)
    TS.ChiSqTest().transform(T.Table({"features": X.round(), "label": y}))
    for host in (TF.Tokenizer, TF.RegexTokenizer, TF.NGram,
                 TF.StopWordsRemover, TF.CountVectorizer, TF.HashingTF,
                 TF.FeatureHasher, TF.IndexToString, TF.SQLTransformer,
                 TS.ChiSqTest):
        assert not hasattr(host(), "device"), host


KMEANS_PARALLEL_MODULES = (
    "flink_ml_tpu_torch.parallel", "flink_ml_tpu_torch.parallel.mesh",
    "flink_ml_tpu_torch.parallel.collectives",
    "flink_ml_tpu_torch.parallel.distributed",
    "flink_ml_tpu_torch.data.broadcast", "flink_ml_tpu_torch.utils.backend",
    "flink_ml_tpu_torch.models.clustering.agglomerative",
    "flink_ml_tpu_torch.models.clustering.kmeans",
    "flink_ml_tpu_torch.ops.kmeans")

# a finder that refuses JAX and the JAX package: an import of either fails
_BLOCK_JAX = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'flink_ml_tpu'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, _Block())\n")


@pytest.mark.parametrize("first", [KMEANS_PARALLEL_MODULES[0],
                                   "flink_ml_tpu_torch.models.clustering"])
def test_kmeans_parallel_modules_import_with_jax_blocked(first):
    """The data-parallel modules, AgglomerativeClustering and the KMeans
    modules (k-means++, the bf16 stats, the sharded fit) load with JAX and
    the JAX package blocked, whichever is imported first."""
    code = (_BLOCK_JAX + "import " + first + ", "
            + ", ".join(KMEANS_PARALLEL_MODULES)
            + "\nprint('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=300).stdout.split()
    assert set(KMEANS_PARALLEL_MODULES) <= set(out)
    assert [m for m in out if _forbidden(m)] == []


def test_kmeans_paths_need_cuda_unless_cpu_asked(monkeypatch):
    """k-means++, the bf16 stats kernel's fit and AgglomerativeClustering's
    host work: the KMeans entry points raise without a card unless the CPU
    is asked for; the host stage takes no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(5).normal(size=(40, 3))
    table = T.Table({"features": X})
    for est in (T.KMeans().set_init_mode("k-means++"),
                T.KMeans(compute_dtype=torch.bfloat16)):
        with pytest.raises(RuntimeError, match="no GPU"):
            est.set_k(3).fit(table)
        est.device = "cpu"
        assert est.fit(table).get_model_data()[0]["centroids"].shape == (
            1, 3, 3)
    from flink_ml_tpu_torch.models import AgglomerativeClustering

    agg = AgglomerativeClustering().set_num_clusters(3)
    assert not hasattr(agg, "device")
    assert len(np.unique(agg.transform(table)[0]["prediction"])) == 3


def test_online_autoscale_and_failover_modules_import_without_jax():
    """The continuous-learning modules, the autoscale control plane and
    serving failover load neither JAX nor the JAX package."""
    code = ("import sys, " + ", ".join(ONLINE_MODULES) + "; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=300).stdout.split()
    assert set(ONLINE_MODULES) <= set(out)
    assert [m for m in out if _forbidden(m)] == []


def test_serving_modules_import_without_jax():
    """The serving runtime, the metrics tree, the metric groups and the
    int8 scoring functions load neither JAX nor the JAX package."""
    code = ("import sys, " + ", ".join(SERVING_MODULES) + "; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=300).stdout.split()
    assert set(SERVING_MODULES) <= set(out)
    assert [m for m in out if _forbidden(m)] == []


def test_servables_and_row_cache_need_cuda_unless_cpu_asked(monkeypatch):
    """A servable scores on its model's device, default the card; the row
    cache's pools default to the card; a registry loads saved stages onto
    the card.  Without one each raises unless the CPU is asked for."""
    from flink_ml_tpu_torch.serving import (EmbeddingRowCache, ModelRegistry,
                                            make_servable, serve_model)

    rng = np.random.default_rng(4)
    X = rng.normal(size=(32, 4))
    table = T.Table({"features": X, "label": (X[:, 0] > 0) * 1.0})
    lr = T.LogisticRegression(device="cpu").set_max_iter(1).fit(table)
    km = T.KMeans(device="cpu").set_k(2).set_max_iter(2).fit(table)
    wd_table = T.Table({"denseFeatures": X, "catFeatures":
                        rng.integers(0, 5, size=(32, 2)),
                        "label": table["label"]})
    wd = (T.WideDeep(device="cpu").set_vocab_sizes([5, 5]).set_max_iter(1)
          .fit(wd_table))
    feats = table.drop("label").take(2)
    wd_feats = wd_table.drop("label").take(2)
    assert make_servable(lr, feats).warm_up().ready    # the CPU, asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in (T.LogisticRegressionModel(), T.KMeansModel(),
                  T.WideDeepModel()):
        assert model.device == "cuda"
    for model in (lr, km, wd):
        model.device = "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        make_servable(lr, feats)
    with pytest.raises(RuntimeError, match="no GPU"):
        make_servable(km, feats, precision="int8")
    with pytest.raises(RuntimeError, match="no GPU"):
        make_servable(wd, wd_feats)
    with pytest.raises(RuntimeError, match="no GPU"):
        make_servable(wd, wd_feats, emb_cache=True)
    with pytest.raises(RuntimeError, match="no GPU"):
        serve_model(lr, feats)
    with pytest.raises(RuntimeError, match="no GPU"):
        EmbeddingRowCache({"emb": np.zeros((8, 2), np.float32)})
    assert ModelRegistry().device == "cuda"


def test_fused_pipelines_need_cuda_unless_cpu_asked(monkeypatch):
    """The feature stages, the fused segments and the terminals raise
    without a card unless the CPU is asked for; a plan never falls back
    to the CPU silently."""
    from flink_ml_tpu_torch.api import chain
    from flink_ml_tpu_torch.models.feature import (
        PCA, MinMaxScaler, Normalizer, StandardScaler)
    from flink_ml_tpu_torch.utils.convert import (feature_model_from_jax,
                                                  pipeline_model_from_jax)

    rng = np.random.default_rng(3)
    X = rng.normal(size=(32, 4))
    table = T.Table({"features": X, "label": (X[:, 0] > 0) * 1.0})
    scaler = StandardScaler(device="cpu").set_output_col("s").fit(table)
    lr = (T.LogisticRegression(device="cpu").set_features_col("s")
          .set_max_iter(1).fit(scaler.transform(table)[0]))
    pm = T.PipelineModel([scaler, lr])
    km = T.KMeans(device="cpu").set_k(2).set_max_iter(2).fit(table)
    index = T.IVFIndex.build(X.astype(np.float32), nlist=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        PCA().set_k(2).fit(table)
    with pytest.raises(RuntimeError, match="no GPU"):
        MinMaxScaler().fit(table).transform(table)
    with pytest.raises(RuntimeError, match="no GPU"):
        Normalizer().transform(table)
    for stage in (scaler, lr, km, index):
        stage.device = "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        pm.transform(table)
    with pytest.raises(RuntimeError, match="no GPU"):
        chain.compile_pipeline(pm, table)
    with pytest.raises(RuntimeError, match="no GPU"):
        km.transform(table)
    with pytest.raises(RuntimeError, match="no GPU"):
        index.transform(T.Table({"query": X}))
    with pytest.raises(RuntimeError, match="no GPU"):
        feature_model_from_jax(scaler)
    with pytest.raises(RuntimeError, match="no GPU"):
        pipeline_model_from_jax(pm)


def test_streamed_and_online_fits_need_cuda_unless_cpu_asked(monkeypatch):
    """The streamed KMeans and Wide&Deep fits and the two online learners
    raise without a card unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(16, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no GPU"):
        T.KMeans().set_k(2).fit_outofcore(lambda: iter([{"features": X}]))
    wd = {"denseFeatures": X, "catFeatures": rng.integers(0, 3, (16, 2)),
          "label": np.zeros(16, np.float32)}
    with pytest.raises(RuntimeError, match="no GPU"):
        T.WideDeep().set_vocab_sizes([3, 3]).fit_outofcore(
            lambda: iter([wd]))
    stream = [T.Table({"features": X, "label": np.zeros(16)})]
    with pytest.raises(RuntimeError, match="no GPU"):
        T.OnlineLogisticRegression().fit(iter(stream))
    with pytest.raises(RuntimeError, match="no GPU"):
        T.OnlineKMeans().set_k(2).fit(iter(stream))
    assert T.OnlineKMeans(device="cpu").set_k(2).fit(
        iter(stream)).model_version == 1
    from flink_ml_tpu_torch.online import ContinuousLearner
    from flink_ml_tpu_torch.serving import ModelRegistry

    learner = dict(loss_fn=None, num_features=2, source=iter(stream),
                   wal_dir="unused", registry=ModelRegistry(device="cpu"),
                   batch_rows=16, checkpoint="unused")
    with pytest.raises(RuntimeError, match="no GPU"):
        ContinuousLearner(**learner)
    assert ContinuousLearner(device="cpu", **learner).device == "cpu"


def _py_files(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", [
    *sorted(os.path.relpath(p, REPO) for p in _py_files(PKG)),
    "chip_smoke.py"])
def test_no_jax_import_in_source(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    table = T.Table({"features_dense": rng.normal(size=(8, 2)),
                     "features_indices": rng.integers(2, 128 * 128,
                                                      size=(8, 3)),
                     "label": np.zeros(8)})
    with pytest.raises(RuntimeError, match="no GPU"):
        T.LogisticRegression().set_num_features(128 * 128).fit(table)
    with pytest.raises(RuntimeError, match="no GPU"):
        TS.sgd_fit_mixed(LOSSES["logistic"], table["features_dense"],
                         table["features_indices"], table["label"], None,
                         128 * 128, TS.SGDConfig())
    with pytest.raises(RuntimeError, match="no GPU"):
        params_from_jax({"w": np.zeros(4), "b": np.zeros(())})
    wd_table = T.Table({"denseFeatures": table["features_dense"],
                        "catFeatures": table["features_indices"] % 5,
                        "label": table["label"]})
    with pytest.raises(RuntimeError, match="no GPU"):
        T.WideDeep().set_vocab_sizes([5, 5, 5]).fit(wd_table)
    wd = (T.WideDeep(device="cpu").set_vocab_sizes([5, 5, 5])
          .set_max_iter(1).fit(wd_table))
    wd.device = "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        wd.transform(wd_table)
    model = T.LogisticRegression(device="cpu").set_num_features(
        128 * 128).set_max_iter(1).fit(table)
    model.device = "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        model.transform(table)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no GPU"):
        T.IVFIndex.build(X, nlist=4)
    with pytest.raises(RuntimeError, match="no GPU"):
        T.IVFIndex.build(X, nlist=4, pq=T.PQConfig(m=2, ksub=4))
    index = T.IVFIndex.build(X, nlist=4, device="cpu")
    index.device = "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        index.search(X[:2])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_layouts_and_evaluators_need_cuda_unless_cpu_asked(monkeypatch):
    """The dense and sparse fits, SoftmaxRegression, the device-side
    evaluators and the carried-over softmax model raise without a card
    unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from flink_ml_tpu_torch.models.evaluation import (
        BinaryClassificationEvaluator, ClusteringEvaluator)
    from flink_ml_tpu_torch.utils.convert import softmax_model_from_jax

    rng = np.random.default_rng(1)
    X = rng.normal(size=(16, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    dense = T.Table({"features": X, "label": y})
    pair = T.Table({"features_indices": rng.integers(0, 128 * 128,
                                                     size=(16, 4)),
                    "features_values": rng.normal(size=(16, 4)),
                    "label": y})
    with pytest.raises(RuntimeError, match="no GPU"):
        T.LinearRegression().fit(dense)
    with pytest.raises(RuntimeError, match="no GPU"):
        T.LinearSVC().set_num_features(128 * 128).fit(pair)
    with pytest.raises(RuntimeError, match="no GPU"):
        T.SoftmaxRegression().fit(dense)
    with pytest.raises(RuntimeError, match="no GPU"):
        TS.sgd_fit(LOSSES["squared"], X, y, None, TS.SGDConfig())
    with pytest.raises(RuntimeError, match="no GPU"):
        TS.sgd_fit_sparse(LOSSES["logistic"], pair["features_indices"],
                          pair["features_values"], y, None, 128 * 128,
                          TS.SGDConfig())
    scored = T.Table({"label": y, "rawPrediction": X[:, 0],
                      "features": X, "prediction": y.astype(np.int64)})
    for ev in (BinaryClassificationEvaluator(), ClusteringEvaluator()):
        with pytest.raises(RuntimeError, match="no GPU"):
            ev.transform(scored)
    with pytest.raises(RuntimeError, match="no GPU"):
        softmax_model_from_jax(np.zeros((3, 2)), np.zeros(2), np.arange(2))
    model = T.SoftmaxRegression(device="cpu").set_max_iter(1).fit(dense)
    model.device = "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        model.transform(dense)
    model = T.LinearSVC(device="cpu").set_max_iter(1).fit(dense)
    model.device = "cuda"
    with pytest.raises(RuntimeError, match="no GPU"):
        model.transform(dense)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; chip_smoke.py runs for real")
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
