"""The port's AgglomerativeClustering against the JAX package's: both run
the pairwise matrix and the Lance-Williams merge loop on the host in
float64 (each through its own ``DistanceMeasure.pairwise_host64``), so
the labels must be equal exactly, for every linkage and measure."""

import json
import os

import numpy as np
import pytest

import flink_ml_tpu as J
import flink_ml_tpu_torch as T
from flink_ml_tpu.models.clustering import (
    AgglomerativeClustering as JAgg, KMeans as JKMeans)
from flink_ml_tpu_torch.models import AgglomerativeClustering as TAgg
from flink_ml_tpu_torch.utils.convert import (algo_operator_from_jax,
                                              pipeline_model_from_jax)

LINKAGES = ("average", "complete", "single", "ward")


def _data(kind):
    rng = np.random.default_rng(7)
    if kind == "blobs":
        centers = rng.normal(size=(5, 6)) * 6
        X = centers[rng.integers(0, 5, 240)] + rng.normal(size=(240, 6))
    elif kind == "far":
        # far from the origin, where an f32 expansion would cancel
        X = 1000.0 + rng.normal(size=(150, 3)) * 0.5
        X[::3] += 4.0
    else:   # an integer grid: many exactly tied distances
        X = rng.integers(0, 4, size=(120, 2)).astype(np.float64)
        X += np.arange(120)[:, None] * 1e-3
    return X


def _labels(cls, table_cls, X, linkage, measure, k):
    op = (cls().set_num_clusters(k).set_linkage(linkage)
          .set_distance_measure(measure))
    return op.transform(table_cls({"features": X}))[0]["prediction"]


@pytest.mark.parametrize("kind", ["blobs", "far", "grid"])
@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
@pytest.mark.parametrize("linkage", LINKAGES)
def test_labels_equal_jax(linkage, measure, kind):
    X = _data(kind)
    for k in (1, 2, 5, 17):
        if linkage == "ward" and measure != "euclidean":
            for cls, tab in ((JAgg, J.Table), (TAgg, T.Table)):
                with pytest.raises(ValueError,
                                   match="ward linkage requires the "
                                         "euclidean measure"):
                    _labels(cls, tab, X, linkage, measure, k)
            return
        want = _labels(JAgg, J.Table, X, linkage, measure, k)
        got = _labels(TAgg, T.Table, X, linkage, measure, k)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) == k


def test_row_guard_and_edges_raise_like_jax():
    big = np.zeros((20_001, 1))
    for cls, tab in ((JAgg, J.Table), (TAgg, T.Table)):
        with pytest.raises(ValueError, match="exceeds the 20000-row guard"):
            cls().transform(tab({"features": big}))
        with pytest.raises(ValueError, match="numClusters=5 exceeds the 3"):
            cls().set_num_clusters(5).transform(
                tab({"features": np.eye(3)}))
        out = cls().transform(tab({"features": np.zeros((0, 2))}))[0]
        assert out["prediction"].shape == (0,)


def test_params_carry_over_and_save(tmp_path):
    """The JAX stage's params into the port's (the converter and a JAX
    save loaded by the port), and the port's save back."""
    jop = (JAgg().set_num_clusters(4).set_linkage("complete")
           .set_distance_measure("cosine").set_prediction_col("cluster"))
    X = _data("blobs")
    for op in (algo_operator_from_jax(jop),
               pipeline_model_from_jax(jop, device="cpu")):
        assert isinstance(op, TAgg)
        np.testing.assert_array_equal(
            op.transform(T.Table({"features": X}))[0]["cluster"],
            jop.transform(J.Table({"features": X}))[0]["cluster"])
    jop.save(str(tmp_path / "j"))
    meta = os.path.join(tmp_path, "j", "metadata")
    with open(meta) as f:
        m = json.load(f)
    m["className"] = m["className"].replace("flink_ml_tpu.",
                                            "flink_ml_tpu_torch.", 1)
    with open(meta, "w") as f:
        json.dump(m, f)
    loaded = TAgg.load(str(tmp_path / "j"))
    assert (loaded.get_num_clusters(), loaded.get_linkage(),
            loaded.get_distance_measure()) == (4, "complete", "cosine")
    loaded.save(str(tmp_path / "t"))
    again = TAgg.load(str(tmp_path / "t"))
    assert again.params_to_json() == loaded.params_to_json()
    with pytest.raises(TypeError, match="not a ported host AlgoOperator"):
        algo_operator_from_jax(JKMeans())
