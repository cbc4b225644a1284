"""The port's kernel registry (``flink_ml_tpu_torch/kernels/registry.py``
and ``catalog.py``) on the CPU, mirroring ``tests/test_kernels.py``'s
mechanics against the JAX registry.

What these tests pin down:

- registry mechanics: priority / availability / supports selection,
  forced backends (bypass availability, never supports), loud failures;
- the catalog registers every op of the JAX catalog, each with a backend
  available on this host, and the device in the signature gates the
  ``"cuda"`` entries (a forced ``"cuda"`` at a CPU signature raises);
- every consumer resolves through the registry to the registered
  functions (fn identity, and spies on the entries during real fits);
- with no cache root the CPU picks are ``"plain"`` for the nine kernels
  and ``"segsum"`` for GBT;
- each op's default CPU entry against the JAX package's ``"xla"`` entry
  on the same numpy-seeded inputs, tolerances stated per op;
- dispatch accounting: the first run of a ``(plan, shapes)`` key counts
  as a compile, a repeat as a cache hit, and ``thread_counts`` is per
  thread.

The JAX lowering-counter asserts of ``tests/test_kernels.py`` have no
counterpart: eager torch lowers nothing.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu.kernels.registry import lookup as jlookup
from flink_ml_tpu_torch.kernels import aot
from flink_ml_tpu_torch.kernels import registry as kreg
from flink_ml_tpu_torch.kernels.registry import (KernelEntry, dispatch,
                                                 kernel_stats, lookup,
                                                 register_kernel)
from flink_ml_tpu_torch.ops import ell_scatter as TE
from flink_ml_tpu_torch.ops import emb_grad as TG
from flink_ml_tpu_torch.ops import kmeans as TK


@pytest.fixture(autouse=True)
def _no_cache_root():
    """Every test here runs with no cache root (the static priorities)."""
    aot.set_cache(None)
    yield
    aot.reset_cache()


# ---------------------------------------------------------------------------
# registry mechanics
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _temp_op(entries):
    """Register throwaway entries under a test-only op and drop them."""
    op = "_test_op_"
    for e in entries:
        register_kernel(op, **e)
    try:
        yield op
    finally:
        kreg._REGISTRY.pop(op, None)


def test_lookup_picks_priority_available_supported():
    with _temp_op([
        dict(backend="slow", fn=lambda: "slow", priority=0),
        dict(backend="fast", fn=lambda: "fast", priority=10),
        dict(backend="faster-elsewhere", fn=lambda: "x", priority=20,
             available=lambda: False),
        dict(backend="faster-elsewhen", fn=lambda: "y", priority=30,
             supports=lambda sig: False),
    ]) as op:
        assert lookup(op).backend == "fast"
        # forced backend bypasses availability...
        assert lookup(op, backend="faster-elsewhere").backend == \
            "faster-elsewhere"
        # ...but a provided sig still gates the shape contract
        with pytest.raises(ValueError, match="does not support"):
            lookup(op, sig=("some-shape",), backend="faster-elsewhen")
        # ...and with no sig the caller owns the choice entirely
        assert lookup(op, backend="faster-elsewhen").backend == \
            "faster-elsewhen"


def test_lookup_ties_break_by_backend_name():
    with _temp_op([dict(backend="b", fn=lambda: "b", priority=5),
                   dict(backend="a", fn=lambda: "a", priority=5)]) as op:
        assert lookup(op).backend == "a"


def test_lookup_failures_are_loud():
    with pytest.raises(KeyError, match="unknown kernel op"):
        lookup("_no_such_op_")
    with _temp_op([
        dict(backend="narrow", fn=lambda: 0,
             supports=lambda sig: sig == ("ok",)),
    ]) as op:
        with pytest.raises(KeyError, match="no backend"):
            lookup(op, backend="missing")
        with pytest.raises(ValueError, match="no available backend"):
            lookup(op, sig=("nope",))
        assert lookup(op, sig=("ok",)).backend == "narrow"
    with pytest.raises(ValueError, match="unknown convention"):
        register_kernel("_test_op_", "x", lambda: 0, convention="jit")


def test_register_replaces_same_backend():
    with _temp_op([dict(backend="torch", fn=lambda: 1)]) as op:
        register_kernel(op, "torch", lambda: 2)
        assert len(kreg._REGISTRY[op]) == 1
        assert lookup(op, backend="torch").fn() == 2


# ---------------------------------------------------------------------------
# the catalog and the device gate
# ---------------------------------------------------------------------------

JAX_OPS = ("ell_margin", "ell_scatter_apply", "gbt_level_histograms",
           "kmeans_assign", "kmeans_update_stats", "kmeans_workset_update",
           "linear_margins", "retrieve", "routed_table_grad",
           "widedeep_scores")

#: a CPU and a CUDA signature of every op that holds one of the nine
#: kernels (B1-B9), and the kernels' backends there
KERNEL_SIGS = {
    "ell_margin": ((128, "cpu"), (128, "cuda"), ("cuda",)),
    "ell_scatter_apply": ((128, "cpu"), (128, "cuda"),
                          ("cuda", "cuda-pair")),
    "kmeans_update_stats": ((1 << 16, 64, 256, "euclidean", "cpu"),
                            (1 << 16, 64, 256, "euclidean", "cuda"),
                            ("cuda",)),
    "kmeans_assign": (("euclidean", "cpu"), ("euclidean", "cuda"),
                      ("cuda",)),
    "kmeans_workset_update": ((1 << 16, 64, 256, "euclidean", 1, "cpu"),
                              (1 << 16, 64, 256, "euclidean", 1, "cuda"),
                              ("cuda",)),
    "routed_table_grad": (("gather", 3, 1024, "cpu"),
                          ("gather", 3, 1024, "cuda"), ("cuda",)),
    "retrieve": ((2, 10, 64, 0, 0, 256, 1024, "cpu"),
                 (2, 10, 64, 0, 0, 256, 1024, "cuda"), ("cuda",)),
}


def test_catalog_registers_every_jax_op_with_a_cpu_backend():
    ops = kreg.ops()
    assert set(JAX_OPS) <= set(ops), set(JAX_OPS) - set(ops)
    for op in JAX_OPS:
        assert any(e.is_available() for e in kreg._REGISTRY[op].values()), \
            f"op {op} has no available backend on this host"
    # the JAX catalog's ops, and no op the JAX registry lacks
    from flink_ml_tpu.kernels import registry as jreg

    assert set(JAX_OPS) == {o for o in jreg.ops()
                            if not o.startswith("_test_")}
    assert {o for o in ops if not o.startswith("_test_")} == set(JAX_OPS)


@pytest.mark.parametrize("op", sorted(KERNEL_SIGS))
def test_forced_cuda_at_a_cpu_signature_raises(op):
    cpu_sig, cuda_sig, kernels = KERNEL_SIGS[op]
    for backend in kernels:
        with pytest.raises(ValueError, match="does not support"):
            lookup(op, sig=cpu_sig, backend=backend)
        assert lookup(op, sig=cuda_sig, backend=backend).backend == backend


@pytest.mark.parametrize("op", sorted(KERNEL_SIGS))
def test_cpu_picks_are_plain_without_a_cache_root(op):
    cpu_sig, cuda_sig, kernels = KERNEL_SIGS[op]
    assert lookup(op, sig=cpu_sig).backend == "plain"
    for backend in kernels:
        entry = kreg._REGISTRY[op][backend]
        # a card present or not, a CPU signature never reaches a kernel
        assert not entry.supports_sig(cpu_sig)
        assert entry.supports_sig(cuda_sig)
        assert entry.available is kreg.cuda_only
    if not torch.cuda.is_available():
        # no card: the kernels are not available, the CUDA signature
        # resolves nowhere but the plain twin
        assert lookup(op, sig=cuda_sig).backend == "plain"


def test_ell_pair_and_fused_grid_contract():
    assert kreg._REGISTRY["ell_scatter_apply"]["cuda"].supports_sig(
        (128, "cuda"))
    assert not kreg._REGISTRY["ell_scatter_apply"]["cuda"].supports_sig(
        (1001, "cuda"))
    assert kreg._REGISTRY["ell_scatter_apply"]["cuda-pair"].supports_sig(
        (1001, "cuda"))


def test_gbt_and_stage_ops_without_a_cache_root():
    from flink_ml_tpu_torch.models.common import gbt

    assert lookup("gbt_level_histograms").backend == "segsum"
    assert gbt.resolve_hist_impl("auto") == "segsum"
    assert lookup("linear_margins", sig=("cpu",)).backend == "torch"
    assert lookup("widedeep_scores", sig=("cpu",)).backend == "torch"
    assert lookup("kmeans_assign", sig=("cosine", "cpu")).backend == "plain"
    assert lookup("kmeans_update_stats",
                  sig=(64, 4, 2, "cosine", "cpu")).backend == "torch"
    for op in ("linear_margins", "kmeans_assign", "widedeep_scores"):
        entry = kreg._REGISTRY[op]["int8"]
        assert not entry.is_available()        # forced lookup only
        assert lookup(op, backend="int8") is entry


# ---------------------------------------------------------------------------
# consumers resolve the registry's entries
# ---------------------------------------------------------------------------

def test_registry_entries_are_the_implementations():
    from flink_ml_tpu_torch.models.clustering import kmeans as TKM
    from flink_ml_tpu_torch.models.common import gbt, linear
    from flink_ml_tpu_torch.models.recommendation import widedeep
    from flink_ml_tpu_torch.ops import int8_serving as I8
    from flink_ml_tpu_torch.retrieval import ivf

    fn = {(op, b): e.fn for op, t in kreg._REGISTRY.items()
          for b, e in t.items()}
    assert fn["ell_margin", "cuda"] is TE._ell_margin_cuda
    assert fn["ell_margin", "plain"] is TE.ell_margin_plain
    assert fn["ell_scatter_apply", "cuda"] is TE._ell_scatter_fused_cuda
    assert fn["ell_scatter_apply", "cuda-pair"] is \
        TE._ell_scatter_pair_entry
    assert fn["ell_scatter_apply", "plain"] is \
        TE.ell_scatter_apply_plain_entry
    assert fn["routed_table_grad", "cuda"] is TG.routed_apply_cuda
    assert fn["routed_table_grad", "plain"] is TG.routed_apply_plain
    assert fn["kmeans_update_stats", "cuda"] is TK._update_stats_cuda
    assert fn["kmeans_update_stats", "plain"] is TK.kmeans_update_stats_plain
    assert fn["kmeans_update_stats", "torch"] is TKM._assign_stats
    assert fn["kmeans_workset_update", "cuda"] is TK._workset_update_cuda
    assert fn["kmeans_workset_update", "plain"] is \
        TK.kmeans_workset_update_plain
    assert fn["kmeans_assign", "cuda"] is TKM._kmeans_assign_cuda
    assert fn["kmeans_assign", "plain"] is TKM._kmeans_assign_plain
    assert fn["gbt_level_histograms", "segsum"] is \
        gbt._level_histograms_segsum
    assert fn["gbt_level_histograms", "mxu"] is gbt._level_histograms_mxu
    assert fn["linear_margins", "torch"] is linear._linear_chain_kernel
    assert fn["widedeep_scores", "torch"] is widedeep._widedeep_chain_kernel
    assert fn["retrieve", "cuda"] is ivf._retrieve_stage_cuda
    assert fn["retrieve", "plain"] is ivf._retrieve_stage_plain
    assert fn["linear_margins", "int8"] is I8.int8_linear_margins
    assert fn["kmeans_assign", "int8"] is I8.int8_kmeans_assign
    assert fn["widedeep_scores", "int8"] is I8.int8_widedeep_scores
    for op in ("kmeans_assign", "linear_margins", "retrieve",
               "widedeep_scores"):
        assert all(e.convention == "stage"
                   for e in kreg._REGISTRY[op].values())


@contextlib.contextmanager
def _spy(op, backend):
    """Count the calls of one registered entry (the entry re-registered
    with a counting wrapper, restored after)."""
    entry = kreg._REGISTRY[op][backend]
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return entry.fn(*a, **k)

    register_kernel(op, backend, counted, priority=entry.priority,
                    supports=entry.supports, available=entry.available,
                    convention=entry.convention)
    try:
        yield calls
    finally:
        kreg._REGISTRY[op][backend] = entry


def test_mixed_ell_fit_resolves_both_ell_ops():
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.models.common.sgd import SGDConfig, sgd_fit_mixed

    rng = np.random.default_rng(0)
    n, nd, d = 256, 3, 128 * 128
    dense = rng.normal(size=(n, nd)).astype(np.float32)
    cat = rng.integers(nd, d, size=(n, 4)).astype(np.int32)
    y = (dense[:, 0] > 0).astype(np.float64)
    cfg = SGDConfig(learning_rate=0.3, max_epochs=2, global_batch_size=64,
                    tol=0, seed=0)
    with _spy("ell_margin", "plain") as margin, \
            _spy("ell_scatter_apply", "plain") as scatter:
        state, _ = sgd_fit_mixed(LOSSES["logistic"], dense, cat, y, None, d,
                                 cfg, device="cpu")
    assert state.planned_impl == "ell"
    assert len(margin) == len(scatter) == 8      # 4 steps x 2 epochs


def test_wide_deep_fit_resolves_the_routed_gradient():
    from flink_ml_tpu_torch.data.table import Table
    from flink_ml_tpu_torch.models.recommendation.widedeep import WideDeep

    rng = np.random.default_rng(1)
    n, vocab = 64, [7, 5]
    table = Table({
        "denseFeatures": rng.normal(size=(n, 3)).astype(np.float32),
        "catFeatures": np.stack([rng.integers(0, v, size=n)
                                 for v in vocab], 1).astype(np.int32),
        "label": (rng.random(n) > 0.5).astype(np.float64)})
    with _spy("routed_table_grad", "plain") as routed:
        WideDeep(device="cpu").set_vocab_sizes(vocab).set_max_iter(
            1).fit(table)
    assert routed, "the Wide&Deep step never resolved routed_table_grad"


def test_kmeans_and_retrieve_resolve_their_ops():
    from flink_ml_tpu_torch.models.clustering import kmeans as TKM
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.retrieval import IVFIndex

    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.normal(size=(1 << 16, 2)).astype(np.float32))
    init = pts[:3].clone()
    measure = DistanceMeasure.get_instance("euclidean")
    plan = TKM._fit_plan(pts.shape[0], 2, 3, measure)
    assert plan.impl == "kernel"
    ones = torch.ones(pts.shape[0])
    with _spy("kmeans_update_stats", "plain") as stats:
        TKM.fit_centroids(pts, ones, init, plan, measure=measure,
                          max_iter=2)
    assert len(stats) == 2
    ws = TKM._fit_plan(pts.shape[0], 2, 3, measure, workset=True)
    with _spy("kmeans_workset_update", "plain") as rounds:
        TKM.fit_centroids(pts, ones, init, ws, measure=measure,
                          max_iter=2, workset=True)
    assert rounds
    X = rng.normal(size=(300, 8)).astype(np.float32)
    index = IVFIndex.build(X, nlist=4, k=5, nprobe=2, seed=0, device="cpu")
    with _spy("retrieve", "plain") as searches:
        index.transform(__import__(
            "flink_ml_tpu_torch").Table({"query": X[:7]}))
    assert len(searches) == 1
    assert index.search_plan().backend == "plain"


def test_gbt_auto_resolves_through_lookup():
    from flink_ml_tpu_torch.models.common import gbt

    entry = kreg._REGISTRY["gbt_level_histograms"]["mxu"]
    register_kernel("gbt_level_histograms", "mxu", entry.fn, priority=99)
    try:
        assert gbt.resolve_hist_impl("auto") == "mxu"
    finally:
        kreg._REGISTRY["gbt_level_histograms"]["mxu"] = entry
    assert gbt.resolve_hist_impl("auto") == "segsum"
    with pytest.raises(KeyError):
        gbt.resolve_hist_impl("bogus")


# ---------------------------------------------------------------------------
# each op's CPU entry against the JAX package's "xla" entry
# ---------------------------------------------------------------------------

def _ell_case(seed, d=128 * 128, batch=200, nnz=7, with_val=False):
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, d, size=(1, batch, nnz)).astype(np.int32)
    vals = (rng.normal(size=cat.shape).astype(np.float32) if with_val
            else None)
    lay = TE.ell_layout(cat, d, values=vals)
    w = rng.normal(size=d).astype(np.float32)
    return rng, lay, w


@pytest.mark.parametrize("with_val", [False, True])
def test_ell_margin_cpu_entry_matches_jax_xla(with_val):
    """Tolerance: 1e-5 relative (the JAX twin scatter-adds the slots, the
    port sums each sample's slots in grid order), over the batch's
    entries."""
    _, lay, w = _ell_case(3, with_val=with_val)
    m_len = lay.batch + 8
    val = None if lay.val is None else torch.from_numpy(lay.val[0])
    route_w, route_val = TE.sample_routing(
        torch.from_numpy(lay.src[0]), torch.from_numpy(lay.pos[0]),
        torch.from_numpy(lay.mask[0]), lay.batch, val=val)
    entry = lookup("ell_margin", sig=(w.size // 128, "cpu"))
    got = entry.fn(torch.from_numpy(w), route_w, m_len=m_len,
                   route_val=route_val).numpy()[:lay.batch]
    want = np.asarray(jlookup("ell_margin", backend="xla").fn(
        jnp.asarray(w), jnp.asarray(lay.src[0]), jnp.asarray(lay.pos[0]),
        jnp.asarray(lay.mask[0]), m_len=m_len,
        val=None if lay.val is None else jnp.asarray(lay.val[0])))
    # entries past the batch are the pads' (callers slice [:batch])
    np.testing.assert_allclose(got, want[:lay.batch], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [128 * 128, 1001 * 128])
@pytest.mark.parametrize("with_val", [False, True])
def test_ell_scatter_cpu_entry_matches_jax_xla(d, with_val):
    """Both grids (whole 8-row blocks: the fused plain version; 1001 rows:
    the gather + pair one).  Tolerance: 1e-6 relative (the fused twin
    multiplies ``-lr * r`` before the value, the JAX XLA twin after)."""
    rng, lay, w = _ell_case(4, d=d, with_val=with_val)
    r_ext = rng.normal(size=lay.batch + 8).astype(np.float32)
    rows = lay.src.shape[1]
    entry = lookup("ell_scatter_apply", sig=(rows, "cpu"))
    assert entry.backend == "plain"
    val = None if lay.val is None else lay.val[0]
    got = entry.fn(torch.from_numpy(w), torch.from_numpy(r_ext),
                   torch.from_numpy(lay.src[0]), torch.from_numpy(lay.pos[0]),
                   torch.from_numpy(lay.mask[0]), lr=0.25,
                   val=None if val is None else torch.from_numpy(val))
    want = jlookup("ell_scatter_apply", backend="xla").fn(
        jnp.asarray(w), jnp.asarray(r_ext), jnp.asarray(lay.src[0]),
        jnp.asarray(lay.pos[0]), jnp.asarray(lay.mask[0]), lr=0.25,
        val=None if val is None else jnp.asarray(val))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("placement", ["gather", "scatter"])
def test_routed_table_grad_cpu_entry_matches_jax_xla(placement):
    """Tolerance 0: the plain fold is the JAX fold's tree, bit for bit."""
    from flink_ml_tpu.ops import emb_grad as JG

    rng = np.random.default_rng(5)
    cat = rng.integers(0, 300, size=(2, 25, 26))
    cat[1, :, 3] = 42
    jr = JG.emb_grad_route(cat, 300, placement=placement)
    tr = TG.emb_grad_route(cat, 300, placement=placement)
    g = rng.normal(size=(25 * 26, 8)).astype(np.float32)
    for s in range(2):
        entry = lookup("routed_table_grad",
                       sig=tr.kernel_sig("cpu"))
        assert entry.backend == "plain"
        got = entry.fn(tr, torch.from_numpy(g), *tr.step_slice(s))
        want = jlookup("routed_table_grad", backend="xla").fn(
            jr, jnp.asarray(g), *(jnp.asarray(np.asarray(a))
                                  for a in jr.step_slice(s)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", ["segsum", "mxu"])
def test_gbt_histograms_match_jax_xla(backend):
    """Tolerance: 1e-5 relative (f32 sums in different orders)."""
    rng = np.random.default_rng(6)
    n, d, bins, nodes = 500, 5, 16, 4
    binned = rng.integers(0, bins, size=(n, d)).astype(np.int32)
    ids = rng.integers(-1, nodes, size=n).astype(np.int32)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    got = lookup("gbt_level_histograms", backend=backend).fn(
        torch.from_numpy(binned), torch.from_numpy(ids), torch.from_numpy(g),
        torch.from_numpy(h), nodes, d, bins)
    want = jlookup("gbt_level_histograms", backend="xla").fn(
        jnp.asarray(binned), jnp.asarray(ids), jnp.asarray(g),
        jnp.asarray(h), nodes, d, bins)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def _km_case(seed=7, n=400, d=6, k=5):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    cents = rng.normal(size=(k, d)).astype(np.float32)
    return rng, pts, cents


def test_kmeans_update_stats_cpu_entries_match_jax_xla():
    """The "plain" twin (first-index ties) and the generic "torch" body
    against the JAX "xla" body.  Tolerance: 1e-5 relative on the sums,
    counts exact."""
    from flink_ml_tpu.distance import DistanceMeasure as JD
    from flink_ml_tpu_torch.distance import DistanceMeasure as TD

    _, pts, cents = _km_case()
    k = cents.shape[0]
    mask = np.ones(pts.shape[0], np.float32)
    ws, wc = jlookup("kmeans_update_stats", backend="xla").fn(
        JD.get_instance("euclidean"), k, jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(cents))
    sig = (pts.shape[0], pts.shape[1], k, "euclidean", "cpu")
    entry = lookup("kmeans_update_stats", sig=sig)
    assert entry.backend == "plain"
    ps, pc = entry.fn(torch.from_numpy(pts), torch.from_numpy(cents),
                      tie_policy="first")
    gs, gc = lookup("kmeans_update_stats", backend="torch").fn(
        TD.get_instance("euclidean"), k, torch.from_numpy(pts),
        torch.from_numpy(mask), torch.from_numpy(cents))
    for sums, counts in ((ps, pc), (gs, gc)):
        np.testing.assert_array_equal(counts.numpy(), np.asarray(wc))
        np.testing.assert_allclose(sums.numpy(), np.asarray(ws), rtol=1e-5,
                                   atol=1e-5)


def test_kmeans_workset_cpu_entry_matches_jax_xla():
    """Tolerance: assignments exact, distances and sums 1e-5 relative."""
    from flink_ml_tpu.distance import DistanceMeasure as JD

    rng, pts, cents = _km_case(8)
    n, k = pts.shape[0], cents.shape[0]
    prev = rng.integers(0, k, size=n).astype(np.int32)
    active = (rng.random(n) > 0.4).astype(np.float32)
    pad = (np.arange(n) < n - 7).astype(np.float32)
    want = jlookup("kmeans_workset_update", backend="xla").fn(
        JD.get_instance("euclidean"), k, *(jnp.asarray(a) for a in
                                           (pts, cents, prev, active, pad)))
    entry = lookup("kmeans_workset_update",
                   sig=(n, pts.shape[1], k, "euclidean", 1, "cpu"))
    assert entry.backend == "plain"
    got = entry.fn(*(torch.from_numpy(a) for a in
                     (pts, cents, prev, active, pad)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("measure", ["euclidean", "cosine", "manhattan"])
def test_kmeans_assign_cpu_stage_matches_jax_xla(measure):
    """Tolerance 0: the same argmin of the same pairwise distances."""
    from flink_ml_tpu.distance import DistanceMeasure as JD

    _, pts, cents = _km_case(9)
    want = jlookup("kmeans_assign", backend="xla").fn(
        ("f", "a", JD.get_instance(measure)),
        {"centroids": jnp.asarray(cents)}, {"f": jnp.asarray(pts)})["a"]
    entry = lookup("kmeans_assign", sig=(measure, "cpu"))
    assert entry.backend == "plain"
    got = entry.fn(("f", "a", measure),
                   {"centroids": torch.from_numpy(cents)},
                   {"f": torch.from_numpy(pts)})["a"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_linear_margins_cpu_stage_matches_jax_xla():
    """Tolerance: 1e-5 relative (one f32 matvec each)."""
    rng = np.random.default_rng(10)
    X = rng.normal(size=(33, 6)).astype(np.float32)
    w = rng.normal(size=6).astype(np.float32)
    want = jlookup("linear_margins", backend="xla").fn(
        ("f", "m"), {"w": jnp.asarray(w), "b": jnp.float32(0.5)},
        {"f": jnp.asarray(X)})["m"]
    got = lookup("linear_margins", sig=("cpu",)).fn(
        ("f", "m"), {"w": torch.from_numpy(w), "b": torch.tensor(0.5)},
        {"f": torch.from_numpy(X)})["m"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_widedeep_scores_cpu_stage_matches_jax_xla():
    """Tolerance: 1e-5 relative on the sigmoid scores."""
    from flink_ml_tpu.models.recommendation import widedeep as JW
    from flink_ml_tpu_torch.utils.convert import widedeep_params_from_jax

    rng = np.random.default_rng(11)
    vocab = [9, 4, 6]
    net = JW.init_params(rng, 5, vocab, 4, (16, 8))
    offsets = JW._field_offsets(vocab)
    dense = rng.normal(size=(20, 5)).astype(np.float32)
    cat = np.stack([rng.integers(0, v, size=20) for v in vocab],
                   1).astype(np.int32)
    want = jlookup("widedeep_scores", backend="xla").fn(
        ("d", "c", "s"),
        {"net": jax.tree_util.tree_map(jnp.asarray, net),
         "offsets": jnp.asarray(offsets)},
        {"d": jnp.asarray(dense), "c": jnp.asarray(cat)})["s"]
    got = lookup("widedeep_scores", sig=("cpu",)).fn(
        ("d", "c", "s"),
        {"net": widedeep_params_from_jax(net, "cpu"),
         "offsets": torch.from_numpy(offsets)},
        {"d": torch.from_numpy(dense), "c": torch.from_numpy(cat)})["s"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("pq", [False, True])
def test_retrieve_cpu_stage_matches_jax_xla(pq):
    """Tolerance: ids exact; distances within 1e-5 of ``|q|^2 + max|x|^2``
    (flat) or 1e-5 relative (PQ), ``tests/test_torch_retrieve_ops.py``'s
    tolerance against the jitted XLA stage."""
    from flink_ml_tpu.parallel.mesh import device_mesh, use_mesh
    from flink_ml_tpu.retrieval import IVFIndex as JIVF
    from flink_ml_tpu.retrieval import PQConfig as JPQ
    from flink_ml_tpu.retrieval import ivf as JI
    from flink_ml_tpu_torch.retrieval import ivf as TI
    from flink_ml_tpu_torch.utils.convert import ivf_index_from_jax

    rng = np.random.default_rng(12)
    X = rng.normal(size=(600, 32)).astype(np.float32)
    q = rng.normal(size=(16, 32)).astype(np.float32)
    with use_mesh(device_mesh({"data": 1}, devices=jax.devices()[:1])):
        jidx = JIVF.build(X, nlist=8, k=10, nprobe=4, seed=1,
                          pq=JPQ(m=8, ksub=16) if pq else None)
    p = {k: jnp.asarray(v) for k, v in jidx.params.items()}
    want = jax.jit(lambda pp, c: jlookup(
        "retrieve", sig=jidx.sig(), backend="xla").fn(jidx._static(), pp, c))(
        p, {jidx.query_col: jnp.asarray(q)})
    tidx = ivf_index_from_jax(
        jidx.params, nlist=jidx.nlist, block=jidx.block, dim=jidx.dim,
        k=jidx.k, nprobe=jidx.nprobe, pq=jidx.pq, seed=jidx.seed,
        list_slack=jidx.list_slack, drift_threshold=jidx.drift_threshold,
        max_iter=jidx.max_iter, stored=jidx.stored_vectors(), device="cpu")
    kernel = tidx.transform_kernel({"query": ((32,), np.dtype(np.float32))})
    entry = lookup("retrieve", tidx.sig() + ("cpu",))
    assert entry.backend == "plain"
    got = entry.fn(kernel.static, tidx.device_params(),
                   {"query": torch.from_numpy(q)})
    np.testing.assert_array_equal(got[TI._NN_STAGE].numpy(),
                                  np.asarray(want[JI._NN_STAGE]))
    dist, wdist = got[TI._DIST_STAGE].numpy(), np.asarray(want[JI._DIST_STAGE])
    fin = np.isfinite(wdist)
    np.testing.assert_array_equal(np.isfinite(dist), fin)
    if pq:
        np.testing.assert_allclose(dist[fin], wdist[fin], rtol=1e-5, atol=0)
    else:
        scale = (np.sum(q.astype(np.float64) ** 2, 1)[:, None]
                 + np.max(np.sum(X.astype(np.float64) ** 2, 1)))
        err = np.abs(dist - wdist)[fin]
        assert np.all(err <= 1e-5 * np.broadcast_to(scale, dist.shape)[fin])


# ---------------------------------------------------------------------------
# dispatch accounting
# ---------------------------------------------------------------------------

def _scale(static, params, cols):
    (src, dst) = static
    return {dst: cols[src] * params["a"]}


def test_dispatch_counts_compiles_and_cache_hits():
    plan = ((_scale, ("_acct_a", "_acct_b")),)
    params = ({"a": torch.tensor(2.0)},)
    cols = {"_acct_a": torch.ones(16)}
    before = kernel_stats.snapshot()
    d0 = kreg.dispatch_count()
    out1 = dispatch(plan, params, cols, op="_acct_op")
    mid = kernel_stats.snapshot()
    assert mid["compiles"] == before["compiles"] + 1
    out2 = dispatch(plan, params, cols, op="_acct_op")
    after = kernel_stats.snapshot()
    assert after["compiles"] == mid["compiles"]          # cache hit
    assert after["cache_hits"] == mid["cache_hits"] + 1
    assert after["per_op"]["_acct_op"]["dispatches"] >= 2
    assert after["dispatch_latency_ms"] > 0.0
    assert kreg.dispatch_count() == d0 + 2
    assert torch.equal(out1["_acct_b"], out2["_acct_b"])
    assert torch.equal(out1["_acct_b"], torch.full((16,), 2.0))
    # a different shape on the same plan is a new key
    dispatch(plan, params, {"_acct_a": torch.ones(32)}, op="_acct_op")
    assert kernel_stats.snapshot()["compiles"] == after["compiles"] + 1
    # so is a different dtype
    dispatch(plan, params, {"_acct_a": torch.ones(32, dtype=torch.float64)},
             op="_acct_op")
    assert kernel_stats.snapshot()["compiles"] == after["compiles"] + 2


def test_chain_reexports_the_registry_dispatch_count():
    from flink_ml_tpu_torch.api import chain

    assert chain.dispatch_count is kreg.dispatch_count


def test_thread_counts_are_per_thread():
    plan = ((_scale, ("_tls_a", "_tls_b")),)
    params = ({"a": torch.tensor(3.0)},)
    seen = {}

    def worker(name, n, rows):
        c0 = kernel_stats.thread_counts()
        for _ in range(n):
            dispatch(plan, params, {"_tls_a": torch.ones(rows)})
        c1 = kernel_stats.thread_counts()
        seen[name] = tuple(b - a for a, b in zip(c0, c1))

    threads = [threading.Thread(target=worker, args=("x", 3, 5)),
               threading.Thread(target=worker, args=("y", 2, 6))]
    main0 = kernel_stats.thread_counts()
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert kernel_stats.thread_counts() == main0     # nothing on this one
    assert seen["x"] == (1, 0, 2) and seen["y"] == (1, 0, 1)


def test_snapshot_carries_launches_and_publishes():
    from flink_ml_tpu_torch.obs import tree
    from flink_ml_tpu_torch.serving.metrics import ServingMetrics

    snap = kernel_stats.snapshot()
    assert set(snap["launches"]) >= set(TK.LAUNCHES) | set(TE.LAUNCHES)
    assert set(snap["aot"]) == {"hits", "misses", "stores", "store_failed",
                                "quarantined", "unserializable", "load_ms",
                                "compile_ms"}
    assert tree.kernel_stats() == kernel_stats.snapshot()
    m = ServingMetrics()
    m.publish(force=True)
    got = m.snapshot()
    for name in ("compiles", "cache_hits", "dispatches", "aot_hits",
                 "aot_quarantined", "tuned_ops"):
        assert f"kernels.{name}" in got
    assert isinstance(lookup("ell_margin", backend="plain"), KernelEntry)


def test_control_plane_imports_and_catalog_leave_jax_out():
    """The four control-plane modules and the whole catalog (every
    registering module) load with no JAX and no JAX package."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from flink_ml_tpu_torch.kernels import aot, autotune, catalog, "
            "registry\n"
            "assert len(registry.ops()) == 10\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flink_ml_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo,
                   env=dict(os.environ, PYTHONPATH=repo), timeout=300)
