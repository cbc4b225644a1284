"""The port's compressed data-parallel gradient reduction
(``parallel/grad_reduce.py``, the compressed all-reduces of
``parallel/collectives.py``, the multi-axis mesh, the data-parallel dense
LR fit) against the JAX package on the same seeded inputs.

The port runs on gloo CPU ranks spawned once per world size (2, 3 and 4)
by ``run_on_ranks`` (rank functions in ``tests/_torch_ranks.py``); the
JAX package runs here, in ``shard_map`` over a sub-mesh of the 8 virtual
CPU devices (``jax.devices()[:P]``), its compiled reducers cached by key.
Both get participant ``p``'s gradient from the same stacked numpy arrays.

Tolerances, each with its reason:

- bit for bit: top-k residuals (the selection and ``g + ef`` are the
  same f32 operations), rd fill vectors (counts), ``fixed`` int8 totals
  (integer sums against the same max scale), int8 codes from the JAX
  package's own draws, rung and tick sequences, ``plan_buckets``,
  ``payload_bytes``, ``bucket_report``, the config errors; the port
  against itself where the sums are layout-free (exact bucketed against
  unbucketed, exact against ``grad_reduce=None``, W 8 against W 1,
  crash and resume);
- ``REDUCE_TOL`` (atol 1e-5): reduced sums, the two packages' f32 sums
  of up to 4 values of |g| < 5 in other orders (tree against gather
  order, XLA's reduce against the port's rank-order sum);
- ``FIT_TOL``: a fit's parameters after 20 steps of SGD from sums that
  differ in the last bits (and, for top-k, ties within those bits that
  may select another entry), rtol 1e-3, atol 1e-4 (``bench.py:266``);
  final losses within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_ranks as R
from flink_ml_tpu.models.common.losses import LOSSES as JLOSSES
from flink_ml_tpu.models.common.sgd import SGDConfig as JSGDConfig
from flink_ml_tpu.models.common.sgd import sgd_fit_params as jsgd_fit_params
from flink_ml_tpu.models.classification.softmaxregression import (
    softmax_xent_loss as jsoftmax)
from flink_ml_tpu.parallel import grad_reduce as JGR
from flink_ml_tpu.parallel.collectives import shard_map_fn
from flink_ml_tpu_torch.models.classification.softmaxregression import (
    softmax_xent_loss as tsoftmax)
from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES as TLOSSES
from flink_ml_tpu_torch.parallel import grad_reduce as TGR
from flink_ml_tpu_torch.parallel.grad_reduce import GradReduceConfig as G
from flink_ml_tpu_torch.utils.backend import run_on_ranks

SPAWN_TIMEOUT_S = 120
REDUCE_TOL = dict(rtol=0, atol=1e-5)
FIT_TOL = dict(rtol=1e-3, atol=1e-4)
LOSS_TOL = 1e-4
D = 96                       # gradient width (not a multiple of 3 ranks)
STEPS = 3
FLAT = {2: {"data": 2}, 3: {"data": 3}, 4: {"data": 4}}
HYBRID = {"dcn": 2, "data": 2}


def jcfg(cfg):
    """The JAX package's config of the port's."""
    return JGR.GradReduceConfig(**dataclasses.asdict(cfg))


def grads(world, seed, d=D):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(world, d)).astype(np.float32)
    w[:, :4] = 0.0           # ties at zero the selection must order
    return {"w": w, "b": rng.normal(size=(world,)).astype(np.float32)}


def grad_steps(world, seed, steps=STEPS, d=D):
    return [grads(world, seed + 10 * s, d) for s in range(steps)]


# ------------------------------------------------------------------ JAX side

_JIT = {}


def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(
        tuple(shape.values())), tuple(shape))


def jax_reduce(steps, cfg, shape, state=None, pipelined=False):
    """The JAX package's reduce over ``steps`` (participant-stacked
    grads): each step's reduced tree (participant 0's) and stacked
    state, as numpy."""
    mesh = _mesh(shape)
    n = int(np.prod(list(shape.values())))
    spec = P(tuple(shape))
    fn_reduce = JGR.pipelined_reduce if pipelined else JGR.reduce_gradients
    if state is None:
        state = JGR.init_state(cfg, {k: v[0] for k, v in steps[0].items()},
                               n)
    key = (cfg, tuple(shape.items()), pipelined)
    fn = _JIT.get(key)
    if fn is None:
        def body(g, st):
            g_l = jax.tree_util.tree_map(lambda a: a[0], g)
            red, new = fn_reduce(g_l, JGR.squeeze_state(st), cfg)
            return (jax.tree_util.tree_map(lambda a: a[None], red),
                    JGR.unsqueeze_state(new))

        fn = jax.jit(shard_map_fn(body, mesh, in_specs=(spec, spec),
                                  out_specs=(spec, spec)))
        _JIT[key] = fn
    out = []
    for g in steps:
        red, state = fn({k: jnp.asarray(v) for k, v in g.items()}, state)
        out.append(({k: np.asarray(v)[0] for k, v in red.items()},
                    jax.device_get(state)))
    return out


def jax_draws(cfg, steps, world, shape_of_unit):
    """The JAX package's stochastic-rounding draws of each participant,
    step and unit, keyed ``(step + 1, unit)`` (the port's stream position
    after the step's advance): ``jax.random.uniform(unit_key,
    blocks.shape)``."""
    n_units = len(shape_of_unit)
    keys = JGR.init_state(cfg, None, world)["key"]
    draws = {}
    for s in range(steps):
        per_p = []
        new_keys = []
        for p in range(world):
            key, use = jax.random.split(keys[p])
            new_keys.append(key)
            unit_keys = jax.random.split(use, max(n_units, 1))
            per_p.append([np.asarray(jax.random.uniform(
                unit_keys[u], shape_of_unit[u])) for u in range(n_units)])
        keys = jnp.stack(new_keys)
        for u in range(n_units):
            draws[(s + 1, u)] = np.stack([per_p[p][u] for p in range(world)])
    return draws


def _blocks(n, block, ici=1):
    m = -(-n // ici)
    return (-(-m // block), block)


# ---------------------------------------------------------------- the jobs

INT8 = G(mode="int8", block_size=16, seed=7)
INT8_FIXED = G(mode="int8", block_size=16, seed=7, int8_accum="fixed")
TOPK_RD = G(mode="topk", density=0.125)
TOPK_AG = G(mode="topk", density=0.125, wire_protocol="allgather")
TOPK_DENSE_SWITCH = G(mode="topk", density=0.5)
ADAPTIVE = G(mode="topk", density=0.1, bucket_count=3, adaptive=True,
             adaptive_window=2)
HIER = {"exact": G(mode="exact", dcn_axis="dcn"),
        "topk": G(mode="topk", density=0.25, dcn_axis="dcn"),
        "int8": G(mode="int8", block_size=8, dcn_axis="dcn",
                  int8_accum="fixed")}
RESUMED = G(mode="topk", density=0.25, bucket_count=2, overlap=True,
            adaptive=True, adaptive_window=2)


def _reduce_jobs(world):
    shape = FLAT[world]
    g = grad_steps(world, 100 + world)
    units = [(1,), (D,)]          # leaf order b, w
    jobs = {
        "exact": dict(config=G(), grads=g[:1]),
        "exact_bucketed": dict(config=G(bucket_count=4), grads=g[:1]),
        "topk_rd": dict(config=TOPK_RD, grads=g),
        "topk_ag": dict(config=TOPK_AG, grads=g),
        "topk_switch": dict(config=TOPK_DENSE_SWITCH, grads=g[:1]),
    }
    for name, cfg in (("int8", INT8), ("int8_fixed", INT8_FIXED)):
        jobs[name] = dict(config=cfg, grads=g[:2], draws=jax_draws(
            jcfg(cfg), 2, world, [_blocks(n[0], 16) for n in units]))
    if world == 4:
        jobs["adaptive"] = dict(config=ADAPTIVE, grads=grad_steps(4, 7, 6))
        jobs["stale"] = dict(config=G(mode="topk", density=1.0,
                                      overlap=True),
                             grads=grad_steps(4, 8, 2), pipelined=True)
        first = grad_steps(4, 9, 3)
        jobs["resumed"] = dict(
            config=RESUMED, grads=first[1:], pipelined=True,
            state=jax_reduce(first[:1], jcfg(RESUMED), shape,
                             pipelined=True)[0][1])
        for mode, cfg in HIER.items():
            job = dict(config=cfg, grads=g[:2], shape=HYBRID)
            if mode == "int8":
                job["draws"] = jax_draws(jcfg(cfg), 2, 4, [
                    _blocks(n[0], 8, ici=2) for n in units])
            jobs["hier_" + mode] = job
    for job in jobs.values():
        job.setdefault("shape", shape)
        job["kind"] = "reduce"
    return jobs


def _lr_rows(world, n=480, d=32, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) > 0).astype(np.float64)
    return np.split(X, world), np.split(y, world)


def _softmax_rows(world, n=240, d=16, c=3, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, c, size=n).astype(np.float64)
    return np.split(X, world), np.split(y, world)


# 480 rows: 8 steps of 60 on 2, 3 and 4 ranks, no padding row
FIT_KW = dict(learning_rate=0.5, max_epochs=8, tol=0,
              global_batch_size=60)
FITS = {
    "none": (None, None),
    "exact": (G(), None),
    "exact_bucketed": (G(bucket_count=8, overlap=True), None),
    "topk": (G(mode="topk", density=0.1), None),
    "int8": (G(mode="int8", block_size=32), None),
    "overlap": (G(mode="topk", density=0.1, bucket_count=4, overlap=True),
                None),
    "hier": (G(mode="topk", density=0.1, dcn_axis="dcn"), HYBRID),
}


def _fit_jobs(world):
    X, y = _lr_rows(world)
    jobs = {}
    for name, (gr, shape) in FITS.items():
        if world != 4 and name not in ("none", "exact", "topk"):
            continue
        jobs["fit_" + name] = dict(
            kind="fit", loss=TLOSSES["logistic"], X=X, y=y, shape=shape,
            config=dict(FIT_KW, grad_reduce=gr),
            init={"w": np.zeros(32, np.float32),
                  "b": np.zeros((), np.float32)})
    if world == 4:
        Xs, ys = _softmax_rows(world)
        jobs["fit_softmax"] = dict(
            kind="fit", loss=tsoftmax, X=Xs, y=ys, shape=None,
            config=dict(FIT_KW, max_epochs=6,
                        grad_reduce=G(mode="topk", density=0.25)),
            init={"w": np.zeros((16, 3), np.float32),
                  "b": np.zeros((3,), np.float32)})
    return jobs


def _spawn(world):
    jobs = {**_reduce_jobs(world), **_fit_jobs(world),
            "mesh": {"kind": "mesh"}}
    out = run_on_ranks(R.grad_reduce_work, world, world, jobs,
                       timeout_s=SPAWN_TIMEOUT_S)
    return jobs, out


@pytest.fixture(scope="module")
def ranks2():
    return _spawn(2)


@pytest.fixture(scope="module")
def ranks3():
    return _spawn(3)


@pytest.fixture(scope="module")
def ranks4():
    return _spawn(4)


@pytest.fixture(params=[2, 3, 4], ids=lambda w: f"w{w}")
def ranks(request):
    return request.param, request.getfixturevalue(f"ranks{request.param}")


def _same_on_every_rank(out, name):
    """Each step's reduced tree, the same bits on every rank."""
    steps = out[0][name]["steps"]
    for o in out[1:]:
        for s0, s1 in zip(steps, o[name]["steps"]):
            for k in s0["red"]:
                np.testing.assert_array_equal(s1["red"][k], s0["red"][k])
    return steps


def _port_ef(out, name, step):
    return {k: np.stack([o[name]["steps"][step]["state"]["ef"][k]
                         for o in out]) for k in ("b", "w")}


# ------------------------------------------------------- host-side parity

CONFIG_ERRORS = [
    dict(mode="fp4"), dict(mode="topk", density=0.0),
    dict(mode="topk", density=1.5), dict(mode="int8", block_size=0),
    dict(axis=("a", "b"), dcn_axis="dcn"), dict(bucket_count=-1),
    dict(mode="int8", adaptive=True),
    dict(mode="topk", adaptive=True, density_ladder=(0.1, "fp4")),
    dict(mode="topk", adaptive=True, density_ladder=(0.1, 1.5)),
    dict(mode="topk", density_ladder=(0.1,)),
    dict(mode="topk", adaptive=True, adaptive_window=0),
    dict(mode="topk", adaptive=True, adaptive_target=0.0),
    dict(wire_protocol="ring"), dict(int8_accum="fp8"),
    dict(dcn_schedule="latest"),
    dict(mode="topk", axis=("a", "b"), wire_protocol="rd"),
    dict(mode="int8", axis=("a", "b"), int8_accum="fixed"),
]


@pytest.mark.parametrize("kw", CONFIG_ERRORS, ids=lambda kw: str(kw))
def test_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JGR.GradReduceConfig(**kw)
    with pytest.raises(ValueError) as got:
        G(**kw)
    assert str(got.value) == str(want.value)


CONFIGS = [
    G(), G(mode="topk"), G(mode="topk", density=0.2, adaptive=True),
    G(mode="topk", density=0.1, adaptive=True,
      density_ladder=(0.01, 0.05, 0.1, "exact")),
    G(mode="topk", axis=("a", "b")), G(mode="topk", dcn_axis="dcn"),
    G(mode="topk", wire_protocol="allgather", bucket_count=3),
    G(mode="int8", overlap=True), G(mode="exact", overlap=True),
    G(mode="topk", density=0.3, adaptive=True, overlap=True,
      density_ladder=("int8", 0.3)),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_policy_helpers_match_jax(cfg):
    j = jcfg(cfg)
    for name in ("effective_ladder", "wants_overlap", "reduction_axes",
                 "hop_axis", "resolved_wire_protocol", "needs_state",
                 "_initial_rung", "_carries_ef", "_bucketed",
                 "_rd_engaged"):
        assert getattr(TGR, name)(cfg) == getattr(JGR, name)(j), name
    mesh = type("M", (), {"shape": {"dcn": 2, "data": 4, "a": 1, "b": 3}})
    assert TGR.mesh_layout(cfg, mesh) == JGR.mesh_layout(j, mesh)
    with pytest.raises(ValueError) as want:
        JGR.mesh_layout(j, type("M", (), {"shape": {"x": 2}}))
    with pytest.raises(ValueError) as got:
        TGR.mesh_layout(cfg, type("M", (), {"shape": {"x": 2}}))
    assert str(got.value) == str(want.value)


LIKES = [
    {"w": np.zeros((1000,), np.float32), "b": np.zeros((), np.float32),
     "v": np.zeros((7, 3), np.float32)},
    {"w": np.zeros((1 << 20,), np.float32), "b": np.zeros((), np.float32)},
    {"w": np.zeros((16, 3), np.float32), "b": np.zeros((3,), np.float32)},
]
PLAN_CONFIGS = [G(mode="topk", bucket_count=8), G(mode="topk", adaptive=True),
                G(bucket_count=3), G(mode="int8", bucket_count=5000),
                G(mode="topk")]


@pytest.mark.parametrize("like", range(len(LIKES)))
@pytest.mark.parametrize("cfg", PLAN_CONFIGS, ids=str)
def test_plan_buckets_match_jax(like, cfg):
    got = TGR.plan_buckets(LIKES[like], cfg)
    want = JGR.plan_buckets(LIKES[like], jcfg(cfg))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


BYTES_CASES = [
    (G(), {}), (G(mode="topk", density=0.1), {}),
    (G(mode="topk", density=0.1), {"hop_size": 4}),
    (G(mode="topk", density=0.01), {"hop_size": 3}),
    (G(mode="int8", block_size=256), {}),
    (G(mode="topk", density=0.1, dcn_axis="dcn"), {"ici_size": 4}),
    (G(mode="topk", density=0.1, dcn_axis="dcn", bucket_count=3),
     {"ici_size": 2, "hop_size": 2}),
    (G(mode="topk", density=0.1, bucket_count=8), {"hop_size": 8}),
    (G(mode="topk", density=0.1, adaptive=True), {"rungs": [0, 0]}),
    (G(mode="topk", density=0.1, adaptive=True), {"rungs": [2, 0]}),
    (G(mode="topk", density=0.1, adaptive=True,
       density_ladder=("int8", 0.1, "exact")), {"rungs": [0, 1]}),
    (G(mode="int8", block_size=100, dcn_axis="dcn", int8_accum="fixed"),
     {"ici_size": 2}),
]


@pytest.mark.parametrize("case", range(len(BYTES_CASES)))
@pytest.mark.parametrize("like", [1, 2])      # two leaves, as rungs= says
def test_payload_bytes_and_bucket_report_match_jax(case, like):
    cfg, kw = BYTES_CASES[case]
    assert TGR.payload_bytes(LIKES[like], cfg, **kw) == \
        JGR.payload_bytes(LIKES[like], jcfg(cfg), **kw)
    rungs = kw.get("rungs")
    assert TGR.bucket_report(LIKES[like], cfg, rungs=rungs) == \
        JGR.bucket_report(LIKES[like], jcfg(cfg), rungs=rungs)


@pytest.mark.parametrize("dtype", ["int8", "int32"])
def test_int8_codes_bit_for_bit_from_jax_draws(dtype):
    """The stochastic round of blocks against their scales: the port's
    codes equal the JAX package's expression on its own draws."""
    rng = np.random.default_rng(1)
    blocks = rng.normal(size=(64, 16)).astype(np.float32) * 3
    blocks[3] = 0.0
    scale = np.maximum(np.abs(blocks).max(1, keepdims=True) / 127.0, 1e-12)
    u = jax.random.uniform(jax.random.PRNGKey(5), blocks.shape)
    want = np.asarray(jnp.clip(jnp.floor(blocks / scale + u), -127,
                               127).astype(getattr(jnp, dtype)))
    got = TGR._int8_codes(torch.from_numpy(blocks), torch.from_numpy(scale),
                          torch.from_numpy(np.array(u)),
                          getattr(torch, dtype)).numpy()
    np.testing.assert_array_equal(got, want)


def test_rounding_stream_repeats_and_advances():
    key = torch.tensor([7, 2, 1])
    a = TGR.draw_uniform(key, 0, (8, 16), "cpu")
    np.testing.assert_array_equal(a, TGR.draw_uniform(key, 0, (8, 16),
                                                      "cpu"))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    for other in (torch.tensor([7, 2, 2]), torch.tensor([7, 3, 1]),
                  torch.tensor([8, 2, 1])):
        assert not torch.equal(a, TGR.draw_uniform(other, 0, (8, 16),
                                                   "cpu"))
    assert not torch.equal(a, TGR.draw_uniform(key, 1, (8, 16), "cpu"))
    # the draws are 24-bit fractions, uniform enough for the round
    big = TGR.draw_uniform(key, 0, (1 << 16,), "cpu").numpy()
    assert abs(big.mean() - 0.5) < 0.01
    assert np.all(big * (1 << 24) == np.floor(big * (1 << 24)))


# ------------------------------------------------------- reduces on ranks


def test_hybrid_mesh_axes_and_their_collectives(ranks):
    """``hybrid_mesh({"data": 2})`` over 4 ranks is ``{"dcn": 2, "data":
    2}`` with rank r at (r // 2, r % 2): a "data" group is a row, a "dcn"
    group a column, the tuple the world; a lane has groups of its own.
    Over 3 ranks it raises, on every rank."""
    world, (_, out) = ranks
    if world != 4:
        want = ("hybrid mesh of {'data': 2} per dcn group needs a multiple "
                f"of 2 ranks, have {world}")
        if world == 2:
            assert out[0]["mesh"]["shape"] == {"dcn": 1, "data": 2}
        else:
            assert [o["mesh"]["error"] for o in out] == [want] * world
        return
    xs = [R.rank_value(r, (3,)) for r in range(4)]
    grid = np.arange(4).reshape(2, 2)
    for r, o in enumerate(out):
        m = o["mesh"]
        assert m["shape"] == HYBRID and m["size"] == 4
        i, j = divmod(r, 2)
        groups = {"data": grid[i], "dcn": grid[:, j], "both": grid.ravel()}
        for name, members in groups.items():
            got = m[name]
            assert got["index"] == list(members).index(r)
            assert got["size"] == len(members)
            want = np.sum([xs[q] for q in members], axis=0)
            np.testing.assert_allclose(got["psum"], want, rtol=1e-6)
            np.testing.assert_allclose(got["ordered"], want, rtol=1e-6)
            np.testing.assert_array_equal(got["gather"],
                                          np.stack([xs[q] for q in members]))
            partner = {0: 1, 1: 0}.get(got["index"])
            np.testing.assert_array_equal(
                got["swap"], xs[members[partner]] if partner is not None
                else np.zeros(3, np.float32))
        np.testing.assert_allclose(m["lane_psum"], np.sum(xs, axis=0),
                                   rtol=1e-6)
        assert m["same_lane"] and m["cached"]


def test_exact_equals_the_sum(ranks):
    world, (jobs, out) = ranks
    g = jobs["exact"]["grads"][0]
    red = _same_on_every_rank(out, "exact")[0]["red"]
    for k in ("w", "b"):
        np.testing.assert_allclose(red[k], g[k].astype(np.float64).sum(0),
                                   **REDUCE_TOL)
        # the bucketed transport sums each element as the whole does
        np.testing.assert_array_equal(
            out[0]["exact_bucketed"]["steps"][0]["red"][k], red[k])
    want = jax_reduce(jobs["exact"]["grads"], jcfg(G()), FLAT[world])
    np.testing.assert_allclose(red["w"], want[0][0]["w"], **REDUCE_TOL)


@pytest.mark.parametrize("name", ["topk_rd", "topk_ag"])
def test_topk_ef_matches_jax_over_steps(ranks, name):
    """Three EF steps: every rank's residual bit for bit the JAX
    package's (the same selection, ties at zero to the lower index), the
    reduced sums within REDUCE_TOL, and rd's fill vectors equal."""
    world, (jobs, out) = ranks
    job = jobs[name]
    steps = _same_on_every_rank(out, name)
    want = jax_reduce(job["grads"], jcfg(job["config"]), FLAT[world])
    for s, (w_red, w_state) in enumerate(want):
        for k in ("w", "b"):
            np.testing.assert_allclose(steps[s]["red"][k], w_red[k],
                                       **REDUCE_TOL)
            np.testing.assert_array_equal(_port_ef(out, name, s)[k],
                                          np.asarray(w_state["ef"][k]))
        if name == "topk_rd":
            for r, o in enumerate(out):
                np.testing.assert_array_equal(
                    o[name]["steps"][s]["state"]["fill"],
                    np.asarray(w_state["fill"])[r])
                np.testing.assert_allclose(
                    o[name]["steps"][s]["state"]["union"],
                    np.asarray(w_state["union"])[r], rtol=1e-6)
        else:
            assert "fill" not in steps[s]["state"]


def test_rd_matches_allgather_and_switches_dense(ranks):
    """rd changes the bytes, not the sum: against the all-gather form
    within REDUCE_TOL; at density 0.5 the union passes break-even and the
    doubling goes dense, with the JAX package's fill vector."""
    world, (jobs, out) = ranks
    for s in range(STEPS):
        np.testing.assert_allclose(out[0]["topk_rd"]["steps"][s]["red"]["w"],
                                   out[0]["topk_ag"]["steps"][s]["red"]["w"],
                                   **REDUCE_TOL)
    job = jobs["topk_switch"]
    want = jax_reduce(job["grads"], jcfg(job["config"]), FLAT[world])
    fills = np.asarray(want[0][1]["fill"])
    assert fills[:, 1, TGR.FILL_SWITCH_SLOT].max() == 1.0
    for r, o in enumerate(out):
        np.testing.assert_array_equal(
            o["topk_switch"]["steps"][0]["state"]["fill"], fills[r])
    np.testing.assert_allclose(out[0]["topk_switch"]["steps"][0]["red"]["w"],
                               want[0][0]["w"], **REDUCE_TOL)


@pytest.mark.parametrize("name", ["int8", "int8_fixed"])
def test_int8_from_jax_draws(ranks, name):
    """With the JAX package's draws fed in: ``fixed`` reduces to the JAX
    package's bits (integer totals against the same max scale);
    ``dequant`` within REDUCE_TOL of it (f32 sums in other orders) and
    within P quanta of the exact sum."""
    world, (jobs, out) = ranks
    job = jobs[name]
    steps = _same_on_every_rank(out, name)
    want = jax_reduce(job["grads"], jcfg(job["config"]), FLAT[world])
    for s, (w_red, _) in enumerate(want):
        g = job["grads"][s]
        for k in ("w", "b"):
            if name == "int8_fixed":
                np.testing.assert_array_equal(steps[s]["red"][k], w_red[k])
            else:
                np.testing.assert_allclose(steps[s]["red"][k], w_red[k],
                                           **REDUCE_TOL)
        scales = np.abs(g["w"].reshape(world, -1, 16)).max(2) / 127.0
        bound = np.repeat(scales.max(0) * world, 16) * (1 + 1e-6)
        assert np.all(np.abs(steps[s]["red"]["w"] - g["w"].sum(0)) <= bound)
        assert steps[s]["state"]["key"].tolist() == [7, 0, s + 1]


@pytest.mark.parametrize("mode", ["exact", "topk", "int8"])
def test_hierarchical_on_2x2_matches_jax(ranks4, mode):
    """The dcn x data mesh (rank r at (r // 2, r % 2)): an exact
    reduce-scatter over "data", the hop over "dcn", the gather back."""
    jobs, out = ranks4
    name = "hier_" + mode
    job = jobs[name]
    steps = _same_on_every_rank(out, name)
    want = jax_reduce(job["grads"], jcfg(job["config"]), HYBRID)
    for s, (w_red, w_state) in enumerate(want):
        for k in ("w", "b"):
            if mode == "int8":   # fixed: the JAX package's bits
                np.testing.assert_array_equal(steps[s]["red"][k], w_red[k])
            else:
                np.testing.assert_allclose(steps[s]["red"][k], w_red[k],
                                           **REDUCE_TOL)
            if mode == "topk":
                np.testing.assert_array_equal(_port_ef(out, name, s)[k],
                                              np.asarray(w_state["ef"][k]))
        if mode == "topk":
            for r, o in enumerate(out):
                np.testing.assert_array_equal(
                    o[name]["steps"][s]["state"]["fill"],
                    np.asarray(w_state["fill"])[r])


def test_adaptive_rungs_follow_jax(ranks4):
    """Six bucketed adaptive steps: the rung and tick sequences equal the
    JAX package's, the EMA and residual within REDUCE_TOL; the rungs
    were read on the host once a window (2 steps) plus the first."""
    jobs, out = ranks4
    job = jobs["adaptive"]
    steps = _same_on_every_rank(out, "adaptive")
    want = jax_reduce(job["grads"], jcfg(ADAPTIVE), FLAT[4])
    for s, (w_red, w_state) in enumerate(want):
        st = steps[s]["state"]
        np.testing.assert_array_equal(st["rung"],
                                      np.asarray(w_state["rung"])[0])
        assert int(st["tick"]) == int(np.asarray(w_state["tick"])[0])
        np.testing.assert_allclose(st["ema"], np.asarray(w_state["ema"])[0],
                                   rtol=1e-5)
        np.testing.assert_allclose(st["fill"],
                                   np.asarray(w_state["fill"])[0])
        for k in ("w", "b"):
            np.testing.assert_allclose(steps[s]["red"][k], w_red[k],
                                       **REDUCE_TOL)
            np.testing.assert_allclose(_port_ef(out, "adaptive", s)[k],
                                       np.asarray(w_state["ef"][k]),
                                       **REDUCE_TOL)
    assert [int(s["state"]["tick"]) for s in steps] == [1, 2, 3, 4, 5, 6]
    assert len({tuple(s["state"]["rung"]) for s in steps}) > 1
    assert out[0]["adaptive"]["rung_reads"] == 1 + 6 // 2 - 1


def test_pipelined_reduce_is_one_step_stale(ranks4):
    """Step 1 reduces the zero pending (a no-op), step 2 step 1's
    gradient; the drain sums step 2's pending exactly."""
    jobs, out = ranks4
    g = jobs["stale"]["grads"]
    steps = _same_on_every_rank(out, "stale")
    np.testing.assert_array_equal(steps[0]["red"]["w"], 0.0)
    np.testing.assert_allclose(steps[1]["red"]["w"], g[0]["w"].sum(0),
                               **REDUCE_TOL)
    for o in out:
        np.testing.assert_allclose(o["stale"]["drain"]["w"],
                                   g[1]["w"].sum(0), **REDUCE_TOL)


def test_converted_jax_state_resumes_the_schedule(ranks4):
    """One overlapped adaptive bucketed step in the JAX package, its
    stacked state converted to each rank (``grad_reduce_state_from_jax``),
    two more in the port: the same as the JAX package's three."""
    jobs, out = ranks4
    job = jobs["resumed"]
    first = grad_steps(4, 9, 3)
    want = jax_reduce(first, jcfg(RESUMED), FLAT[4], pipelined=True)[1:]
    steps = _same_on_every_rank(out, "resumed")
    for s, (w_red, w_state) in enumerate(want):
        np.testing.assert_allclose(steps[s]["red"]["w"], w_red["w"],
                                   **REDUCE_TOL)
        st = steps[s]["state"]
        np.testing.assert_array_equal(st["rung"],
                                      np.asarray(w_state["rung"])[0])
        assert st["tick"].shape == () and \
            int(st["tick"]) == int(np.asarray(w_state["tick"])[0])
        for k in ("w", "b"):
            np.testing.assert_array_equal(
                np.stack([o["resumed"]["steps"][s]["state"]["pending"][k]
                          for o in out]),
                np.asarray(w_state["pending"][k]))
            np.testing.assert_allclose(_port_ef(out, "resumed", s)[k],
                                       np.asarray(w_state["ef"][k]),
                                       **REDUCE_TOL)
    assert job["state"]["tick"].tolist() == [1] * 4


# ------------------------------------------------- data-parallel LR fits


def _jax_rows(parts_X, parts_y, batch):
    """The rows of one JAX fit on a P-device mesh that give device p the
    rows rank p takes at every step (rank p's local permutation of its
    own rows), so that the JAX package's global permutation lays them
    out so."""
    world = len(parts_X)
    n_local = len(parts_X[0])
    b = batch // world
    steps = n_local // b
    order = []
    local = [np.random.default_rng(0).permutation(n_local)
             for _ in range(world)]
    for i in range(steps):
        for r in range(world):
            order.append((r, local[r][i * b:(i + 1) * b]))
    D_X = np.concatenate([parts_X[r][rows] for r, rows in order])
    D_y = np.concatenate([parts_y[r][rows] for r, rows in order])
    perm = np.random.default_rng(0).permutation(len(D_X))
    X, y = np.empty_like(D_X), np.empty_like(D_y)
    X[perm], y[perm] = D_X, D_y
    return X, y


def _jax_fit(job, world):
    gr = job["config"]["grad_reduce"]
    cfg = JSGDConfig(**dict(job["config"],
                            grad_reduce=None if gr is None else jcfg(gr)))
    X, y = _jax_rows(job["X"], job["y"], FIT_KW["global_batch_size"])
    loss = jsoftmax if job["loss"] is tsoftmax else JLOSSES["logistic"]
    shape = job["shape"] or {"data": world}
    params, log = jsgd_fit_params(
        loss, X, y, None, cfg, _mesh(shape),
        init_params={k: jnp.asarray(v) for k, v in job["init"].items()})
    return {k: np.asarray(v) for k, v in params.items()}, log


def _port_fit(out, name):
    fits = [o[name] for o in out]
    for f in fits[1:]:
        for k in ("w", "b"):
            np.testing.assert_array_equal(f["params"][k],
                                          fits[0]["params"][k])
        assert f["log"] == fits[0]["log"]
    return fits[0]


@pytest.mark.parametrize("name", ["none", "topk"])
def test_dp_fit_matches_jax(ranks, name):
    world, (jobs, out) = ranks
    fit = _port_fit(out, "fit_" + name)
    params, log = _jax_fit(jobs["fit_" + name], world)
    assert "_gr" not in fit["params"]
    for k in ("w", "b"):
        np.testing.assert_allclose(fit["params"][k], params[k], **FIT_TOL)
    assert abs(fit["log"][-1] - log[-1]) < LOSS_TOL
    assert fit["log"][-1] < fit["log"][0]


@pytest.mark.parametrize("name", ["int8", "overlap", "hier", "softmax"])
def test_dp_fit_compressed_matches_jax(ranks4, name):
    """int8 (the port's own rounding stream), overlapped bucketed top-k,
    the hierarchical reduce on the 2x2 hybrid mesh and the softmax
    family's (d, C) weight: each within LOSS_TOL of the JAX package's
    fit on the same rows (int8: two rounding streams, so the loss only)."""
    jobs, out = ranks4
    fit = _port_fit(out, "fit_" + name)
    params, log = _jax_fit(jobs["fit_" + name], 4)
    assert abs(fit["log"][-1] - log[-1]) < LOSS_TOL
    assert fit["log"][-1] < fit["log"][0]
    if name != "int8":
        for k in ("w", "b"):
            np.testing.assert_allclose(fit["params"][k], params[k],
                                       **FIT_TOL)


def test_dp_fit_exact_is_bit_identical(ranks):
    """``grad_reduce=None``, ``mode="exact"`` and (4 ranks) exact with 8
    buckets and overlap give the same bits."""
    world, (jobs, out) = ranks
    ref = _port_fit(out, "fit_none")
    names = ["exact"] + (["exact_bucketed"] if world == 4 else [])
    for name in names:
        fit = _port_fit(out, "fit_" + name)
        for k in ("w", "b"):
            np.testing.assert_array_equal(fit["params"][k],
                                          ref["params"][k])
        assert fit["log"] == ref["log"]


# ------------------------------------------------------ one process alone


def _cache(tmp_path, n_seg=3, d=8, seed=7):
    from flink_ml_tpu_torch.data.datacache import DataCacheWriter

    rng = np.random.default_rng(seed)
    true_w = rng.normal(size=(d,))
    cache = str(tmp_path / "cache")
    writer = DataCacheWriter(cache, segment_rows=512)
    for _ in range(n_seg):
        X = rng.normal(size=(512, d)).astype(np.float32)
        writer.append({"features": X,
                       "label": (X @ true_w > 0).astype(np.float32)})
    writer.finish()
    return cache


class _FailAfter:
    """A reader that dies after N batch reads across the run."""

    counter = 0

    def __init__(self, inner, fail_after):
        self._inner = inner
        self._fail_after = fail_after

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __iter__(self):
        while True:
            _FailAfter.counter += 1
            if _FailAfter.counter > self._fail_after:
                raise RuntimeError("injected mid-epoch failure")
            b = self._inner.read_batch()
            if b is None:
                return
            yield b


STREAM_CONFIGS = {
    "topk": G(mode="topk", density=0.1),
    "schedule": G(mode="topk", density=0.25, bucket_count=3, overlap=True,
                  adaptive=True, adaptive_window=2),
    "int8": G(mode="int8", block_size=4),
}


def _stream(cache, cfg, **kw):
    from flink_ml_tpu_torch.data.datacache import DataCacheReader

    reader = kw.pop("reader", None) or (
        lambda: DataCacheReader(cache, batch_rows=256))
    return TS.sgd_fit_outofcore(
        TLOSSES["logistic"], reader, num_features=8, device="cpu",
        config=TS.SGDConfig(learning_rate=0.4, max_epochs=kw.pop(
            "epochs", 2), tol=0.0, grad_reduce=cfg), **kw)


@pytest.mark.parametrize("name", list(STREAM_CONFIGS))
def test_streamed_fit_w8_equals_w1(tmp_path, name):
    cache = _cache(tmp_path)
    s1, log1 = _stream(cache, STREAM_CONFIGS[name], steps_per_dispatch=1)
    s8, log8 = _stream(cache, STREAM_CONFIGS[name], steps_per_dispatch=8)
    assert s1.planned_impl == "dense-stream-reduced"
    np.testing.assert_array_equal(s1.coefficients, s8.coefficients)
    assert s1.intercept == s8.intercept and log1 == log8
    assert log1[-1] < log1[0]


@pytest.mark.parametrize("name", list(STREAM_CONFIGS))
def test_streamed_fit_crash_and_resume_bit_for_bit(tmp_path, name):
    """The reducer state (residual, pending, rungs, tick, the rounding
    stream) rides every cut: crash and resume is the uninterrupted run."""
    from flink_ml_tpu_torch.data.datacache import DataCacheReader
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointConfig

    cache = _cache(tmp_path)
    cfg = STREAM_CONFIGS[name]
    ref, ref_log = _stream(cache, cfg, epochs=4)
    ck = CheckpointConfig(str(tmp_path / "ck"), max_to_keep=3)
    _FailAfter.counter = 0
    with pytest.raises(RuntimeError, match="injected"):
        _stream(cache, cfg, epochs=4, cache_decoded=False, checkpoint=ck,
                checkpoint_every_steps=2, reader=lambda: _FailAfter(
                    DataCacheReader(cache, batch_rows=256), 15))
    got, log = _stream(cache, cfg, epochs=4, checkpoint=ck,
                       checkpoint_every_steps=2, resume=True)
    np.testing.assert_array_equal(got.coefficients, ref.coefficients)
    assert got.intercept == ref.intercept and log == ref_log


def test_streamed_fit_matches_jax(tmp_path):
    """The dense streamed top-k fit against the JAX package's on a mesh of
    one device (one participant each)."""
    from flink_ml_tpu.data.datacache import DataCacheReader as JReader
    from flink_ml_tpu.models.common.losses import logistic_loss
    from flink_ml_tpu.models.common.sgd import sgd_fit_outofcore

    cache = _cache(tmp_path)
    cfg = STREAM_CONFIGS["topk"]
    got, log = _stream(cache, cfg)
    want, jlog = sgd_fit_outofcore(
        logistic_loss, lambda: JReader(cache, batch_rows=256),
        num_features=8, mesh=_mesh({"data": 1}),
        config=JSGDConfig(learning_rate=0.4, max_epochs=2, tol=0.0,
                          grad_reduce=jcfg(cfg)))
    assert want.planned_impl == got.planned_impl
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               **FIT_TOL)
    np.testing.assert_allclose(log, jlog, rtol=1e-5)


def test_streamed_hashed_layouts_refuse_grad_reduce():
    cfg = TS.SGDConfig(grad_reduce=G(mode="topk"))
    for kw in (dict(indices_key="i", values_key="v"),
               dict(dense_key="d", indices_key="i")):
        with pytest.raises(ValueError, match="sparse by construction"):
            TS.sgd_fit_outofcore(TLOSSES["logistic"], lambda: iter([]),
                                 num_features=8, config=cfg, device="cpu",
                                 **kw)


def test_in_memory_hashed_layouts_ignore_grad_reduce():
    """``sgd_fit_sparse`` and ``sgd_fit_mixed`` train as without a
    ``grad_reduce``, as the JAX package's do (its gradients are sparse by
    construction)."""
    rng = np.random.default_rng(4)
    n, d = 256, 256
    idx = rng.integers(0, d, size=(n, 5)).astype(np.int32)
    vals = rng.normal(size=(n, 5)).astype(np.float32)
    dense = rng.normal(size=(n, 3)).astype(np.float32)
    y = rng.integers(0, 2, size=n).astype(np.float64)
    kw = dict(learning_rate=0.3, max_epochs=3, tol=0, global_batch_size=64)
    for fit, args in ((TS.sgd_fit_sparse, (idx, vals)),
                      (TS.sgd_fit_mixed, (dense, idx))):
        a, la = fit(TLOSSES["logistic"], *args, y, None, d,
                    TS.SGDConfig(**kw), device="cpu")
        b, lb = fit(TLOSSES["logistic"], *args, y, None, d,
                    TS.SGDConfig(**kw, grad_reduce=G(mode="topk")),
                    device="cpu")
        np.testing.assert_array_equal(a.coefficients, b.coefficients)
        assert la == lb


@pytest.mark.parametrize("cfg", [
    G(mode="topk", density=0.25),
    G(mode="topk", density=0.25, bucket_count=2, overlap=True,
      adaptive=True, adaptive_window=3),
    G(mode="int8", block_size=8)], ids=["topk", "schedule", "int8"])
def test_hosted_iterate_carries_reducer_state(tmp_path, cfg):
    """A hosted ``iterate`` body that reduces through ``grad_reduce``
    keeps its reducer state (float, int32 and the int64 stream) in the
    iteration state: per-epoch checkpoints round-trip it, so a resume
    from the last cut equals the whole run, state and all."""
    from flink_ml_tpu_torch.iteration import (
        IterationBodyResult,
        IterationConfig,
        iterate,
    )
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointConfig

    d = 32
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.normal(size=(1, d)).astype(np.float32))
    target = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))
    readers = []

    def epoch_body(state, epoch, x):
        w, st = state["w"], state["gr"]
        g = {"w": x[0] * (w - target)}
        rungs = readers[-1].rungs(st) if cfg.adaptive else None
        if TGR.wants_overlap(cfg):
            red, st = TGR.pipelined_reduce(g, st, cfg, rungs=rungs)
        else:
            red, st = TGR.reduce_gradients(g, st, cfg, rungs=rungs)
        return IterationBodyResult({"w": w - 0.05 * red["w"], "gr": st})

    def run(ck, epochs, **kw):
        readers.append(TGR.RungReader(cfg))
        init = {"w": torch.zeros(d), "gr": TGR.init_state(
            cfg, {"w": torch.zeros(d)})}
        return iterate(epoch_body, init, data, max_epochs=epochs,
                       config=IterationConfig(mode="hosted"),
                       checkpoint=CheckpointConfig(str(tmp_path / ck)),
                       **kw)

    full = run("full", 8)
    run("cut", 5)                # the run dies after its epoch-5 cut
    resumed = run("cut", 8, resume=True)

    def leaves(t):
        return TGR._leaves(t)

    for a, b in zip(leaves(full.state), leaves(resumed.state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    if cfg.adaptive:
        assert int(full.state["gr"]["tick"]) == 8
        assert full.state["gr"]["rung"].dtype == torch.int32
    if cfg.mode == "int8":
        assert full.state["gr"]["key"].tolist() == [0, 0, 8]


@pytest.mark.parametrize("where", ["parallel.grad_reduce._unflatten",
                                   "models.common.adam.tree_unflatten"])
def test_unflatten_leaves_no_reference_cycle(where):
    """A rebuilt tree's leaves are freed when its last reference goes, and
    never wait in a reference cycle for Python's collector (on the card a
    step's gradients would then stay allocated until it ran)."""
    import gc
    import importlib

    mod, fn = where.rsplit(".", 1)
    unflatten = getattr(importlib.import_module(
        "flink_ml_tpu_torch." + mod), fn)
    like = {"b": [torch.zeros(2), (torch.zeros(3),)], "a": torch.zeros(1)}
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        tree = unflatten(like, [torch.ones(1), torch.ones(2),
                                torch.ones(3)])
        assert tree["a"].shape == (1,) and tree["b"][1][0].shape == (3,)
        del tree
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []
