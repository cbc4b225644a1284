"""The port's model-parallel families (``parallel/collectives.py``'s
all-to-all and ring permute, ``pipeline_parallel``, ``ring_attention``,
``ulysses``, ``moe``) on gloo CPU ranks, against numpy and the JAX package
on the same numpy-seeded inputs.

- ``all_to_all`` (tiled on three axis pairs, untiled) and ``ppermute_ring``
  (shifts 1, 3, -1) against a numpy reshuffle of labelled elements, and
  their gradients against the inverse reshuffle of the cotangent: exact.
- ring attention, causal and not, on a ``{"seq": 4}`` mesh of ranks against
  the JAX ``ring_attention`` on a ``{"seq": 4}`` mesh of the conftest's
  virtual CPU devices, and its Q/K/V gradients against ``jax.grad`` of the
  JAX ``attention_reference``; Ulysses on ``{"seq": 4, "data": 2}`` with 8
  heads against the JAX ``ulysses_attention`` on the same mesh shape.
- the pipeline's forward and its stage gradients, gathered over ``pipe``,
  against ``jax.grad`` of the JAX ``build_pipeline`` on ``{"pipe": 4}`` and
  on ``{"data": 2, "pipe": 4}`` (dp x pp): each equals the JAX gradient,
  not P times it, and the other stages' rows are zero.
- MoE at ``mesh=None`` (the JAX init's draws; no drops, grouped, over
  capacity, bf16 tokens) and sharded on ``{"data": 2, "expert": 4}`` (one
  routing group gathered over ``data``, local groups, the ranks' expert
  shards, over capacity, bf16) against the JAX ``moe_apply``.
- the ValueErrors of ``tests/test_parallel.py:114-125, 463-476`` (a ragged
  sequence raising on every rank, too few heads, the pipeline's three) and
  ``:591-596`` (``group_size``).

The ranks are one spawn of 8 gloo CPU processes
(``tests/_torch_families_ranks.py``).  Tolerances: f32 outputs and
gradients ``rtol=1e-5, atol=1e-5`` against the JAX package (the two
packages sum in other orders; attention over <= 32 positions and tanh
stages of width 8 stay within ~3e-7 here), the pipeline's gradients
``rtol=1e-4, atol=1e-5`` (``tests/test_parallel.py:445``'s); bf16 MoE
outputs within one bf16 rounding of the output, ``atol=2**-8 * max|y|``
(both packages run the experts in f32 on the same bf16 tokens and round
once at the end; a last-bit difference in the f32 sum can land the
rounding on the neighbouring bf16 value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_families_ranks as R
from flink_ml_tpu.parallel import moe as JM
from flink_ml_tpu.parallel.mesh import device_mesh
from flink_ml_tpu.parallel.pipeline_parallel import build_pipeline as jbuild
from flink_ml_tpu.parallel.ring_attention import (
    attention_reference as jref,
    ring_attention as jring,
)
from flink_ml_tpu.parallel.ulysses import ulysses_attention as julysses
from flink_ml_tpu_torch.parallel import moe as TM
from flink_ml_tpu_torch.parallel.mesh import local_mesh
from flink_ml_tpu_torch.parallel.pipeline_parallel import (
    build_pipeline as tbuild)
from flink_ml_tpu_torch.parallel.ring_attention import (
    attention_reference as tref,
    ring_attention as tring,
)
from flink_ml_tpu_torch.parallel.ulysses import ulysses_attention as tulysses
from flink_ml_tpu_torch.utils.backend import run_on_ranks
from flink_ml_tpu_torch.utils.convert import (moe_params_from_jax,
                                              moe_shard_from_jax,
                                              stage_params_from_jax)

SPAWN_TIMEOUT_S = 180
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
QUAD, OCT = list(range(4)), list(range(8))
A2A_CASES = [("a2a_10", "a2a", dict(split_axis=1, concat_axis=0)),
             ("a2a_02", "a2a", dict(split_axis=0, concat_axis=2)),
             ("a2a_22", "a2a", dict(split_axis=2, concat_axis=2)),
             ("a2a_untiled", "a2a", dict(split_axis=0, concat_axis=1,
                                         tiled=False)),
             ("ring1", "ring", dict(shift=1)),
             ("ring3", "ring", dict(shift=3)),
             ("ring_m1", "ring", dict(shift=-1))]
MOE_SHARDED = [("whole", dict(capacity_factor=4.0), False, False),
               ("grouped", dict(capacity_factor=4.0, group_size=8), False,
                False),
               ("grouped_shard", dict(capacity_factor=4.0, group_size=8),
                True, False),
               ("over_capacity", dict(capacity_factor=0.5, group_size=16),
                True, False),
               ("bf16", dict(capacity_factor=4.0, group_size=16), False,
                True)]


def _qkv(b=2, s=32, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _stacked_mlp(n_stages, d, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n_stages, d, d)) * 0.3).astype(np.float32),
            (rng.normal(size=(n_stages, d)) * 0.1).astype(np.float32))


def _moe_setup(n_tokens=32, d=8, hidden=16, experts=4, seed=7):
    rng = np.random.default_rng(seed)
    params = JM.init_moe(rng, d, hidden, experts)
    x = rng.normal(size=(n_tokens, d)).astype(np.float32)
    return params, x


def _host(params):
    return JM.MoEParams(*(np.asarray(a) for a in params))


def _labels(world, shape):
    return [(r * 1000 + np.arange(np.prod(shape))).reshape(shape)
            .astype(np.float32) for r in range(world)]


def _pipe_data(seed_p, seed_x, seed_y, batch, d=8):
    params = _stacked_mlp(4, d, seed_p)
    x = np.random.default_rng(seed_x).normal(size=(batch, d)).astype(
        np.float32)
    y = np.random.default_rng(seed_y).normal(size=(batch, d)).astype(
        np.float32)
    return params, x, y


@pytest.fixture(scope="module")
def ranks():
    """One spawn of 8 gloo ranks running every job of this file."""
    x = _labels(4, (4, 8, 8))
    wrng = np.random.default_rng(11)
    out_shape = {"a2a_10": (16, 2, 8), "a2a_02": (1, 8, 32),
                 "a2a_22": (4, 8, 8), "a2a_untiled": (8, 4, 8),
                 "ring1": (4, 8, 8), "ring3": (4, 8, 8),
                 "ring_m1": (4, 8, 8)}
    weights = {name: [wrng.normal(size=out_shape[name]).astype(np.float32)
                      for _ in range(4)] for name, _, _ in A2A_CASES}
    g = np.random.default_rng(12).normal(size=(2, 32, 4, 8)).astype(
        np.float32)
    moe_params, moe_x = _moe_setup(n_tokens=64)
    seq4 = {"seq": 4}
    jobs = {
        "collectives": dict(kind="collectives", ranks=QUAD,
                            shape={"data": 4}, x=x, w=weights,
                            cases=A2A_CASES),
        "ring": dict(kind="ring", ranks=QUAD, shape=seq4, qkv=_qkv(), g=g),
        "ulysses": dict(kind="ulysses", ranks=OCT,
                        shape={"seq": 4, "data": 2}, qkv=_qkv(h=8)),
        "pipe": dict(kind="pipeline", ranks=QUAD, shape={"pipe": 4},
                     n_micro=4, **dict(zip(("params", "x", "y"),
                                           _pipe_data(0, 2, 3, 16)))),
        "pipe_dp": dict(kind="pipeline", ranks=OCT,
                        shape={"data": 2, "pipe": 4}, n_micro=4,
                        data_axis="data", **dict(zip(
                            ("params", "x", "y"), _pipe_data(4, 5, 6, 32)))),
        "moe": dict(kind="moe", ranks=OCT, shape={"data": 2, "expert": 4},
                    params=_host(moe_params), x=moe_x,
                    cases=[(n, dict(kw), s, b)
                           for n, kw, s, b in MOE_SHARDED]),
        "errors": dict(kind="errors", ranks=QUAD, shape=seq4,
                       ragged=[8, 8, 7, 7]),
        "pipe_errors": dict(kind="pipeline_errors", ranks=QUAD,
                            shape={"pipe": 4}, params=_stacked_mlp(4, 8)),
    }
    out = run_on_ranks(R.families, 8, 8, jobs, timeout_s=SPAWN_TIMEOUT_S)
    return jobs, out


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return device_mesh(shape, devices=jax.devices()[:n])


# ------------------------------------------------------------ collectives


def _np_a2a(xs, split_axis, concat_axis, tiled=True):
    n = len(xs)
    if tiled:
        parts = [np.split(x, n, axis=split_axis) for x in xs]
        return [np.concatenate([parts[j][r] for j in range(n)],
                               axis=concat_axis) for r in range(n)]
    return [np.stack([np.take(x, r, axis=split_axis) for x in xs],
                     axis=concat_axis) for r in range(n)]


def _np_ring(xs, shift):
    n = len(xs)
    return [xs[(r - shift) % n] for r in range(n)]


@pytest.mark.parametrize("name,kind,kw", A2A_CASES,
                         ids=[c[0] for c in A2A_CASES])
def test_collective_exchange_and_gradient_against_numpy(ranks, name, kind,
                                                        kw):
    """Each rank's output is the numpy reshuffle of the ranks' labelled
    inputs; each rank's gradient of ``sum(w * out)`` is the cotangent
    ``w`` carried back to where each element came from (the inverse
    exchange), bit for bit."""
    jobs, out = ranks
    xs, ws = jobs["collectives"]["x"], jobs["collectives"]["w"][name]
    want = (_np_a2a(xs, **kw) if kind == "a2a"
            else _np_ring(xs, kw["shift"]))
    weight_of = {}
    for r in range(4):
        got = out[r]["collectives"][name]
        np.testing.assert_array_equal(got["y"], want[r])
        weight_of.update(zip(want[r].reshape(-1).tolist(),
                             ws[r].reshape(-1).tolist()))
    for r in range(4):
        expect = np.vectorize(weight_of.get)(xs[r]).astype(np.float32)
        np.testing.assert_array_equal(out[r]["collectives"][name]["grad"],
                                      expect)


def test_collectives_on_one_rank_are_the_identity_exchange():
    """Without a group (one rank on the axis) the all-to-all returns its
    input (tiled) or inserts the size-1 axis (untiled), the ring permute
    its input, each with the identity gradient; an untiled split axis must
    have the axis size."""
    from flink_ml_tpu_torch.parallel import collectives as C

    mesh = local_mesh(("data",))
    x = torch.arange(12.0).reshape(3, 4).requires_grad_(True)
    y = C.all_to_all(x, "data", split_axis=1, concat_axis=0, mesh=mesh)
    r = C.ppermute_ring(x, "data", shift=5, mesh=mesh)
    u = C.all_to_all(x[None], "data", split_axis=0, concat_axis=1,
                     tiled=False, mesh=mesh)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    torch.testing.assert_close(r, x, rtol=0, atol=0)
    assert tuple(u.shape) == (3, 1, 4)
    (y.sum() + 2 * r.sum() + 3 * u.sum()).backward()
    torch.testing.assert_close(x.grad, torch.full((3, 4), 6.0))
    with pytest.raises(ValueError, match="has size 5, the axis 1"):
        C.all_to_all(torch.zeros(3, 5), "data", split_axis=1,
                     concat_axis=0, tiled=False, mesh=mesh)


# ------------------------------------------------------------ ring / ulysses


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(ranks, causal):
    """The ranks' blocks joined along the sequence equal the JAX
    ``ring_attention`` on a ``{"seq": 4}`` device mesh; the Q/K/V gradient
    blocks equal ``jax.grad`` of the dense JAX oracle."""
    jobs, out = ranks
    q, k, v = jobs["ring"]["qkv"]
    g = jobs["ring"]["g"]
    want = np.asarray(jring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            mesh=_jmesh({"seq": 4}), axis="seq",
                            causal=causal))
    got = np.concatenate([out[r]["ring"][causal]["out"] for r in QUAD],
                         axis=1)
    np.testing.assert_allclose(got, want, **TOL)
    grads = jax.grad(lambda *a: jnp.sum(jref(*a, causal=causal) * g),
                     argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    for key, want_g in zip(("dq", "dk", "dv"), grads):
        got_g = np.concatenate([out[r]["ring"][causal][key] for r in QUAD],
                               axis=1)
        np.testing.assert_allclose(got_g, np.asarray(want_g), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_on_a_two_axis_mesh(ranks, causal):
    """On ``{"seq": 4, "data": 2}`` (8 heads) each rank's block of its data
    row equals the JAX ``ulysses_attention`` on the same mesh shape: the
    exchanges run over the seq group alone."""
    jobs, out = ranks
    q, k, v = (jnp.asarray(a) for a in jobs["ulysses"]["qkv"])
    want = np.asarray(julysses(q, k, v, mesh=_jmesh({"seq": 4, "data": 2}),
                               axis="seq", causal=causal))
    for r in OCT:
        s_i, d_i = r // 2, r % 2
        np.testing.assert_allclose(
            out[r]["ulysses"][causal],
            want[d_i:d_i + 1, s_i * 8:(s_i + 1) * 8], **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_on_one_rank_and_by_query_block(causal):
    """A one-rank ring and Ulysses are dense attention; the port's
    reference equals the JAX one, and by query block (``q_offset``) it
    equals the whole one's rows."""
    q, k, v = _qkv(s=16)
    want = np.asarray(jref(*(jnp.asarray(a) for a in (q, k, v)),
                           causal=causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    mesh = local_mesh(("seq",))
    for fn in (tref, lambda *a, **kw: tring(*a, mesh=mesh, **kw),
               lambda *a, **kw: tulysses(*a, mesh=mesh, **kw)):
        np.testing.assert_allclose(fn(tq, tk, tv, causal=causal).numpy(),
                                   want, **TOL)
    blocks = [tref(tq[:, i:i + 4], tk, tv, causal=causal, q_offset=i)
              for i in range(0, 16, 4)]
    np.testing.assert_allclose(torch.cat(blocks, dim=1).numpy(), want,
                               **TOL)


# ------------------------------------------------------------ pipeline


def _jstage(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _jax_pipeline(job, shape, data_axis=None):
    w, b = (jnp.asarray(a) for a in job["params"])
    x, y = jnp.asarray(job["x"]), jnp.asarray(job["y"])
    fn = jbuild(_jstage, _jmesh(shape), n_micro=job["n_micro"],
                data_axis=data_axis)
    out = fn((w, b), x)
    grads = jax.grad(lambda p: jnp.mean((fn(p, x) - y) ** 2))((w, b))
    return np.asarray(out), [np.asarray(a) for a in grads]


@pytest.mark.parametrize("name", ["pipe", "pipe_dp"])
def test_pipeline_forward_and_stage_grads_match_jax(ranks, name):
    """The pipeline's output on every rank (its rows, with a data axis)
    and each rank's stage gradient, gathered over ``pipe``, equal the JAX
    ``build_pipeline`` and ``jax.grad`` through it: the final
    select-and-sum hands the cotangent through once, not P times, and no
    rank's gradient reaches another stage's parameters."""
    jobs, out = ranks
    job = jobs[name]
    shape = job["shape"]
    want_out, (want_w, want_b) = _jax_pipeline(job, shape,
                                               job.get("data_axis"))
    n_pipe = shape["pipe"]
    for r in job["ranks"]:
        got = out[r][name]
        d_i = r // n_pipe if "data" in shape else 0
        rows = len(got["out"])
        np.testing.assert_allclose(got["out"],
                                   want_out[d_i * rows:(d_i + 1) * rows],
                                   **TOL)
        assert got["dw_other"] == 0.0
    for r0 in range(0, len(job["ranks"]), n_pipe):
        dw = np.stack([out[r][name]["dw"] for r in range(r0, r0 + n_pipe)])
        db = np.stack([out[r][name]["db"] for r in range(r0, r0 + n_pipe)])
        np.testing.assert_allclose(dw, want_w, **GRAD_TOL)
        np.testing.assert_allclose(db, want_b, **GRAD_TOL)


def test_pipeline_of_one_stage_is_the_stage():
    """On a one-rank ``pipe`` axis the pipeline is the stage itself."""
    params, x, _ = _pipe_data(0, 2, 3, 16)
    w, b = (torch.from_numpy(a[:1]) for a in params)
    fn = tbuild(R._stage, local_mesh(("pipe",)), n_micro=4)
    got = fn((w, b), torch.from_numpy(x)).numpy()
    want = np.tanh(x @ params[0][0] + params[1][0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ MoE


def test_init_moe_draws_and_convert_match_jax():
    """``init_moe`` makes the JAX package's draws from the same generator;
    ``moe_params_from_jax`` / ``moe_shard_from_jax`` /
    ``stage_params_from_jax`` carry the JAX trees across."""
    jp = JM.init_moe(np.random.default_rng(3), 8, 16, 4)
    tp = TM.init_moe(np.random.default_rng(3), 8, 16, 4)
    conv = moe_params_from_jax(_host(jp), device="cpu")
    for a, b, c in zip(jp, tp, conv):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(a), c.numpy())
    shard = moe_shard_from_jax(_host(jp), 1, 2, device="cpu")
    np.testing.assert_array_equal(shard.wg.numpy(), np.asarray(jp.wg))
    np.testing.assert_array_equal(shard.w_in.numpy(),
                                  np.asarray(jp.w_in)[2:4])
    np.testing.assert_array_equal(shard.w_out.numpy(),
                                  np.asarray(jp.w_out)[2:4])
    params = _stacked_mlp(4, 8)
    whole = stage_params_from_jax(params, device="cpu")
    one = stage_params_from_jax(params, device="cpu", stage=2)
    for a, w, o in zip(params, whole, one):
        np.testing.assert_array_equal(w.numpy(), a)
        np.testing.assert_array_equal(o.numpy(), a[2])


MOE_LOCAL = [("capacity_4", 32, dict(capacity_factor=4.0)),
             ("grouped_16", 64, dict(capacity_factor=4.0, group_size=16)),
             ("drops", 16, dict(capacity_factor=1e-6)),
             ("default_capacity", 64, dict(group_size=32))]


@pytest.mark.parametrize("name,n,kw", MOE_LOCAL,
                         ids=[c[0] for c in MOE_LOCAL])
def test_moe_one_device_matches_jax(name, n, kw):
    """``moe_apply(mesh=None)`` on the JAX init's parameters equals the JAX
    function: no drops, grouped routing, capacity 1 (at most one token an
    expert survives, the rest combine to 0) and the default factor."""
    params, x = _moe_setup(n_tokens=n)
    want = np.asarray(JM.moe_apply(params, jnp.asarray(x), mesh=None, **kw))
    got = TM.moe_apply(moe_params_from_jax(_host(params), device="cpu"),
                       torch.from_numpy(x), mesh=None, **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if name == "drops":
        assert np.count_nonzero(np.any(got != 0, axis=1)) <= 4


def test_moe_bf16_tokens_match_jax():
    """bf16 tokens (2048, routing in f32 as in the JAX package): the port's
    bf16 output equals the JAX package's within one bf16 rounding, and
    routes as the f32 call does (``tests/test_parallel.py:543``'s
    corruption check)."""
    params, x = _moe_setup(n_tokens=2048, d=8, experts=4)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(JM.moe_apply(params, xb, capacity_factor=4.0,
                                   mesh=None), np.float32)
    tp = moe_params_from_jax(_host(params), device="cpu")
    got = TM.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16),
                       capacity_factor=4.0, mesh=None)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())
    y32 = TM.moe_apply(tp, torch.from_numpy(x), capacity_factor=4.0,
                       mesh=None).numpy()
    assert np.mean(np.any(np.abs(got - y32) > 0.05, axis=1)) < 0.02


@pytest.mark.parametrize("name,kw,shard,bf16", MOE_SHARDED,
                         ids=[c[0] for c in MOE_SHARDED])
def test_moe_sharded_matches_jax(ranks, name, kw, shard, bf16):
    """On ``{"data": 2, "expert": 4}`` each rank's rows of the output
    (tokens over ``data``, experts over ``expert``, one rank-order sum of
    the combine over ``expert``) equal the JAX ``moe_apply`` on the same
    mesh shape; every expert rank of a data row holds the same bits."""
    jobs, out = ranks
    params, x = _moe_setup(n_tokens=64)
    if bf16:
        want = np.asarray(JM.moe_apply(
            params, jnp.asarray(x).astype(jnp.bfloat16), mesh=None, **kw),
            np.float32)
        tol = dict(rtol=0, atol=2.0 ** -8 * np.abs(want).max())
    else:
        mesh = _jmesh({"data": 2, "expert": 4})
        p_s = jax.device_put(params, JM.moe_sharding(mesh))
        x_s = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
        want = np.asarray(jax.jit(lambda p, t: JM.moe_apply(
            p, t, mesh=mesh, data_axis="data", **kw))(p_s, x_s))
        tol = TOL
    for r in OCT:
        got = out[r]["moe"][name]
        assert got["dtype"] == ("torch.bfloat16" if bf16 else
                                "torch.float32")
        d_i = r // 4
        np.testing.assert_allclose(got["y"], want[d_i * 32:(d_i + 1) * 32],
                                   **tol)
        np.testing.assert_array_equal(got["y"],
                                      out[d_i * 4]["moe"][name]["y"])


def test_moe_sharding_is_the_jax_placement():
    """``moe_sharding``: the router replicated, the experts split on dim
    0 (the JAX ``P()`` / ``P("expert")``); a mesh without the axis
    raises."""
    assert tuple(TM.moe_sharding(local_mesh(("expert",)))) == (None, 0, 0)
    with pytest.raises(ValueError, match="no axis 'expert'"):
        TM.moe_sharding(local_mesh(("data",)))


# ------------------------------------------------------------ errors


def test_errors_match_the_jax_package(ranks):
    """The ValueErrors of ``tests/test_parallel.py:114-125`` and
    ``:463-476``, on every rank: a ragged sequence (30 over a ring of 4),
    fewer heads than ranks, a batch ``n_micro`` does not divide, params of
    3 stages on a pipe axis of 4, a mesh without a pipe axis."""
    _, out = ranks
    for r in QUAD:
        e = out[r]["errors"]
        assert "not divisible by ring size 4" in e["ring_ragged"]
        assert "seq 30 not divisible" in e["ulysses_ragged"]
        assert "heads 2 not divisible by axis size 4" in e["ulysses_heads"]
        assert "no axis 'pipe'" in e["pipe_axis"]
        p = out[r]["pipe_errors"]
        assert "not divisible by n_micro" in p["n_micro"]
        assert "params leading dim" in p["leading"]


def test_moe_group_size_must_divide():
    params, x = _moe_setup(n_tokens=32)
    with pytest.raises(ValueError, match="not divisible by group_size"):
        TM.moe_apply(moe_params_from_jax(_host(params), device="cpu"),
                     torch.from_numpy(x), group_size=7, mesh=None)
