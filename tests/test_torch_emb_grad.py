"""The port's routed embedding gradient (``flink_ml_tpu_torch.ops.emb_grad``)
against the JAX package's ``ops/emb_grad.py`` and ``ops/emb_grad_pallas.py``
on seeded numpy data: the routes array for array, the fold's plain version
bit for bit against the Pallas fold in interpret mode and the XLA fold, and
the routed table gradients of both placements bit for bit against the JAX
package's and close to a scatter-add oracle.  The port runs on the CPU,
where :func:`fold_runs` takes its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_ml_tpu.ops import emb_grad as JG
from flink_ml_tpu.ops.emb_grad_pallas import fold_block_n, fold_runs_fused
from flink_ml_tpu_torch.ops import emb_grad as TG

PLACEMENTS = ("gather", "scatter")


def _oracle(ids, g, num_rows):
    out = np.zeros((num_rows, g.shape[-1]), np.float64)
    np.add.at(out, ids.reshape(-1), g.reshape(-1, g.shape[-1]))
    return out.astype(np.float32)


def _cat(kind, seed=0):
    """(steps, batch, fields) ids of a route case and its vocabulary."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 200, size=(3, 64, 4)), 200
    if kind == "heavy":               # one id floods half the slots
        cat = rng.integers(0, 4096, size=(2, 128, 4))
        cat[0, :64, 0] = 7
        cat[1, :, 2] = 11
        return cat, 4096
    if kind == "unique":              # every id distinct: no fold pass
        return rng.permutation(1000)[:2 * 40 * 5].reshape(2, 40, 5), 1000
    if kind == "same":                # one run per step
        return np.full((2, 33, 3), 6), 10
    if kind == "ragged":              # S = 25 * 26 = 650: no block divides
        cat = rng.integers(0, 300, size=(2, 25, 26))
        cat[1, :, 3] = 42
        return cat, 300
    raise ValueError(kind)


KINDS = ("uniform", "heavy", "unique", "same", "ragged")


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("kind", KINDS)
def test_route_equals_jax_array_for_array(kind, placement):
    cat, vocab = _cat(kind)
    want = JG.emb_grad_route(cat, vocab, placement=placement, device=False)
    got = TG.emb_grad_route(cat, vocab, placement=placement)
    assert got.placement == want.placement == placement
    assert got.fold_passes == want.fold_passes
    assert got.num_rows == want.num_rows and got.steps == want.steps
    assert len(got.stacked_arrays()) == len(want.stacked_arrays())
    for a, b in zip(got.stacked_arrays(), want.stacked_arrays()):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if kind == "unique":
        assert got.fold_passes == 0


def test_route_auto_budget_and_errors(monkeypatch):
    cat = np.random.default_rng(8).integers(0, 100, size=(2, 8, 2))
    assert TG.emb_grad_route(cat, 100, placement="auto").placement == "gather"
    monkeypatch.setattr(TG, "_POS_MAP_BUDGET_BYTES", 4)
    monkeypatch.setattr(JG, "_POS_MAP_BUDGET_BYTES", 4)
    got = TG.emb_grad_route(cat, 100, placement="auto")
    want = JG.emb_grad_route(cat, 100, placement="auto", device=False)
    assert got.placement == want.placement == "scatter"
    assert got.pos_map is None
    need = max(len(np.unique(cat[s])) for s in range(2))
    for placement in PLACEMENTS:
        with pytest.raises(ValueError, match="u_cap"):
            TG.emb_grad_route(cat, 100, u_cap=need - 1, placement=placement)
        with pytest.raises(ValueError, match="u_cap"):
            JG.emb_grad_route(cat, 100, u_cap=need - 1, placement=placement)
    capped = TG.emb_grad_route(cat, 100, u_cap=need + 5, placement="scatter")
    np.testing.assert_array_equal(
        capped.out_ids.numpy(),
        np.asarray(JG.emb_grad_route(cat, 100, u_cap=need + 5,
                                     placement="scatter",
                                     device=False).out_ids))
    with pytest.raises(ValueError, match="unknown placement"):
        TG.emb_grad_route(cat, 100, placement="dense")


def _sorted_case(kind, E, seed=1):
    """Step 0 of a route case: sorted ids, sorted-order gradient rows (the
    permutation gather of a seeded (S, E) array) and fold_passes."""
    cat, vocab = _cat(kind)
    route = TG.emb_grad_route(cat, vocab)
    S = route.order.shape[1]
    g = np.random.default_rng(seed).normal(size=(S, E)).astype(np.float32)
    g[::7] = -0.0                     # -0.0 + 0.0 must round like XLA
    sorted_g = g[route.order[0].numpy()]
    return route.sorted_ids[0].numpy(), sorted_g, route.fold_passes


@pytest.mark.parametrize("E", [1, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_fold_plain_is_bitwise_the_jax_fold(kind, E):
    """The plain fold equals the XLA fold (``_folded_ext``) bit for bit,
    and the Pallas fold in interpret mode where its block rule admits the
    shape (S a multiple of a power-of-two block >= 2^fold_passes)."""
    sid, g, P = _sorted_case(kind, E)
    got = TG.fold_runs_plain(torch.from_numpy(g), torch.from_numpy(sid), P)
    S = sid.shape[0]
    ident = jnp.arange(S, dtype=jnp.int32)
    ext, _ = JG._folded_ext(jnp.asarray(g), ident, jnp.asarray(sid), P)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ext)[:S])
    bn = fold_block_n(S, P)
    if bn is not None and P >= 1:
        pallas = fold_runs_fused(jnp.asarray(g), jnp.asarray(sid),
                                 fold_passes=P, block_n=bn, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    if E == 1:                        # the squeezed (S,) payload
        flat = TG.fold_runs_plain(torch.from_numpy(g[:, 0]),
                                  torch.from_numpy(sid), P)
        np.testing.assert_array_equal(flat.numpy(), got.numpy()[:, 0])
    # the wrapper on the CPU is the plain version
    if P >= 1:
        np.testing.assert_array_equal(
            TG.fold_runs(torch.from_numpy(g), torch.from_numpy(sid),
                         P).numpy(), got.numpy())


def test_fold_pallas_cases_run_in_interpret_mode():
    """Two of the cases above fit the Pallas block rule, so the interpret
    mode comparison really ran."""
    ran = 0
    for kind in ("heavy", "uniform"):
        sid, _, P = _sorted_case(kind, 1)
        ran += fold_block_n(sid.shape[0], P) is not None and P >= 1
    assert ran == 2


def test_fold_wrapper_validates():
    g = torch.zeros((6, 2))
    ids = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="fold_passes >= 1"):
        TG.fold_runs(g, ids, 0)
    with pytest.raises(TypeError, match="int32"):
        TG.fold_runs(g, ids.long(), 1)
    with pytest.raises(TypeError, match="float32"):
        TG.fold_runs(g.double(), ids, 1)
    with pytest.raises(ValueError, match="shape"):
        TG.fold_runs(g, ids[:5], 1)
    assert torch.equal(TG.fold_runs(g + 1, ids, 2), torch.full(
        (6, 2), 4.0) - torch.tensor([[0.0], [0.0], [0.0], [1.0], [2.0],
                                     [3.0]]))
    assert TG.LAUNCHES["fold_runs"] == 0   # plain versions never count


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("E", [1, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_routed_grad_bitwise_jax_and_close_to_scatter_add(kind, E, placement):
    cat, vocab = _cat(kind)
    jr = JG.emb_grad_route(cat, vocab, placement=placement)
    tr = TG.emb_grad_route(cat, vocab, placement=placement)
    rng = np.random.default_rng(4)
    for s in range(cat.shape[0]):
        g = rng.normal(size=(int(np.prod(cat.shape[1:])), E)).astype(
            np.float32)
        payload = g[:, 0] if E == 1 else g       # the squeezed wide table
        got = tr.apply(torch.from_numpy(payload), *tr.step_slice(s))
        want = jr.apply(jnp.asarray(payload),
                        *(jnp.asarray(np.asarray(a)) for a in
                          jr.step_slice(s)))
        assert tuple(got.shape) == ((vocab,) if E == 1 else (vocab, E))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(
            got.numpy().reshape(vocab, -1), _oracle(cat[s], g, vocab),
            rtol=1e-5, atol=1e-5)
        # plain=True is the same function on the CPU
        assert torch.equal(got, tr.apply(torch.from_numpy(payload),
                                          *tr.step_slice(s), plain=True))


def test_route_to_moves_every_tensor():
    cat, vocab = _cat("uniform")
    for placement in PLACEMENTS:
        r = TG.emb_grad_route(cat, vocab, placement=placement)
        moved = r.to("cpu")
        assert moved.placement == placement
        assert moved.fold_passes == r.fold_passes
        for a, b in zip(moved.stacked_arrays(), r.stacked_arrays()):
            assert torch.equal(a, b)


def _fold_grouped_numpy(g, sid, passes, group_levels, tile, in_place):
    """The fold as the kernel runs it, in numpy f32: levels in groups of
    ``group_levels``; group ``i`` folds over super-rows of stride
    ``2^(i*L)`` (row ``j = s * stride + r``), cut into tiles of ``tile``
    super-rows that each stage the following ``2^levels - 1`` super-rows
    and compute, at each level, only the rows the later levels read.

    ``in_place``: a level writes only the rows that match, and the "+ 0.0"
    of a row that does not match (which turns -0.0 into +0.0) is applied
    when the row is next read: at its next match (as a row or a partner)
    or at the output, wherever the previous level did not match it."""
    def canon(x):
        return x + np.float32(0.0)

    S = g.shape[0]
    cur = g.copy()
    for base in range(0, passes, group_levels):
        levels = min(group_levels, passes - base)
        stride = 1 << base
        sup = -(-S // stride)
        pad = sup * stride - S
        vals = np.concatenate([cur, np.zeros((pad,) + cur.shape[1:],
                                             np.float32)])
        vals = vals.reshape((sup, stride) + cur.shape[1:])
        ids = np.concatenate([sid, np.zeros(pad, sid.dtype)]).reshape(
            sup, stride)
        live = (np.arange(sup * stride) < S).reshape(sup, stride)
        halo = (1 << levels) - 1
        out = np.empty_like(vals)
        for s0 in range(0, sup, tile):
            win = np.arange(s0, s0 + tile + halo)
            inside = win < sup
            w = np.where(inside[:, None, None] if vals.ndim == 3
                         else inside[:, None],
                         vals[np.minimum(win, sup - 1)], 0.0).astype(
                             np.float32)
            wid = ids[np.minimum(win, sup - 1)]
            wlive = live[np.minimum(win, sup - 1)] & inside[:, None]
            prev = None               # the previous level's match bits
            for k in range(levels):
                off = 1 << k
                limit = tile + (1 << levels) - (2 << k)
                same = wlive[off:off + limit] & (wid[off:off + limit]
                                                 == wid[:limit])
                bc = same[..., None] if w.ndim == 3 else same
                nxt = w.copy()
                if not in_place:
                    nxt[:limit] = w[:limit] + np.where(
                        bc, w[off:off + limit], np.float32(0.0))
                else:
                    a, b = w[:limit], w[off:off + limit]
                    if prev is not None:
                        pa = prev[:limit, ..., None] if w.ndim == 3 \
                            else prev[:limit]
                        pb = prev[off:off + limit, ..., None] \
                            if w.ndim == 3 else prev[off:off + limit]
                        a = np.where(pa, a, canon(a))
                        b = np.where(pb, b, canon(b))
                    nxt[:limit] = np.where(bc, a + b, w[:limit])
                    prev = np.zeros(wid.shape, bool)
                    prev[:limit] = same
                w = nxt
            if in_place:
                pw = prev[..., None] if w.ndim == 3 else prev
                w = np.where(pw, w, canon(w))
            n = min(tile, sup - s0)
            out[s0:s0 + n] = w[:n]
        cur = out.reshape((sup * stride,) + cur.shape[1:])[:S]
    return cur


def _deep_case(kind, E, seed=3):
    """Sorted ids and rows with runs deep enough for the heavy-hitter (P =
    12) and deep (P = 14) routes, and a ragged S."""
    rng = np.random.default_rng(seed)
    if kind == "heavy":               # a run of 2100: 12 passes
        cat = np.concatenate([np.full(2100, 7), rng.integers(0, 900, 2901)])
    elif kind == "deep":              # a run of 9000: 14 passes
        cat = np.concatenate([np.full(9000, 5), rng.integers(0, 50, 1003)])
    else:                             # ragged: S = 1000 x 26 / 13 + 3
        cat = rng.integers(0, 300, size=2003)
        cat[:77] = 42
    route = TG.emb_grad_route(cat.reshape(1, -1, 1), int(cat.max()) + 1)
    S = route.order.shape[1]
    g = rng.normal(size=(S, E)).astype(np.float32)
    g[::7] = -0.0
    return (route.sorted_ids[0].numpy(), g[route.order[0].numpy()],
            route.fold_passes)


@pytest.mark.parametrize("group_levels", [1, 3, 7])
@pytest.mark.parametrize("E", [1, 64])
@pytest.mark.parametrize("kind", ["heavy", "deep", "ragged"])
def test_fold_in_strided_level_groups_is_bitwise_the_plain_fold(
        kind, E, group_levels):
    """The identity the fold kernel rests on: the P levels run as groups
    of L levels, the later ones over super-rows of stride 2^(gL) in tiles
    with a halo, give the plain fold bit for bit."""
    sid, g, P = _deep_case(kind, E)
    assert P == {"heavy": 12, "deep": 14, "ragged": 7}[kind]
    # the seeded rows, and rows of signed zeros and ones, where the sign of
    # a zero sum depends on every "+ 0.0" on its way
    pick = np.random.default_rng(5).integers(0, 8, size=g.shape)
    zeros = np.choose(np.minimum(pick, 2), [np.float32(0.0),
                                            np.float32(1.0),
                                            np.float32(-0.0)])
    for rows in (g, zeros.astype(np.float32)):
        want = TG.fold_runs_plain(torch.from_numpy(rows),
                                  torch.from_numpy(sid), P).numpy()
        for tile in (5, 37):
            for in_place in (False, True):
                got = _fold_grouped_numpy(rows, sid, P, group_levels, tile,
                                          in_place)
                np.testing.assert_array_equal(got.view(np.int32),
                                              want.view(np.int32))
