"""ELL routing and kernels of the PyTorch port
(``flink_ml_tpu_torch/ops/ell_scatter.py``) against the JAX package.

On the CPU the port's kernel wrappers run their plain PyTorch versions;
these tests hold those to the JAX package's Pallas kernels (interpret
mode) and XLA twins on the same seeded inputs.  The CUDA kernels
themselves are held to the plain versions on the card
(``test_torch_cuda.py``, and ``chip_smoke.py`` at the main path's
shapes)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_ml_tpu.ops import ell_scatter as JE
from flink_ml_tpu_torch.ops import ell_scatter as TE

D = 128 * 128


def _cat(seed, steps=2, batch=200, nnz=6, d=D, heavy=False, overflow=False):
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, d, size=(steps, batch, nnz)).astype(np.int32)
    if heavy:
        cat[:, :, 0] = 777            # 2*batch slots > the threshold below
        cat[:, :, 1] = 777
    if overflow:
        # one table row receives more than 128 light slots
        cat[:, :, 2] = 128 * 5 + np.arange(batch) % 3
    return cat


@pytest.fixture(params=["native", "numpy"])
def layout_path(request, monkeypatch):
    """Run both packages' layout code on the same path: the native
    counting sort (shared ``native/ell_layout.cpp``) or numpy."""
    if request.param == "numpy":
        for mod in (JE, TE):
            monkeypatch.setattr(mod, "_ELL_NATIVE", None)
            monkeypatch.setattr(mod, "_ELL_NATIVE_TRIED", True)
    else:
        assert TE._native_ell() is not None, "native layout library did not load"
    return request.param


_FIELDS = ("src", "pos", "mask", "ovf_idx", "ovf_src", "heavy_idx",
           "heavy_cnt", "val", "ovf_val", "need_ovf", "need_heavy")


@pytest.mark.parametrize("case", ["random", "heavy", "overflow", "values"])
def test_layout_matches_jax_field_by_field(layout_path, case):
    cat = _cat(1, heavy=case in ("heavy", "values"),
               overflow=case in ("overflow", "values"))
    kw = {"heavy_threshold": 300}
    if case == "values":
        kw["values"] = np.random.default_rng(2).normal(
            size=cat.shape).astype(np.float32)
    want = JE.ell_layout(cat, D, device=False, **kw)
    got = TE.ell_layout(cat, D, **kw)
    assert (got.batch, got.num_features) == (want.batch, want.num_features)
    for f in _FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if case in ("heavy", "values"):
        assert 777 in got.heavy_idx
    if case in ("overflow", "values"):
        assert int(got.need_ovf.max()) > 0


def test_layout_caps_and_trim():
    cat = _cat(3, overflow=True)
    lay = TE.ell_layout(cat, D)
    assert lay.assert_capacities() is lay
    trimmed = TE.ell_layout(cat, D, pad_ovf_cap=4096).trim_overflow()
    assert trimmed.ovf_idx.shape[1] < 4096
    need = int(lay.need_ovf.max())
    np.testing.assert_array_equal(trimmed.ovf_idx[:, :need],
                                  lay.ovf_idx[:, :need])
    with pytest.raises(ValueError, match="forced cap"):
        TE.ell_layout(cat, D, pad_ovf_cap=8)
    with pytest.raises(ValueError, match="heavy_threshold"):
        TE.ell_layout(cat, D, heavy_threshold=64)


def test_layout_to_device_keeps_values():
    lay = TE.ell_layout(_cat(4, heavy=True), D, heavy_threshold=300)
    t = lay.to("cpu")
    for f in ("src", "pos", "mask", "ovf_idx", "ovf_src", "heavy_idx",
              "heavy_cnt"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), getattr(lay, f))
    assert t.heavy_cnt.dtype == torch.int16
    assert t.steps == lay.steps == 2


def _grid(seed, d=D, batch=200, nnz=7, with_val=False):
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, d, size=(1, batch, nnz)).astype(np.int32)
    vals = (rng.normal(size=cat.shape).astype(np.float32) if with_val
            else None)
    lay = TE.ell_layout(cat, d, values=vals)
    w = rng.normal(size=d).astype(np.float32)
    return rng, lay, w


def _routing(lay, step=0):
    """One step's sample routing of a host layout, as torch tensors."""
    val = None if lay.val is None else torch.from_numpy(lay.val[step])
    return TE.sample_routing(torch.from_numpy(lay.src[step]),
                             torch.from_numpy(lay.pos[step]),
                             torch.from_numpy(lay.mask[step]), lay.batch,
                             val=val)


@pytest.mark.parametrize("case", ["random", "heavy", "overflow", "values"])
def test_routing_holds_every_in_grid_slot_once_in_grid_order(case):
    """Every in-grid slot of the layout appears exactly once in its
    sample's routing, in ascending grid position, with -1 (and value 0)
    after the sample's last slot; the routing of the stack is the stack
    of the routings of its steps."""
    cat = _cat(21, heavy=case in ("heavy", "values"),
               overflow=case in ("overflow", "values"))
    vals = (np.random.default_rng(22).normal(size=cat.shape)
            .astype(np.float32) if case == "values" else None)
    lay = TE.ell_layout(cat, D, heavy_threshold=300, values=vals)
    t = lay.to("cpu")
    route_w, route_val = TE.sample_routing(t.src, t.pos, t.mask, lay.batch,
                                           val=t.val)
    steps, nnz, batch = route_w.shape
    assert (steps, batch) == (lay.steps, lay.batch)
    assert route_w.dtype == torch.int32
    assert (route_val is None) == (vals is None)
    most = 0
    for i in range(steps):
        src, pos, mask = lay.src[i], lay.pos[i], lay.mask[i]
        want = [[] for _ in range(batch)]        # (grid pos, w idx, val)
        for row in range(src.shape[0]):
            kept = int(pos[row, -1] + mask[row, -1])
            lanes = np.repeat(np.arange(128), np.diff(np.concatenate(
                [[0], (pos[row] + mask[row]).astype(np.int64)])))
            for s in range(kept):
                b = int(src[row, s])
                assert b < batch
                want[b].append((row * 128 + s, row * 128 + int(lanes[s]),
                                0.0 if vals is None else lay.val[i][row, s]))
        most = max(most, max(len(x) for x in want))
        rw = route_w[i].numpy()
        for b in range(batch):
            n_b = len(want[b])
            assert [x[0] for x in want[b]] == sorted(x[0] for x in want[b])
            np.testing.assert_array_equal(rw[:n_b, b],
                                          [x[1] for x in want[b]])
            assert (rw[n_b:, b] == -1).all()
            if vals is not None:
                rv = route_val[i].numpy()
                np.testing.assert_array_equal(rv[:n_b, b],
                                              [x[2] for x in want[b]])
                assert (rv[n_b:, b] == 0).all()
        one_w, one_val = _routing(lay, i)
        np.testing.assert_array_equal(one_w.numpy(), rw[:one_w.shape[0]])
        assert (rw[one_w.shape[0]:] == -1).all()
    assert nnz == most
    in_grid = sum(int((lay.src[i] < batch).sum()) for i in range(steps))
    assert int((route_w >= 0).sum()) == in_grid
    if case in ("heavy", "values"):
        assert int(lay.need_heavy.max()) >= 1
    if case in ("overflow", "values"):
        assert int(lay.need_ovf.max()) >= 1


@pytest.mark.parametrize("with_val", [False, True])
def test_margin_plain_matches_jax(with_val):
    _, lay, w = _grid(11, with_val=with_val)
    batch, m_len = lay.batch, 256
    val = lay.val[0] if with_val else None
    route_w, route_val = _routing(lay)
    got = TE.ell_margin(torch.from_numpy(w), route_w, m_len=m_len,
                        route_val=route_val)
    assert got.shape == (m_len,)
    assert (got[batch:] == 0).all()
    jargs = (jnp.asarray(w), jnp.asarray(lay.src[0]),
             jnp.asarray(lay.pos[0]), jnp.asarray(lay.mask[0]))
    jval = None if val is None else jnp.asarray(val)
    fused = np.asarray(JE.ell_margin_fused(*jargs, m_len=m_len, val=jval,
                                           interpret=True))
    xla = np.asarray(JE.ell_margin_xla(*jargs, m_len, val=jval))
    np.testing.assert_allclose(got.numpy()[:batch], fused[:batch],
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy()[:batch], xla[:batch], atol=1e-5)


@pytest.mark.parametrize("with_val", [False, True])
def test_fused_scatter_plain_matches_jax(with_val):
    rng, lay, w = _grid(12, with_val=with_val)
    r_ext = np.concatenate([rng.normal(size=lay.batch),
                            np.zeros(56)]).astype(np.float32)
    val = lay.val[0] if with_val else None
    lr = 0.35
    got = TE.ell_scatter_apply_fused(
        torch.from_numpy(w), torch.from_numpy(r_ext),
        torch.from_numpy(lay.src[0]), torch.from_numpy(lay.pos[0]),
        torch.from_numpy(lay.mask[0]), lr=lr,
        val=None if val is None else torch.from_numpy(val))
    want = np.asarray(JE.ell_scatter_apply_fused(
        jnp.asarray(w), jnp.asarray(r_ext), jnp.asarray(lay.src[0]),
        jnp.asarray(lay.pos[0]), jnp.asarray(lay.mask[0]), lr=lr,
        val=None if val is None else jnp.asarray(val),
        precision="highest", interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_pair_scatter_plain_matches_jax_on_129_rows():
    d = 128 * 129
    rng, lay, w = _grid(13, d=d)
    upd = rng.normal(size=(129, 128)).astype(np.float32)
    got = TE.ell_scatter_apply(torch.from_numpy(w), torch.from_numpy(upd),
                               torch.from_numpy(lay.pos[0]),
                               torch.from_numpy(lay.mask[0]))
    want = np.asarray(JE.ell_scatter_apply(
        jnp.asarray(w), jnp.asarray(upd), jnp.asarray(lay.pos[0]),
        jnp.asarray(lay.mask[0]), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_margin_decomposition_with_overflow_and_heavy():
    """Grid + overflow + heavy margins reproduce the direct gather when
    slots spill and a heavy index exists (the plain margin's pad slots
    stay out of the real rows)."""
    from flink_ml_tpu_torch.models.common.sgd import _ell_margin

    rng = np.random.default_rng(14)
    batch = 400
    cat = _cat(14, steps=1, batch=batch, nnz=8, heavy=True, overflow=True)
    w = rng.normal(size=D).astype(np.float32)
    lay = TE.ell_layout(cat, D, heavy_threshold=300).to("cpu")
    assert int(lay.need_heavy.max()) >= 1 and int(lay.need_ovf.max()) >= 1
    route_w, _ = TE.sample_routing(lay.src[0], lay.pos[0], lay.mask[0],
                                   batch)
    got = _ell_margin(torch.from_numpy(w), batch, route_w, lay.ovf_idx[0],
                      lay.ovf_src[0], lay.heavy_idx[0], lay.heavy_cnt[0])
    np.testing.assert_allclose(got.numpy(), w[cat[0]].sum(axis=1),
                               rtol=1e-5, atol=1e-4)


def test_margin_plain_sums_in_grid_order():
    """One sample whose slots hold 1e8, 1 and -1e8 in ascending grid
    position: summed left to right in f32 that is (1e8 + 1) - 1e8 = 0,
    where any other order that pairs the large terms first gives 1."""
    batch = 4
    cat = np.zeros((1, batch, 3), np.int32)
    cat[0, :, 0] = [128 * 2 + 5, 128 * 3, 128 * 4, 128 * 6]
    cat[0, :, 1] = [128 * 9 + 1, 128 * 10, 128 * 11, 128 * 12]
    cat[0, :, 2] = [128 * 40 + 7, 128 * 41, 128 * 42, 128 * 43]
    lay = TE.ell_layout(cat, D)
    w = np.zeros(D, np.float32)
    w[cat[0, 0]] = [1e8, 1.0, -1e8]
    route_w, _ = _routing(lay)
    np.testing.assert_array_equal(route_w[:, 0].numpy(), cat[0, 0])
    got = TE.ell_margin(torch.from_numpy(w), route_w, m_len=256)
    assert got[0].item() == 0.0
    big = np.float32(1e8)
    assert (big + np.float32(1.0)) - big == 0.0
    assert (big - big) + np.float32(1.0) == 1.0
    want = np.asarray(JE.ell_margin_xla(
        jnp.asarray(w), jnp.asarray(lay.src[0]), jnp.asarray(lay.pos[0]),
        jnp.asarray(lay.mask[0]), 256))
    np.testing.assert_array_equal(got.numpy()[:batch], want[:batch])


def test_margin_reads_zero_outside_w():
    """A route entry outside ``[0, w.numel())`` (the -1 pad, or one from
    a routing built for a larger hash space) reads 0, as on the card."""
    w = torch.arange(1, 257, dtype=torch.float32)
    route_w = torch.tensor([[3, -1, 256], [7, 255, 1 << 20]],
                           dtype=torch.int32)
    got = TE.ell_margin(w, route_w, m_len=4)
    np.testing.assert_array_equal(got.numpy(), [4.0 + 8.0, 256.0, 0, 0])


def test_margin_is_deterministic_on_repeat():
    _, lay, w = _grid(19, with_val=True)
    route_w, route_val = _routing(lay)
    wt = torch.from_numpy(w)
    a = TE.ell_margin(wt, route_w, m_len=256, route_val=route_val)
    b = TE.ell_margin(wt, route_w.clone(), m_len=256,
                      route_val=route_val.clone())
    assert torch.equal(a, b)


def test_wrappers_on_cpu_run_plain_and_count_nothing():
    _, lay, w = _grid(15)
    TE.reset_launch_counts()
    args = (torch.from_numpy(w), torch.from_numpy(lay.src[0]),
            torch.from_numpy(lay.pos[0]), torch.from_numpy(lay.mask[0]))
    route_w, _ = _routing(lay)
    a = TE.ell_margin(args[0], route_w, m_len=256)
    b = TE.ell_margin_plain(args[0], route_w, m_len=256)
    assert torch.equal(a, b)
    r_ext = torch.zeros(256)
    out = TE.ell_scatter_apply_fused(args[0], r_ext, *args[1:], lr=0.1)
    assert torch.equal(out, args[0])          # r == 0 moves nothing
    assert all(v == 0 for v in TE.LAUNCHES.values())


def test_wrappers_reject_bad_inputs():
    _, lay, w = _grid(16)
    src = torch.from_numpy(lay.src[0])
    pos = torch.from_numpy(lay.pos[0])
    mask = torch.from_numpy(lay.mask[0])
    wt = torch.from_numpy(w)
    route_w, _ = _routing(lay)
    with pytest.raises(TypeError, match="route_w must be"):
        TE.ell_margin(wt, route_w.long(), m_len=256)
    with pytest.raises(ValueError, match="w must have shape"):
        TE.ell_margin(wt.view(128, 128), route_w, m_len=256)
    with pytest.raises(ValueError, match="route_val must have shape"):
        TE.ell_margin(wt, route_w, m_len=256,
                      route_val=torch.zeros(route_w.shape[0], 3))
    with pytest.raises(ValueError, match="m_len"):
        TE.ell_margin(wt, route_w, m_len=route_w.shape[1] - 1)
    with pytest.raises(ValueError, match="contiguous"):
        TE.ell_scatter_apply(wt, torch.zeros(128, 128).t(), pos, mask)
    with pytest.raises(TypeError, match="r_ext must be"):
        TE.ell_scatter_apply_fused(wt, torch.zeros(256, dtype=torch.float64),
                                   src, pos, mask, lr=0.1)
