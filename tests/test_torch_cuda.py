"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU (``cuda`` marker) and skips
without one.  The file imports neither JAX nor the JAX package, so it runs
on a machine with the card and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(``--noconftest`` because ``tests/conftest.py`` imports JAX).  Inputs are
small and seeded; ``chip_smoke.py`` repeats the comparison at the main
path's full shapes."""

import numpy as np
import pytest
import torch

from flink_ml_tpu_torch.models.common import sgd as TS
from flink_ml_tpu_torch.models.common.losses import LOSSES
from flink_ml_tpu_torch.ops import ell_scatter as TE

D = 128 * 128


@pytest.fixture
def cuda_device():
    """The first CUDA device; decided when the test runs, never at import,
    so every pytest worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    return torch.device("cuda", 0)


def _grid(seed, d=D, batch=200, nnz=7):
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, d, size=(1, batch, nnz)).astype(np.int32)
    cat[0, :, 0] = 777                   # a heavy index
    cat[0, :, 1] = 128 * 5 + np.arange(batch) % 3   # an overflowing row
    vals = rng.normal(size=cat.shape).astype(np.float32)
    lay = TE.ell_layout(cat, d, values=vals, heavy_threshold=150)
    w = rng.normal(size=d).astype(np.float32)
    r_ext = np.concatenate([rng.normal(size=batch),
                            np.zeros(56)]).astype(np.float32)
    return rng, lay, w, r_ext


@pytest.mark.cuda
@pytest.mark.parametrize("with_val", [False, True])
def test_kernels_match_plain(cuda_device, with_val):
    rng, lay, w, r_ext = _grid(17)
    t = lay.to(cuda_device)
    wt = torch.from_numpy(w).to(cuda_device)
    rt = torch.from_numpy(r_ext).to(cuda_device)
    val = t.val[0] if with_val else None
    TE.reset_launch_counts()
    got = TE.ell_margin(wt, t.src[0], t.pos[0], t.mask[0], m_len=256,
                        val=val)
    want = TE.ell_margin_plain(wt, t.src[0], t.pos[0], t.mask[0],
                               m_len=256, val=val)
    # atomics reorder at most ~nnz f32 terms per sample
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    got = TE.ell_scatter_apply_fused(wt, rt, t.src[0], t.pos[0], t.mask[0],
                                     lr=0.3, val=val)
    want = TE.ell_scatter_apply_fused_plain(wt, rt, t.src[0], t.pos[0],
                                            t.mask[0], lr=0.3, val=val)
    assert torch.equal(got, want)        # fixed order: bit for bit
    upd = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32)
                           ).to(cuda_device)
    assert torch.equal(TE.ell_scatter_apply(wt, upd, t.pos[0], t.mask[0]),
                       TE.ell_scatter_apply_plain(wt, upd, t.pos[0],
                                                  t.mask[0]))
    torch.cuda.synchronize()
    assert TE.LAUNCHES == {"ell_margin": 1, "ell_scatter_apply_fused": 1,
                           "ell_scatter_apply": 1}


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda_device):
    _, lay, w, _ = _grid(18)
    t = lay.to(cuda_device)
    with pytest.raises(ValueError, match="pos is on cpu"):
        TE.ell_margin(torch.from_numpy(w).to(cuda_device), t.src[0],
                      torch.from_numpy(lay.pos[0]), t.mask[0], m_len=256)


def _fit_data(n=1200, nd=13, nc=26, d=D, seed=6):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, nd)).astype(np.float32)
    cat = rng.integers(32, d, size=(n, nc)).astype(np.int32)
    y = rng.integers(0, 2, size=n).astype(np.float64)
    cat[:, 0] = np.where(y == 1, 16, 17)
    return dense, cat, y


@pytest.mark.cuda
@pytest.mark.parametrize("d,kernel", [(D, "ell_scatter_apply_fused"),
                                      (128 * 129, "ell_scatter_apply")],
                         ids=["fused", "pair"])
def test_fit_matches_plain_versions(cuda_device, d, kernel):
    """The kernels' fit against the same fit through the plain versions,
    both on the card."""
    dense, cat, y = _fit_data(d=d)
    cfg = TS.SGDConfig(learning_rate=0.5, max_epochs=2,
                       global_batch_size=400, tol=0)
    TE.reset_launch_counts()
    got, got_log = TS.sgd_fit_mixed(LOSSES["logistic"], dense, cat, y, None,
                                    d, cfg, device=cuda_device)
    assert TE.LAUNCHES["ell_margin"] == 3 * 2
    assert TE.LAUNCHES[kernel] == 3 * 2
    want, want_log = TS.sgd_fit_mixed(LOSSES["logistic"], dense, cat, y,
                                      None, d, cfg, device=cuda_device,
                                      plain=True)
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got_log, want_log, rtol=1e-4)
