"""The route of the port's bf16 stats op: ``bf16_plan`` (which shapes
``kernels/csrc/kmeans_bf16.cu`` takes; the rest take ``kmeans.cu``'s bf16
modes), the CPU path (the plain twin, bit for bit, whatever the route),
and a problem where the bf16 rounding of the points moves an argmin,
held against the JAX package's bf16 kernel in interpret mode.

The card side of the same checks is in ``tests/test_torch_cuda.py``
(``test_kmeans_update_stats_bf16_matches_plain`` and
``test_kmeans_bf16_kernel_sees_bf16_operands``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_ml_tpu.ops import kmeans_pallas as JK
from flink_ml_tpu_torch.ops import kmeans as TK

TIES = ("first", "fast", "split")
BLOCK = 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k,d,want", [
    (256, 64, 2),      # the headline (2^20 x 64, k 256)
    (16, 8, 1),        # the data-parallel fit's problem
    (37, 16, 1), (40, 9, 1), (128, 64, 1), (129, 64, 2), (1, 1, 1),
    (257, 64, None),   # just past the plan: k
    (256, 65, None),   # just past the plan: d
    (200, 128, None), (1024, 64, None), (600, 300, None), (0, 64, None),
])
def test_bf16_plan(k, d, want):
    """The score products of 128 centroids ``kmeans_bf16.cu`` takes for
    (k, d), ``None`` outside its plan (k <= 256, d <= 64)."""
    assert TK.bf16_plan(k, d) == want


@pytest.mark.parametrize("tie", TIES)
@pytest.mark.parametrize("n,d,k", [(4099, 64, 256), (1000, 16, 37),
                                   (2050, 128, 200)])
def test_cpu_path_is_the_plain_twin(n, d, k, tie):
    """On the CPU the op returns its plain twin's output bit for bit on
    both sides of the route, and launches nothing."""
    rng = np.random.default_rng(n + k)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    pts[-7:] = 0.0
    cents = pts[rng.permutation(n - 7)[:k]].copy()
    cents[k - 1] = cents[0]
    TK.reset_launch_counts()
    got = TK.kmeans_update_stats(_t(pts), _t(cents), tie_policy=tie,
                                 compute_dtype=torch.bfloat16)
    want = TK.kmeans_update_stats_plain(_t(pts), _t(cents), tie_policy=tie,
                                        compute_dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sum(TK.LAUNCHES.values()) == 0


def rounding_problem():
    """128 copies of a point whose bf16 rounding moves its argmin:
    p = (1.124, 0) is nearer centroid 1 (1, 0) than centroid 0 (1.25, 0)
    in f32, but bf16(p) = (1.125, 0) scores -1.25 against both exactly,
    so under bf16 ``first`` takes centroid 0, ``fast`` counts both and
    ``split`` halves.  Centroid 2 is far away."""
    pts = np.tile(np.array([[1.124, 0.0]], np.float32), (BLOCK, 1))
    cents = np.array([[1.25, 0.0], [1.0, 0.0], [-5.0, -5.0]], np.float32)
    return pts, cents


# counts and the x-sums under bf16 (share * bf16(p) = share * 1.125)
ROUNDED = {"first": ([BLOCK, 0, 0], [1.125 * BLOCK, 0, 0]),
           "fast": ([BLOCK, BLOCK, 0], [1.125 * BLOCK, 1.125 * BLOCK, 0]),
           "split": ([BLOCK / 2] * 2 + [0], [1.125 * BLOCK / 2] * 2 + [0])}


@pytest.mark.parametrize("which", ["port", "jax"])
@pytest.mark.parametrize("tie", TIES)
def test_bf16_rounding_moves_the_argmin(which, tie):
    """Both products take bf16 operands: the counts follow bf16(p)'s tie,
    the sums add bf16(p) = 1.125, in the port's op and in the JAX
    kernel; in f32 every copy goes to centroid 1 with its f32 value."""
    pts, cents = rounding_problem()
    if which == "port":
        s, c = TK.kmeans_update_stats(_t(pts), _t(cents), tie_policy=tie,
                                      compute_dtype=torch.bfloat16)
        s, c = s.numpy(), c.numpy()
    else:
        s, c = JK.kmeans_update_stats(jnp.asarray(pts), jnp.asarray(cents),
                                      block_n=BLOCK, tie_policy=tie,
                                      compute_dtype=jnp.bfloat16,
                                      interpret=True)
        s, c = np.asarray(s), np.asarray(c)
    counts, xsums = ROUNDED[tie]
    np.testing.assert_array_equal(c, np.float32(counts))
    np.testing.assert_array_equal(s[:, 0], np.float32(xsums))
    np.testing.assert_array_equal(s[:, 1], 0.0)
    s32, c32 = TK.kmeans_update_stats(_t(pts), _t(cents), tie_policy=tie)
    np.testing.assert_array_equal(c32.numpy(), [0, BLOCK, 0])
    np.testing.assert_allclose(s32.numpy()[1, 0], 1.124 * BLOCK, rtol=1e-6)
