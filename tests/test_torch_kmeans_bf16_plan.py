"""The plan of the port's bf16 stats op: ``bf16_plan`` (the fused pass of
``kernels/csrc/kmeans_bf16.cu`` at k <= 256 and d <= 64, its two passes
past that, with their panels, held or streamed scoring, scoring launches,
slabs and jobs), the CPU path (the plain twin, bit for bit, whatever the
plan), and a problem where the bf16 rounding of the points moves an
argmin, held against the JAX package's bf16 kernel in interpret mode.

The card side of the same checks is in ``tests/test_torch_cuda.py``
(``test_kmeans_update_stats_bf16_matches_plain``, which launches every
kind of plan, ``test_kmeans_bf16_launcher_refuses_unfit_plans`` and
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


P = TK.Bf16Plan


@pytest.mark.parametrize("k,d,want", [
    # the fused pass: 1 or 2 score products of 128 centroids a tile
    (256, 64, P("fused", 1, True, 2, 1, 1, 1)),    # the headline
    (16, 8, P("fused", 1, True, 1, 1, 1, 1)),      # the data-parallel fit
    (37, 16, P("fused", 1, True, 1, 1, 1, 1)),
    (40, 9, P("fused", 1, True, 1, 1, 1, 1)),
    (128, 64, P("fused", 1, True, 1, 1, 1, 1)),
    (129, 64, P("fused", 1, True, 2, 1, 1, 1)),
    (1, 1, P("fused", 1, True, 1, 1, 1, 1)),
    # two passes: k just past the fused pass, 2 slabs
    (257, 64, P("two_pass", 1, True, 3, 1, 2, 2)),
    # d just past it: 2 panels, 2 jobs
    (256, 65, P("two_pass", 2, True, 2, 1, 1, 2)),
    (200, 128, P("two_pass", 2, True, 2, 1, 1, 2)),
    (1024, 64, P("two_pass", 1, True, 8, 1, 4, 4)),
    # past the 9 chunks a launch holds at d 64 (where the first launch
    # packs the points; 11 at d 8): 4 scoring launches
    (4096, 64, P("two_pass", 1, True, 8, 4, 16, 16)),
    (1408, 8, P("two_pass", 1, True, 11, 1, 6, 6)),
    # 3 chunks a launch at d 128 (4 at d 72), 1 at d 256
    (1024, 128, P("two_pass", 2, True, 3, 3, 4, 8)),
    (1024, 72, P("two_pass", 2, True, 4, 2, 4, 8)),
    (300, 200, P("two_pass", 4, True, 1, 3, 2, 8)),
    # past 4 panels the scoring streams every panel pair, 16 chunks a launch
    (600, 300, P("two_pass", 5, False, 5, 1, 3, 15)),
    (100000, 1000, P("two_pass", 16, False, 16, 49, 391, 6256)),
    (0, 64, None), (64, 0, None),
])
def test_bf16_plan(k, d, want):
    """The plan the wrapper hands ``kmeans_bf16.cu``'s launcher for
    (k, d): a plan for every k >= 1 and d >= 1, ``None`` only for an
    empty shape."""
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
