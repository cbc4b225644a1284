"""The port's entry points (``flink_ml_tpu_torch/entry.py``)
against the JAX package's root ``__graft_entry__.py``:

- ``entry(device="cpu")``: the same initial parameters (the port's own
  draws, and the JAX entry's carried across by ``utils/convert.py``), the
  same example batch, and the same scores within ``rtol=1e-5, atol=1e-6``
  (f32 products of another order);
- ``dryrun_multichip(4, device="cpu")`` completes on 4
  gloo CPU ranks, every leg held to its oracle inside the ranks; the
  report's compressed-step payload is the JAX package's
  ``payload_bytes`` of the same dense tower; on the CPU no kernel launches
  and every held call equals its plain version;
- both entry points raise without a card when the CPU was not asked for.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from flink_ml_tpu.parallel.grad_reduce import (GradReduceConfig as JGR,
                                               payload_bytes as jpayload)
from flink_ml_tpu_torch import entry as TE
from flink_ml_tpu_torch.models.recommendation.widedeep import tree_leaves
from flink_ml_tpu_torch.utils.convert import widedeep_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_entry():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry_reference", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_the_jax_entry():
    """The port's forward on its own draws, and on the JAX entry's
    parameters carried across, equals the JAX entry's scores; the
    configuration constants are the JAX entry's."""
    J = _jax_entry()
    assert (TE.VOCAB_SIZES, TE.EMB_DIM, TE.HIDDEN, TE.D_DENSE) == \
        (J.VOCAB_SIZES, J.EMB_DIM, J.HIDDEN, J.D_DENSE)
    jfn, (jparams, jdense, jcat) = J.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jdense, jcat))
    fn, (params, dense, cat) = TE.entry(device="cpu")
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense))
    np.testing.assert_array_equal(cat.numpy(), np.asarray(jcat))
    host = jax.device_get(jparams)
    for a, b in zip(tree_leaves(params),
                    tree_leaves(widedeep_params_from_jax(host, "cpu"))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    got = fn(params, dense, cat)
    assert tuple(got.shape) == (256,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    carried = fn(widedeep_params_from_jax(host, "cpu"), dense, cat)
    np.testing.assert_allclose(carried.numpy(), want, rtol=1e-5, atol=1e-6)


def test_dryrun_multichip_on_cpu_ranks():
    """Every leg on 4 gloo CPU ranks (a rank that fails an oracle fails the
    call); each rank reports every leg, no launch on the CPU, every held
    call equal to its plain version (B1, B2 and B7 on the legs' paths),
    and the JAX package's payload for the top-k 0.1 step."""
    report = TE.dryrun_multichip(4, device="cpu")
    assert report["seconds"] < TE.DRYRUN_BUDGET_S
    legs = ("widedeep dp x tp", "compressed grad reduce",
            "widedeep routed grads", "mixed LR", "pp/sp/ep")
    host = jax.device_get(_jax_entry().entry()[1][0])
    tower = {k: v for k, v in host.items() if k not in ("emb", "wide_cat")}
    want = jpayload(tower, JGR(mode="topk", density=0.1))
    for rank in report["ranks"]:
        assert set(legs) <= set(rank["launches"])
        assert all(n == 0 for leg in rank["launches"].values()
                   for n in leg.values())
        held = rank["held"]
        for name in ("ell_margin", "ell_scatter_apply_fused", "fold_runs"):
            assert held[name]["checked"] > 0 and held[name]["unequal"] == 0
        got = rank["compressed grad reduce"]["payload"]
        assert (got["dense_bytes"], got["compressed_bytes"]) == \
            (want["dense_bytes"], want["compressed_bytes"])
        assert rank["mixed LR"]["data_plan"] == "plain"
        assert np.isclose(rank["widedeep dp x tp"]["loss"],
                          rank["widedeep dp x tp"]["ref_loss"], rtol=1e-5)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal")
def test_entry_points_need_a_card_unless_the_cpu_is_asked_for():
    with pytest.raises(RuntimeError, match="no GPU"):
        TE.entry()
    with pytest.raises(RuntimeError, match="no GPU"):
        TE.dryrun_multichip(2)
