"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have (one card: no exchange between
cards to leave out).  The harness's look for a card is skipped and the
cells are cut small (``tiny``); the limits are the cells' own."""

import time

import pytest

import tiny
from portbench import harness

WD = "flink_ml_tpu_torch.models.recommendation.widedeep"
KM = "flink_ml_tpu_torch.models.clustering.kmeans"


def _run(cell):
    result, _ = harness.run(tiny.argv(cell, seed=3_000_000_077),
                            t0=time.perf_counter(), require_card=False,
                            device="cpu", spec_hook=tiny.shrink)
    return result


def wd_unchanged(mp):
    import flink_ml_tpu_torch.models.recommendation.widedeep as w

    mp.setattr(w, "adam_update",
               lambda grads, state, params, *a, **k: (params, state))


def wd_frozen_after_epoch1(mp):
    import flink_ml_tpu_torch.models.recommendation.widedeep as w

    update = w.adam_update
    steps = tiny.SIZES["wd_criteo.fit"]["rows"] // tiny.SIZES[
        "wd_criteo.fit"]["global_batch_size"]

    def frozen(grads, state, params, *a, **k):
        if state.count >= steps:
            return params, state
        return update(grads, state, params, *a, **k)

    mp.setattr(w, "adam_update", frozen)


def wd_half_batch(mp):
    import flink_ml_tpu_torch.models.recommendation.widedeep as w

    loss = w.logistic_loss

    def half(margin, labels, weights):
        h = margin.shape[0] // 2
        return loss(margin[:h], labels[:h], weights[:h])

    mp.setattr(w, "logistic_loss", half)


def wd_altered(mp):
    import flink_ml_tpu_torch.models.recommendation.widedeep as w

    to_host = w._params_to_host

    def altered(params):
        host = to_host(params)
        host["mlp"][0]["w"] = host["mlp"][0]["w"] * 1.01
        return host

    mp.setattr(w, "_params_to_host", altered)


def km_unchanged(mp):
    import flink_ml_tpu_torch.models.clustering.kmeans as k
    from flink_ml_tpu_torch.iteration import IterationBodyResult

    iterate = k.iterate

    def frozen(body, init, data, **kw):
        return iterate(lambda c, e, d: IterationBodyResult(feedback=c),
                       init, data, **kw)

    mp.setattr(k, "iterate", frozen)


def km_half(mp):
    import flink_ml_tpu_torch.models.clustering.kmeans as k

    fit = k.fit_centroids

    def half(points, mask, *a, **kw):
        h = points.shape[0] // 2
        return fit(points[:h], mask[:h], *a, **kw)

    mp.setattr(k, "fit_centroids", half)


def km_altered(mp):
    import flink_ml_tpu_torch.models.clustering.kmeans as k

    fit = k.fit_centroids

    def altered(*a, **kw):
        result = fit(*a, **kw)
        result.state.mul_(1.001)
        return result

    mp.setattr(k, "fit_centroids", altered)


def km_stale_last(mp):
    import flink_ml_tpu_torch.models.clustering.kmeans as k

    fit = k.fit_centroids

    def stale(points, mask, init, *a, **kw):
        result = fit(points, mask, init, *a, **kw)
        last = init.shape[0] // 16
        result.state[-last:] = init[-last:].to(result.state)
        return result

    mp.setattr(k, "fit_centroids", stale)


@pytest.mark.parametrize("cell", ["wd_criteo.fit", "kmeans_sift1m.fit"])
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("cell,fault", [
    ("wd_criteo.fit", wd_unchanged),
    ("wd_criteo.fit", wd_frozen_after_epoch1),
    ("wd_criteo.fit", wd_half_batch),
    ("wd_criteo.fit", wd_altered),
    ("kmeans_sift1m.fit", km_unchanged),
    ("kmeans_sift1m.fit", km_half),
    ("kmeans_sift1m.fit", km_altered),
    ("kmeans_sift1m.fit", km_stale_last),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(cell)
    assert result["correct"] is False
    assert result["failed"] >= 1
