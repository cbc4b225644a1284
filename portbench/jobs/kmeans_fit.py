"""Whole ``KMeans.fit`` calls (BSP Lloyd's rounds) on a host table of
float64 feature rows.

Each fit of a run takes its own estimator seed (:func:`.seeds.fit_seed`),
which moves the random init and leaves the work the same.  The check
samples fits of the window from the run's seed and holds each one's
centroids against the reference's Lloyd's rounds from the same init
(``reference/kmeans.py``), by the median centroid's gap: over 20 rounds
a point near a tie that rounds the other way moves a fifth of the
centroids off the reference's, so no higher quantile holds.  Every
centroid is held by the same call with one round from the first sampled
fit's init (``round1``): there only a point near a tie may join another
centroid, and the centroids such points may join (``near_ties``, from
the reference alone) are left out of its widest gap.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import kmeans as ref_km
from .base import FitJob
from .seeds import sample
from .unit import Unit


_KM = "flink_ml_tpu_torch.models.clustering.kmeans"


class Job(FitJob):
    name = "kmeans_fit"
    #: the fit's host steps, spanned in the traced fit (``profiling``)
    host_spans = [(_KM, "stack_vectors"), (_KM, "_select_init"),
                  (_KM, "fit_centroids")]

    def estimator(self, seed: int, max_iter: int):
        from flink_ml_tpu_torch.models.clustering.kmeans import KMeans

        c = self.config
        est = KMeans(device=self.device.type)
        est.set_k(int(c["k"]))
        est.set_max_iter(max_iter)
        est.set_seed(seed)
        est.set("initMode", c["init_mode"])
        est.set("distanceMeasure", c["distance_measure"])
        est.set("workset", bool(c["workset"]))
        return est

    def fit(self, table, seed: int, max_iter=None):
        est = self.estimator(seed, max_iter or int(self.config["max_iter"]))
        model = est.fit(table)
        centroids = np.asarray(model.get_model_data()[0]["centroids"])[0]
        return {"centroids": centroids}, {}

    def flops_per_fit(self) -> float:
        """Lloyd's products: 2 n k d a round, every round."""
        c = self.config
        return 2.0 * int(c["n"]) * int(c["k"]) * int(c["d"]) * int(
            c["max_iter"])

    # -- correctness ------------------------------------------------------
    def points(self, columns: dict) -> torch.Tensor:
        """The float32 points on the device, as the fit converts them."""
        return torch.from_numpy(np.ascontiguousarray(
            columns["features"].astype(np.float32))).to(self.device)

    def reference(self, columns: dict, seed: int, points=None,
                  rounds=None, ties: bool = False, **variant):
        """The reference's centroids; with ``ties``, ``{"centroids",
        "tied"}``, the second the init's :func:`near_ties` mask."""
        host = columns["features"].astype(np.float32)
        init = torch.from_numpy(ref_km.init_centroids(
            host, int(self.config["k"]), seed)).to(self.device)
        pts = self.points(columns) if points is None else points
        if rounds is None:
            rounds = int(self.config["max_iter"])
        got = ref_km.lloyd(pts, init, rounds, **variant).cpu().numpy()
        if not ties:
            return got
        return {"centroids": got,
                "tied": ref_km.near_ties(pts, init).cpu().numpy()}

    @staticmethod
    def as_output(ref) -> dict:
        return {"centroids": ref["centroids"] if isinstance(ref, dict)
                else ref}

    def faults(self) -> dict:
        """The faults a fit can have, planted in the reference put in the
        program's place: rounds that leave the centroids as they were,
        half of the points left out of every mean, and the last sixteenth
        of the centroids left where they were."""
        return {"fault_unchanged": {"rounds": 0},
                "fault_half": {"keep_half": True},
                "fault_stale_last": {
                    "stale_last": int(self.config["k"]) // 16}}

    def program_variants(self) -> dict:
        """The program's own path one precision down: the stats kernel's
        bfloat16 products (``compute_dtype``), a second control."""
        def bf16(table, seed):
            est = self.estimator(seed, int(self.config["max_iter"]))
            est.compute_dtype = torch.bfloat16
            model = est.fit(table)
            return {"centroids": np.asarray(
                model.get_model_data()[0]["centroids"])[0]}

        return {"program_bf16": bf16}

    @staticmethod
    def numbers(out: dict, ref) -> dict:
        tied = ref["tied"] if isinstance(ref, dict) else None
        ref = Job.as_output(ref)["centroids"]
        gaps = ref_km.centroid_gaps(out["centroids"], ref)
        nums = {"centroid_gap_median": float(np.median(gaps)),
                "centroid_gap_q90": float(np.quantile(gaps, 0.9)),
                "centroid_gap_max": float(np.max(gaps)),
                "centroids_moved_share": float(np.mean(gaps > 1e-5))}
        if tied is not None:
            nums["centroid_gap_max_untied"] = float(np.max(gaps[~tied]))
            nums["tied_share"] = float(np.mean(tied))
        return nums

    def units(self, columns: dict, kept: list, seed: int) -> list:
        """A sample of the window's fits, drawn from the run's seed, each
        against the reference's rounds from the same init; and one round
        of the same call from the first sampled fit's init."""
        pts = self.points(columns)
        out = []
        picked = sample(seed, len(kept), int(self.traffic["check_fits"]))
        for j in picked:
            fseed, got = kept[j]
            out.append(Unit(
                f"fit@{j}", got,
                lambda fseed=fseed, **v: self.reference(columns, fseed, pts,
                                                        **v),
                self.as_output, self.numbers))
        fseed = kept[picked[0]][0]
        got, _ = self.fit(self.table(columns), fseed, max_iter=1)
        out.append(Unit(
            "round1", got,
            lambda **v: self.reference(columns, fseed, pts,
                                       **{"rounds": 1, "ties": True, **v}),
            self.as_output, self.numbers))
        return out
