"""RankingEvaluator — top-k recommendation quality metrics.

Rounds out the evaluation family for the recommenders (ALS top-k scoring,
Swing similar-item lists): precision@k, recall@k, hitRate@k, NDCG@k and
MAP@k over per-row (ranked predictions, relevant items) pairs.  The
reference family ships no ranking evaluator; the metric definitions
follow the standard IR formulations (binary relevance, log2 discount,
ideal-DCG normalisation per row).

Inputs are object-array columns: ``predictionCol`` holds each row's
RANKED recommendation list, ``labelCol`` the row's set of relevant items.
Rows with no relevant items are skipped (undefined metrics).  Per-row
work is tiny ragged set arithmetic — a host loop, as with the other
evaluators' host-side finishing.

A copy of the JAX package's ``models/evaluation/ranking_evaluator.py``
(host numpy; no device).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...api.stage import AlgoOperator
from ...data.table import Table
from ...params.param import IntParam, ParamValidators, StringArrayParam
from ...params.shared import HasLabelCol, HasPredictionCol

__all__ = ["RankingEvaluator"]

_ALL_METRICS = ("precisionAtK", "recallAtK", "hitRateAtK", "ndcgAtK",
                "mapAtK")


def _item_list(cell) -> list:
    """Normalise one ragged cell into a list of items (None/NaN cells and
    entries mean 'nothing here')."""
    if cell is None:
        return []
    items = np.ravel(np.asarray(cell, dtype=object)).tolist()
    return [x for x in items
            if x is not None and not (isinstance(x, float) and np.isnan(x))]


class RankingEvaluator(HasPredictionCol, HasLabelCol, AlgoOperator):
    K = IntParam("k", "Ranking cutoff.", default=10,
                 validator=ParamValidators.gt(0))
    # param name matches the sibling evaluators' "metricsNames" so generic
    # param tooling treats the family uniformly
    METRICS = StringArrayParam(
        "metricsNames", "Subset of " + ", ".join(_ALL_METRICS) + ".",
        default=_ALL_METRICS,
        validator=lambda vals: vals is not None and len(vals) > 0
        and all(v in _ALL_METRICS for v in vals))

    def get_k(self) -> int:
        return self.get(RankingEvaluator.K)

    def set_k(self, value: int):
        return self.set(RankingEvaluator.K, value)

    def get_metrics(self):
        return self.get(RankingEvaluator.METRICS)

    def set_metrics(self, *names: str):
        return self.set(RankingEvaluator.METRICS, names)

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        preds = table[self.get_prediction_col()]
        labels = table[self.get_label_col()]
        k = self.get_k()
        # row-invariant discount machinery, hoisted out of the row loop
        discounts = 1.0 / np.log2(np.arange(2, k + 2))
        idcg_cum = np.cumsum(discounts)

        per_row = {m: [] for m in _ALL_METRICS}
        for pred, rel in zip(preds, labels):
            relevant = set(_item_list(rel))
            if not relevant:
                continue   # undefined: no relevant items for this row
            # dedupe, keeping rank order: a repeated item must not count
            # as several hits (it would push recall/MAP/NDCG past 1.0)
            ranked = list(dict.fromkeys(_item_list(pred)))[:k]
            hits = np.asarray([item in relevant for item in ranked], bool)
            n_hits = int(hits.sum())

            per_row["precisionAtK"].append(n_hits / k)
            per_row["recallAtK"].append(n_hits / len(relevant))
            per_row["hitRateAtK"].append(1.0 if n_hits else 0.0)

            # NDCG@k: binary gains, log2(position + 1) discount, ideal =
            # all relevant items packed at the top
            dcg = float((hits * discounts[: len(ranked)]).sum())
            idcg = float(idcg_cum[min(len(relevant), k) - 1])
            per_row["ndcgAtK"].append(dcg / idcg if idcg > 0 else 0.0)

            # MAP@k: mean over min(|relevant|, k) of precision at each hit
            if n_hits:
                ranks = np.flatnonzero(hits) + 1
                prec_at_hits = np.arange(1, n_hits + 1) / ranks
                per_row["mapAtK"].append(
                    float(prec_at_hits.sum()) / min(len(relevant), k))
            else:
                per_row["mapAtK"].append(0.0)

        if not per_row["precisionAtK"]:
            raise ValueError(
                "RankingEvaluator got no rows with relevant items")
        return [Table({m: np.asarray([float(np.mean(per_row[m]))])
                       for m in self.get_metrics()})]
