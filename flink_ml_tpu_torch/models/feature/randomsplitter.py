"""RandomSplitter — split one Table into N by weighted random assignment.

Member of the Flink ML 2.x feature surface (``feature/randomsplitter``;
the reference snapshot ships no splitters — SURVEY §2.8).  AlgoOperator
with a multi-table output: each row is routed to output ``k`` with
probability ``weights[k] / sum(weights)``, deterministically under
``seed``.

A copy of the JAX package's ``models/feature/randomsplitter.py``: the same
seeded numpy draw, so the splits equal the JAX package's.  Pure host
work; it breaks a fused chain (``api/chain.py``) and fans the flow out.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...api.stage import AlgoOperator
from ...data.table import Table
from ...params.param import DoubleArrayParam
from ...params.shared import HasSeed

__all__ = ["RandomSplitter"]


def _valid_weights(vals) -> bool:
    """>= 2 strictly positive weights — enforced on the param itself so the
    generic set()/json-restore path validates too, not just set_weights."""
    return vals is not None and len(vals) >= 2 and all(w > 0 for w in vals)


class RandomSplitter(HasSeed, AlgoOperator):
    WEIGHTS = DoubleArrayParam(
        "weights", "Relative split weights (>= 2 values, all > 0).",
        default=(1.0, 1.0), validator=_valid_weights)

    def get_weights(self):
        return self.get(RandomSplitter.WEIGHTS)

    def set_weights(self, *values: float):
        vals = values[0] if len(values) == 1 and not np.isscalar(values[0]) \
            else values
        return self.set(RandomSplitter.WEIGHTS,
                        tuple(float(v) for v in vals))

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        weights = np.asarray(self.get_weights(), np.float64)
        probs = weights / weights.sum()
        rng = np.random.default_rng(self.get_seed())
        assign = rng.choice(len(probs), size=table.num_rows, p=probs)
        return [table.select_rows(np.flatnonzero(assign == k))
                for k in range(len(probs))]
