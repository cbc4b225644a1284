"""What every fit job shares: the inputs from the traffic's generator,
the host table the estimator takes, the warm-up fit and the check over
the job's comparison units."""

from __future__ import annotations

import importlib


class FitJob:
    """A kind of whole-``fit()`` work; a subclass gives ``fit(table,
    seed, max_iter=None) -> (output, info)`` and ``units(columns, kept,
    seed)`` (:class:`.unit.Unit`s over the window's outputs)."""

    def __init__(self, config: dict, traffic: dict, device):
        self.config = config
        self.traffic = traffic
        self.device = device

    def make_inputs(self, seed: int) -> dict:
        gen = importlib.import_module(
            f"portbench.gen.{self.traffic['generator']}")
        return gen.make(self.config, self.traffic["data"], seed, self.device)

    @staticmethod
    def table(columns: dict):
        from flink_ml_tpu_torch.data.table import Table

        return Table(columns)

    def warm_up(self, columns: dict, table, seed: int) -> None:
        """One short fit at the cell's shapes."""
        self.fit(table, seed, max_iter=int(self.traffic["warmup_max_iter"]))

    def check(self, columns: dict, kept: list, seed: int) -> list:
        """``[(name, value, limit)]`` over the units, by the traffic's
        ``limits``."""
        checks = []
        for unit in self.units(columns, kept, seed):
            checks += unit.compare(self.traffic["limits"])
        return checks
