"""One output of the timed path held against the plain reference."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Unit:
    """``out``: what the program produced; ``reference(**variant)``: the
    plain reference's result for the same inputs and seed (a variant
    computes it in another precision or with a planted fault);
    ``as_output(ref)``: a reference result in the shape of ``out``;
    ``numbers(out, ref)``: every number the comparison can read; ``prefix``
    names the unit in the check's names and the traffic's ``limits``."""

    prefix: str
    out: Any
    reference: Callable[..., Any]
    as_output: Callable[[Any], Any]
    numbers: Callable[[Any, Any], dict]

    def compare(self, limits: dict) -> list:
        """``[(name, value, limit)]`` for every limit of this unit."""
        nums = self.numbers(self.out, self.reference())
        kind = self.prefix.split("@")[0]
        return [(f"{self.prefix}.{name}", float(nums[name]), float(limit))
                for key, limit in limits.items()
                for k, name in [key.split(".", 1)] if k == kind]
