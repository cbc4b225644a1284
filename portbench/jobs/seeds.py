"""Seeds derived from a run's ``--seed``."""

from __future__ import annotations

import numpy as np

#: the estimators' seeds stay below 2^31 - 1 (numpy's generators take any
#: non-negative int; the fit adds 1 for its init stream)
_SEED_SPAN = 2 ** 31 - 2


def _entropy(seed: int) -> int:
    return int(seed) % (1 << 64)


def data_seed(seed: int) -> int:
    """The seed of the run's inputs (a torch generator's 64-bit seed)."""
    return int(np.random.SeedSequence([_entropy(seed), 0]).generate_state(
        1, np.uint64)[0])


def fit_seed(seed: int, i: int) -> int:
    """The estimator seed of the run's ``i``-th fit of the window (``i =
    -1``: the warm-up)."""
    return int(np.random.SeedSequence(
        [_entropy(seed), 1, i + 1]).generate_state(1, np.uint64)[0]
        % _SEED_SPAN)


def check_seed(seed: int, k: int) -> int:
    """The estimator seed of the check's ``k``-th fit of its own."""
    return int(np.random.SeedSequence(
        [_entropy(seed), 3, k]).generate_state(1, np.uint64)[0]
        % _SEED_SPAN)


def sample(seed: int, n: int, m: int) -> list:
    """``min(n, m)`` distinct fit indices of ``range(n)``, drawn from the
    run's seed."""
    rng = np.random.default_rng(np.random.SeedSequence([_entropy(seed), 2]))
    return sorted(int(x) for x in rng.choice(n, size=min(n, m),
                                             replace=False))
