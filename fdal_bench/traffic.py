"""The one generator of request data: a traffic file lists smooth modes
(load expressions of f on Ω and g on Γ, in the parameter files' syntax)
and how a request weighs them.  The weights of a request are one of a pool
of ``pool`` unit vectors, drawn once from :data:`POOL_SEED`: every seed
sends the same pool, each pass through it in another order drawn from the
seed, so that the work a run does (the solves' iteration counts depend on
the data) is the same for every seed."""

from __future__ import annotations

import numpy as np

#: the seed of every traffic's pool of weight vectors
POOL_SEED = 0


class Requests:
    """Mode weights of request 0, 1, 2, … for one seed: each a unit vector
    (a direction drawn uniformly), so that every request keeps the scale of
    the file's own data, which is one of the modes."""

    def __init__(self, traffic: dict, seed: int):
        n_modes = len(traffic["modes"])
        pool_rng = np.random.default_rng(POOL_SEED)
        pool = pool_rng.standard_normal((traffic["pool"], n_modes))
        self.pool = pool / np.linalg.norm(pool, axis=1, keepdims=True)
        self._rng = np.random.default_rng(seed)
        self._order = []

    def weights(self, i: int) -> np.ndarray:
        while len(self._order) <= i:
            self._order.extend(self._rng.permutation(len(self.pool)))
        return self.pool[self._order[i]]


def sample_indices(seed: int, first: int, horizon: int, count: int) -> list:
    """The requests whose answers a run checks: ``count`` of requests
    ``first`` … ``horizon - 1``, drawn from the seed apart from the data's
    own draws (``first`` keeps their copies out of a traced run's traced
    solves)."""
    rng = np.random.default_rng([seed, 1])
    span = horizon - first
    return sorted(first + int(i)
                  for i in rng.choice(span, size=min(count, span),
                                      replace=False))
