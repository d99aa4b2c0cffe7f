"""The data draw and the window's arithmetic."""

import math

import numpy as np
import pytest

from fdal_bench.traffic import Requests, sample_indices
from fdal_bench.window import Run

TRAFFIC = {"pool": 16, "modes": [{}, {}, {}]}


def test_same_seed_same_data_and_unit_weights():
    big = 2 ** 31 + 12345
    a, b = Requests(TRAFFIC, big), Requests(TRAFFIC, big)
    wa = [a.weights(i) for i in range(50)]
    assert all(np.array_equal(x, b.weights(i)) for i, x in enumerate(wa))
    assert all(abs(np.linalg.norm(w) - 1.0) < 1e-12 for w in wa)
    assert not np.array_equal(wa[0], wa[1])
    # drawn in any order, a request's weights are the same
    c = Requests(TRAFFIC, big)
    assert np.array_equal(c.weights(7), wa[7])


def test_every_seed_sends_the_same_pool_in_another_order():
    a, b = Requests(TRAFFIC, 2 ** 31 + 1), Requests(TRAFFIC, 7)
    pa = sorted(tuple(a.weights(i)) for i in range(32))
    pb = sorted(tuple(b.weights(i)) for i in range(32))
    assert pa == pb                                  # two whole passes each
    assert len(set(pa)) == 16
    assert [tuple(a.weights(i)) for i in range(16)] != \
        [tuple(b.weights(i)) for i in range(16)]


def test_a_pool_of_one_sends_the_same_data_to_every_request():
    r = Requests(dict(TRAFFIC, pool=1), 5)
    assert all(np.array_equal(r.weights(0), r.weights(i)) for i in range(9))


def test_sample_indices_seeded_and_within_horizon():
    s = sample_indices(2 ** 33, 10, 100, 4)
    assert s == sample_indices(2 ** 33, 10, 100, 4) and len(set(s)) == 4
    assert all(10 <= i < 100 for i in s)
    assert sample_indices(3, 1, 3, 4) == [1, 2]


def _run(times, ok=None, window=None):
    ok = ok or [True] * len(times)
    reqs = [dict(seconds=t, ok=o, outer_iterations=4, host_syncs=27)
            for t, o in zip(times, ok)]
    return Run(window_s=window or sum(times), requests=reqs)


def test_solve_s_is_window_over_converged_solves():
    run = _run([0.1] * 9 + [0.2], ok=[True] * 8 + [False, True], window=1.25)
    assert run.attempted == 10 and run.failed == 1
    assert run.solve_s() == pytest.approx(1.25 / 9)
    assert _run([0.1], ok=[False]).solve_s() is None


def test_p95_over_every_solve():
    times = list(np.linspace(0.1, 0.3, 200))
    run = _run(times)
    assert run.solve_p95_s() == times[math.ceil(0.95 * 200) - 1]
    # a failed solve counts as the slowest
    slow = _run(times, ok=[True] * 199 + [False])
    assert slow.solve_p95_s() == times[189]
    # fewer than ten beyond the 95th percentile: no tail
    assert _run(times[:199]).solve_p95_s() is None


def test_means():
    assert _run([0.1, 0.1]).mean("host_syncs") == 27
    assert _run([0.1]).mean("missing") is None
