"""The solve session of the five families (``models/session.py``) on a stub
problem, without a family's set-up: the solver built once per key, the
counters reset at each solve and reported with the build and solve
seconds, the ``solve`` span, and the refinement loop: its cache built once
per setup and cleared by a reset, one host sync for each correction, its
iterate and its ``results``."""

import types

import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_torch import tracer
from fictitious_domain_al_preconditioners_torch.models.session import (
    SOLVE_COUNTERS, SolveSession, split_correction)
from fictitious_domain_al_preconditioners_torch.ops.blocks import BlockLayout
from fictitious_domain_al_preconditioners_torch.utils.timer import TimerOutput

#: the stub's block system: a small SPD matrix on blocks of these sizes
SIZES = (5, 3)


def stub():
    """A problem as the session sees one: ``timer``, ``results``, ``stats``
    (with stale counts) and ``device``, and its session."""
    prob = types.SimpleNamespace(
        timer=TimerOutput(), results={}, device=torch.device("cpu"),
        stats=dict.fromkeys(SOLVE_COUNTERS, 7))
    prob.session = SolveSession(prob, "stub")
    return prob


class Counting:
    """``build()`` a solver that counts its calls in the problem's
    ``stats`` (``syncs`` host syncs a call) and returns its arguments."""

    def __init__(self, prob, syncs=3):
        self.prob, self.syncs, self.built = prob, syncs, 0

    def __call__(self):
        self.built += 1

        def run(*rhs):
            self.prob.stats["host_syncs"] += self.syncs
            self.prob.stats["inner_iterations"] += 1
            return rhs

        return run


def test_the_solver_is_built_once_a_key():
    prob = stub()
    builds = {key: Counting(prob) for key in ("a", "b")}
    for key in ("a", "a", "b", "a", "b"):
        assert prob.session.solve("s", key, builds[key], 1, 2) == (1, 2)
    assert [b.built for b in builds.values()] == [1, 1]
    assert prob.timer.calls["Build solver"] == 2
    assert prob.timer.calls["Solve system"] == 5
    prob.session.reset()
    prob.session.solve("s", "a", builds["a"])
    assert builds["a"].built == 2


@pytest.mark.parametrize("solves", [1, 3])
def test_counters_are_reset_at_each_solve_and_recorded(solves):
    prob = stub()
    build = Counting(prob, syncs=4)
    for _ in range(solves):
        prob.session.solve("s", "k", build)
    res = prob.results
    assert {k: res[k] for k in SOLVE_COUNTERS} == dict(
        dict.fromkeys(SOLVE_COUNTERS, 0), host_syncs=4, inner_iterations=1)
    assert res["build_seconds"] > 0 and res["solve_seconds"] > 0


def test_the_solve_span_names_the_family_and_solver():
    prob = stub()
    tracer.enable()
    try:
        prob.session.solve("dlm", "k", Counting(prob))
    finally:
        spans = tracer.disable()
    root = spans[0]
    assert root.name == "solve" and root.parent < 0
    assert root.attrs == dict(family="stub", solver="dlm")
    assert {spans[s.parent].name for s in spans[1:]} == {"solve"}
    assert [s.name for s in spans[1:]] == ["Build solver", "Solve system"]


class Refinable:
    """The stub's refinement: a float64 SPD block system ``A x = b`` on the
    host, and a correction solver in ``dtype`` that solves it exactly in
    that precision (one iteration a call).  Counts what it builds and the
    corrections."""

    def __init__(self, dtype=torch.float32):
        rng = np.random.default_rng(0)
        n = sum(SIZES)
        q = rng.standard_normal((n, n))
        self.A = q @ q.T + n * np.eye(n)
        self.b = rng.standard_normal(n)
        self.layout = BlockLayout(SIZES)
        self.dtype = dtype
        self.hosts = self.corrections = self.calls = 0

    def host_system(self, prob):
        self.hosts += 1
        split = np.cumsum(SIZES)[:-1]
        outer = self

        class Host:
            def residual(self, *xs):
                return tuple(np.split(outer.b - outer.A @ np.concatenate(xs),
                                      split))

        return Host()

    def correction(self):
        self.corrections += 1
        A = torch.as_tensor(self.A, dtype=self.dtype)

        def corr(*rs):
            self.calls += 1
            x = torch.linalg.solve(A, torch.cat(rs))
            return x, types.SimpleNamespace(iterations=1), "extra"

        return split_correction(self.layout, corr)

    def refine(self, prob, tol_abs=1e-12):
        return prob.session.refine(self.host_system, self.correction, SIZES,
                                   self.dtype, ("u", "lam"), tol_abs, 8)


def test_refinement_cache_built_once_a_setup_and_cleared_by_reset():
    prob, sys = stub(), Refinable()
    sys.refine(prob)
    sys.refine(prob)
    assert (sys.hosts, sys.corrections) == (1, 1)
    assert "refine_build_seconds" in prob.results
    prob.session.reset()
    sys.refine(prob)
    assert (sys.hosts, sys.corrections) == (2, 2)


def test_a_correction_counts_one_host_sync():
    prob, sys = stub(), Refinable()
    (u, lam), history = sys.refine(prob)
    res = prob.results
    assert sys.calls >= 2 and res["refine_steps"] == len(history) - 1
    assert res["host_syncs"] == sys.calls
    assert res["outer_iterations"] == sys.calls
    assert {k: res[k] for k in SOLVE_COUNTERS if k != "host_syncs"} == \
        dict.fromkeys(set(SOLVE_COUNTERS) - {"host_syncs"}, 0)


def test_refinement_reaches_the_tolerance_and_sets_the_iterate():
    prob, sys = stub(), Refinable()
    (u, lam), history = sys.refine(prob)
    res = prob.results
    x = np.linalg.solve(sys.A, sys.b)
    assert u.dtype == np.float64 and u.shape == (SIZES[0],)
    assert np.abs(np.concatenate((u, lam)) - x).max() <= 1e-12
    assert res["converged"] and res["refined_residual"] == history[-1]
    assert history[-1] <= 1e-12 < history[0]
    assert prob.u.dtype == torch.float32 and prob.lam.shape == (SIZES[1],)
    assert torch.equal(prob.lam, torch.as_tensor(lam, dtype=torch.float32))
    assert res["correction_seconds"] + res["host_residual_seconds"] \
        <= res["refined_seconds"]
    assert "solve_seconds" not in res
