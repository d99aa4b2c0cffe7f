"""The bookkeeping of a family's solve, written once for the five families.

A problem (``ImmersedLaplaceProblem``, ``StokesProblem``,
``EllipticInterfaceProblem``, ``NitscheProblem``,
``ElasticityInterfaceProblem``) holds one :class:`SolveSession`, which
owns what a setup builds for its solves: the solvers, by key, and the
refinement cache (the host float64 system and the correction solver).
:meth:`SolveSession.solve` is the span, the build, the counters and the
timing around one solve; :meth:`SolveSession.refine` the guarded
mixed-precision refinement loop (:func:`..utils.refine.guarded_refinement`)
around the family's host system and correction solver.  The family keeps
what differs: its builders and keys, how it splits an answer, and its own
``results`` keys.

The counters of one solve (:data:`SOLVE_COUNTERS`) live in the problem's
``stats``: the Krylov solvers (``ops.krylov``) and the V-cycle graphs
(``precond.gmg``) increment them, the session resets them at the start of
each solve and reports them in ``results``.
"""

from __future__ import annotations

import time

import torch

from ..tracer import span
from ..utils.refine import guarded_refinement

__all__ = ["SOLVE_COUNTERS", "reset_solve_stats", "solve_stats",
           "split_correction", "SolveSession"]

#: the counters of one solve in a family's ``stats``, reset at its start and
#: reported in its ``results``: the Krylov solvers' host reads and inner
#: iterations, and the V-cycle graphs' replays, captures, failed captures
#: and the device bytes their captures reserved
SOLVE_COUNTERS = ("host_syncs", "inner_iterations", "vcycle_graph_replays",
                  "vcycle_graph_captures", "vcycle_graph_failures",
                  "vcycle_graph_pool_bytes")


def reset_solve_stats(stats: dict):
    """Set every :data:`SOLVE_COUNTERS` of ``stats`` to 0."""
    stats.update(dict.fromkeys(SOLVE_COUNTERS, 0))


def solve_stats(stats: dict) -> dict:
    """The :data:`SOLVE_COUNTERS` of ``stats``."""
    return {k: stats[k] for k in SOLVE_COUNTERS}


def split_correction(layout, corr):
    """The correction solver ``corr(*rs) -> (x, info, …)`` of a block
    vector ``x`` of ``layout`` as :meth:`SolveSession.refine` takes it:
    ``(layout.split(x), info)``."""
    def run(*rs):
        x, info = corr(*rs)[:2]
        return layout.split(x), info

    return run


class SolveSession:
    """The solvers and the refinement cache of one setup of ``prob``, whose
    ``timer``, ``results``, ``stats`` and ``device`` it uses; ``family``
    names the problem in the ``solve`` span.  The problem calls
    :meth:`reset` wherever it replaces its arrays (``setup``,
    ``load_state``)."""

    def __init__(self, prob, family: str):
        self.prob = prob
        self.family = family
        self.reset()

    def reset(self):
        """Forget the built solvers and the refinement cache: they are
        built again at the next solve."""
        self.solvers = {}
        self.refine_cache = None

    def solve(self, solver: str, key, build, *rhs):
        """One solve in a ``solve`` span (``family``, ``solver``): the
        solver of ``key``, ``build()`` once per setup under the timer's
        "Build solver" (``results["build_seconds"]``), called on ``rhs``
        under "Solve system" with the counters reset, the device
        synchronised before the clock stops.  Records ``solve_seconds`` and
        the counters; returns what the solver returns."""
        p = self.prob
        with span("solve", family=self.family, solver=solver):
            if key not in self.solvers:
                t0 = time.perf_counter()
                with p.timer.scope("Build solver"):
                    self.solvers[key] = build()
                p.results["build_seconds"] = time.perf_counter() - t0
            reset_solve_stats(p.stats)
            t0 = time.perf_counter()
            with p.timer.scope("Solve system"):
                out = self.solvers[key](*rhs)
                if p.device.type == "cuda":
                    torch.cuda.synchronize(p.device)
            p.results.update(solve_seconds=time.perf_counter() - t0,
                             **solve_stats(p.stats))
            return out

    def refine(self, host_system, correction, sizes, dtype, names,
               tol_abs: float, max_refine: int):
        """Mixed-precision iterative refinement.  Once per setup
        (``results["refine_build_seconds"]``) it builds the host float64
        system, ``host_system(prob)`` (``residual(*xs)``, the true block
        residuals, :mod:`..ops.host_ref`), and the correction solver,
        ``correction()`` (``(*rs) -> (parts, info)``, the block corrections
        of a right-hand side in ``dtype`` on the device).  The loop runs
        until the true residual reaches ``tol_abs`` under
        :func:`..utils.refine.guarded_refinement`; ``sizes`` are the block
        sizes, ``names`` the problem's attributes that take the blocks of
        the iterate (tensors in ``dtype``).

        Records the total outer iterations (``outer_iterations``), the final
        residual, the accepted steps, convergence, the seconds of the loop
        (``refined_seconds``), of the device corrections and of the host
        residuals, and the counters, one host sync for each correction's
        copy back among them.  Returns ``(xs, history)``: the float64 NumPy
        blocks of the iterate and the accepted true residual norms."""
        p = self.prob
        if self.refine_cache is None:
            t0 = time.perf_counter()
            self.refine_cache = (host_system(p), correction())
            p.results["refine_build_seconds"] = time.perf_counter() - t0
        host, corr = self.refine_cache
        seconds = {"host": 0.0, "device": 0.0}

        def residual(*xs):
            t0 = time.perf_counter()
            rs = host.residual(*xs)
            seconds["host"] += time.perf_counter() - t0
            return rs

        def correct(rs):
            t0 = time.perf_counter()
            parts, info = corr(*(torch.as_tensor(r, dtype=dtype,
                                                 device=p.device)
                                 for r in rs))
            parts = [q.double().cpu().numpy() for q in parts]
            p.stats["host_syncs"] += 1      # the correction's copy back
            seconds["device"] += time.perf_counter() - t0
            return parts, int(info.iterations)

        reset_solve_stats(p.stats)
        t0 = time.perf_counter()
        xs, history, total_iters, converged = guarded_refinement(
            residual, correct, sizes, tol_abs, max_refine)
        elapsed = time.perf_counter() - t0
        for name, x in zip(names, xs):
            setattr(p, name, torch.as_tensor(x, dtype=dtype, device=p.device))
        p.results.update(
            outer_iterations=total_iters, refined_residual=history[-1],
            refine_steps=len(history) - 1, converged=converged,
            refined_seconds=elapsed, correction_seconds=seconds["device"],
            host_residual_seconds=seconds["host"], **solve_stats(p.stats))
        return xs, history
