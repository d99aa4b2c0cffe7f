"""Guarded mixed-precision iterative-refinement loop.

Counterpart of ``fictitious_domain_al_preconditioners_tpu.utils.refine``
(``refine.py:46-134``): correction solves in the working precision on the
device, the true float64 residual on the host (:mod:`..ops.host_ref`),
iterated to the reference's absolute tolerances.

The guard keeps a diverged correction (nan, or a gross overshoot) from
poisoning the float64 iterate.  It is deliberately not monotone: near the
float32 conditioning limit the first correction of a cycle can overshoot and
grow the true residual (the reference measured 2.31x on one problem and
7.64x in float32 on the CPU on another), so a step is accepted if it
improves, or if it is finite and bounded (at most ``growth_cap`` times the
current and the initial residual).  At most ``max_no_improve`` consecutive
non-improving steps are taken, the best iterate seen is tracked, and the
loop always returns that best iterate.
"""

from __future__ import annotations

import numpy as np

__all__ = ["guarded_refinement", "CORRECTION_MAX_OUTER"]

# Upper bound on the outer Krylov steps of one correction solve.  A stalled
# float32 solve (tolerance below its noise floor) would otherwise grind the
# configured max_steps; capping each solve and letting guarded_refinement
# restart from the host is restarted FGMRES with a float64 residual
# recomputation.  Converged corrections take far fewer steps.
CORRECTION_MAX_OUTER = 64


def guarded_refinement(residual, correct, sizes, tol_abs: float,
                       max_refine: int, growth_cap: float = 64.0,
                       max_no_improve: int = 2):
    """Run the refinement loop.

    ``residual(*xs) -> tuple[np.ndarray]``: float64 block residuals b - A·x.
    ``correct(rs) -> (parts, iterations)``: solve A·dx = r for the
    (residual-normalized) block right-hand side ``rs``; returns float64
    block corrections.  ``sizes``: block sizes of the iterate.

    A full step is taken if it improves the true residual or stays finite
    and within ``growth_cap`` of both the current and the initial residual;
    an out-of-bounds full step retries once at half length (improvement
    required).  At most ``max_no_improve`` consecutive non-improving steps
    are allowed; the best iterate seen is what is returned.

    Returns ``(xs, history, total_iterations, converged)``: ``history`` holds
    the accepted true residual norms (``len(history) - 1`` accepted steps);
    ``xs`` and ``converged`` describe the best iterate, which may precede
    ``history[-1]``.
    """
    xs = [np.zeros(n) for n in sizes]
    rs = residual(*xs)
    res = float(np.sqrt(sum(float(r @ r) for r in rs)))
    res0 = res
    history = [res]
    best = (res, xs)
    total_iters = 0
    steps = 0
    no_improve = 0
    while steps < max_refine and np.isfinite(res) and best[0] > tol_abs:
        s = res  # normalize so float32 corrections stay well-scaled
        parts, iters = correct([r / s for r in rs])
        total_iters += int(iters)
        steps += 1

        def _trial(damp):
            t = [x + damp * s * p for x, p in zip(xs, parts)]
            t_rs = residual(*t)
            return (float(np.sqrt(sum(float(r @ r) for r in t_rs))), t, t_rs)

        def _bounded(t):
            return (np.isfinite(t[0]) and t[0] <= growth_cap * res
                    and t[0] <= growth_cap * res0)

        # prefer an improving step (full, then halved); else take a bounded
        # finite one (the measured overshoot transient); else stop
        full = _trial(1.0)
        if np.isfinite(full[0]) and full[0] < res:
            accepted = full
        else:
            half = _trial(0.5)
            if np.isfinite(half[0]) and half[0] < res:
                accepted = half
            elif _bounded(full):
                accepted = full
            elif _bounded(half):
                accepted = half
            else:
                break  # diverged correction: return the best iterate so far
        res, xs, rs = accepted
        history.append(res)
        if res < best[0]:
            best = (res, xs)
            no_improve = 0
        else:
            no_improve += 1
            if no_improve >= max_no_improve:
                break
    res, xs = best
    return xs, history, total_iters, bool(res <= tol_abs)
