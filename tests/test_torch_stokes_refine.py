"""The Stokes problem's ``solve_refined`` at 4:5 with diagonal W (outer
tolerance 1e-5, ``tol_abs=1e-10``, as ``tests/test_stokes.py``'s
``TestRefinedSolve``) in both packages: the same accepted steps and total
outer iterations, iterates within 1e-8: see ``test_torch_stokes.py``."""

import numpy as np

from fictitious_domain_al_preconditioners_tpu.models import stokes as jstokes
from test_torch_stokes import make_config, port_problem


def refined(diag_w):
    def cfg_kw(mod):
        return make_config(mod, al=dict(grad_div_stabilization=True,
                                        inverse_diag_square=diag_w),
                           outer=dict(tolerance=1e-5))

    return cfg_kw


def check_refined(diag_w):
    cfg_kw = refined(diag_w)
    jp = jstokes.StokesProblem(cfg_kw(jstokes))
    jp.setup()
    xj = np.concatenate(jp.solve_refined(tol_abs=1e-10)[:3])
    tp = port_problem(jp, cfg_kw)
    u, p, lam, hist = tp.solve_refined(tol_abs=1e-10)
    rj, rt = jp.results, tp.results
    assert rt["converged"] and rj["converged"] and hist[-1] <= 1e-10
    assert rt["refine_steps"] == rj["refine_steps"]
    assert rt["outer_iterations"] == rj["outer_iterations"]
    xt = np.concatenate([u, p, lam])
    assert np.abs(xt - xj).max() <= 1e-8 * np.abs(xj).max()
    assert rt["correction_seconds"] > 0 and rt["host_residual_seconds"] > 0


def test_refined_diag_w_matches_reference():
    check_refined(True)
