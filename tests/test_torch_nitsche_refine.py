"""The nitsche problem's ``solve_refined`` (outer tolerance 1e-5,
``tol_abs=1e-10``, as ``tests/test_nitsche.py``'s ``TestRefinedSolve``) in
both packages on the reference's carried state: the same accepted steps,
outer and inner iteration totals, iterates within 1e-8: see
``test_torch_nitsche.py``."""

import numpy as np
import torch

from fictitious_domain_al_preconditioners_tpu.models import \
    nitsche_bcs as jnit
from test_torch_nitsche import port_problem

torch.set_num_threads(1)


def refined(mod):
    cfg = mod.NitscheConfig(use_manufactured_solution=True)
    cfg.outer.tolerance = 1e-5
    return cfg


def test_refined_matches_reference():
    jp = jnit.NitscheProblem(refined(jnit))
    jp.setup(1)
    uj, lj, hist_j = jp.solve_refined(tol_abs=1e-10)
    tp = port_problem(jp, refined, cycle=1)
    u, lam, hist = tp.solve_refined(tol_abs=1e-10)
    rj, rt = jp.results, tp.results
    assert rt["converged"] and rj["converged"] and hist[-1] <= 1e-10
    assert rt["refine_steps"] == rj["refine_steps"] <= 5
    assert rt["outer_its"] == rj["outer_its"]
    assert rt["inner_cg_total"] == rj["inner_cg_total"]
    # the residual histories agree down to the float64 noise floor
    np.testing.assert_allclose(hist, hist_j, rtol=1e-6, atol=1e-14)
    xj = np.concatenate([uj, lj])
    assert np.abs(np.concatenate([u, lam]) - xj).max() <= 1e-8 * np.abs(
        xj).max()
    assert rt["correction_seconds"] > 0 and rt["host_residual_seconds"] > 0
