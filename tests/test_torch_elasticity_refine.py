"""The elasticity interface problem's ``solve_refined`` (background
refinement 2, immersed 1, outer tolerance 1e-5, ``tol_abs=1e-10``, as
``tests/test_elasticity.py``'s ``TestRefinedSolve``) with both W in both
packages on the reference's carried state: the same accepted steps, the
total outer iterations within 2 (the inner CGs stop at an absolute 1e-2,
where a rounding-level difference can move a stop: 62 against 60 with the
exact W, equal with the diagonal one), the iterates within 1e-6 of their
max (two
iterates of a true residual of 1e-10 differ by the system's conditioning
times it; they differed by 1.5e-7): see ``test_torch_elasticity.py``."""

import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models import elasticity as jel
from test_torch_elasticity import port_problem, small

torch.set_num_threads(1)


@pytest.mark.parametrize("diag_w", [True, False])
def test_refined_matches_reference(diag_w):
    def cfg_kw(mod):
        cfg = small(mod, use_diagonal_inverse=diag_w)
        cfg.outer.tolerance = 1e-5
        return cfg

    jp = jel.ElasticityInterfaceProblem(cfg_kw(jel))
    jp.setup()
    xj = np.concatenate(jp.solve_refined(tol_abs=1e-10)[:3])
    tp = port_problem(jp, cfg_kw)
    u, u2, lam, hist = tp.solve_refined(tol_abs=1e-10)
    rj, rt = jp.results, tp.results
    assert rt["converged"] and rj["converged"] and hist[-1] <= 1e-10
    assert rt["refine_steps"] == rj["refine_steps"] <= 5
    assert abs(rt["outer_iterations"] - rj["outer_iterations"]) <= 2
    xt = np.concatenate([u, u2, lam])
    assert np.abs(xt - xj).max() <= 1e-6 * np.abs(xj).max()
    assert rt["correction_seconds"] > 0 and rt["host_residual_seconds"] > 0
