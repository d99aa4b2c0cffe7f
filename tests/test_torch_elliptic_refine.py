"""``solve_refined`` of the elliptic interface problem against the JAX
package, in float64 on the CPU: the explicit AL form with W = diag(M·M) and a
loose outer tolerance (1e-6), refined to a true float64 residual of 1e-12
in the same steps and outer iterations on the reference's carried setup
state (the configuration of tests/test_elliptic_interface.py::
TestRefinedSolve; the default W runs to 1e-10 on the card, chip_smoke.py
phase 7)."""

import numpy as np
import torch

from fictitious_domain_al_preconditioners_tpu.models import (
    EllipticInterfaceConfig as JConfig, EllipticInterfaceProblem as JProblem)
from fictitious_domain_al_preconditioners_torch.models import (
    EllipticInterfaceConfig as TConfig, EllipticInterfaceProblem as TProblem)
from fictitious_domain_al_preconditioners_torch.utils.carry import \
    state_from_jax

from test_torch_elliptic import base_config, carried_arrays

torch.set_num_threads(1)


def test_refined_solve_matches_reference():
    jp = JProblem(base_config(JConfig, use_diagonal_inverse=True))
    jp.cfg.outer.tolerance = 1e-6
    jp.setup(0)
    uj, u2j, lamj, hj = jp.solve_refined(tol_abs=1e-12)
    tp = TProblem(base_config(TConfig, use_diagonal_inverse=True),
                  device="cpu")
    tp.cfg.outer.tolerance = 1e-6
    tp.setup(0).load_state(state_from_jax(carried_arrays(jp), "cpu",
                                          torch.float64))
    ut, u2t, lamt, ht = tp.solve_refined(tol_abs=1e-12)
    res = tp.results
    assert res["converged"] and ht[-1] <= 1e-12
    assert res["refine_steps"] == jp.results["refine_steps"]
    assert res["outer_iterations"] == jp.results["outer_iterations"]
    assert len(ht) == len(hj)
    assert np.allclose(ht, hj, rtol=1e-3, atol=1e-13)
    xj = np.concatenate([np.asarray(x) for x in (uj, u2j, lamj)])
    xt = np.concatenate([ut, u2t, lamt])
    assert np.abs(xt - xj).max() <= 1e-8 * np.abs(xj).max()
    assert res["correction_seconds"] > 0 and res["host_residual_seconds"] > 0
    # a second call reuses the host system and the correction solver
    tp.solve_refined(tol_abs=1e-12)
    assert tp.results["refine_steps"] == res["refine_steps"]
