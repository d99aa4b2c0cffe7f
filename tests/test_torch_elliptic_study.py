"""The manufactured convergence study of the elliptic interface problem
(the radial solution of arXiv 2211.03443 on the immersed unit ball, an
off-lattice immersed mesh: element-form A2 and M, dense A22 inverse) at
cycle 0 against the JAX package (cycle 1 in a file of its own: one JAX
compile a file), and the √2 rule and the γ study of the port."""

import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models import (
    EllipticInterfaceConfig as JConfig, EllipticInterfaceProblem as JProblem)
from fictitious_domain_al_preconditioners_torch.models import (
    EllipticInterfaceConfig as TConfig, EllipticInterfaceProblem as TProblem)

from test_torch_elliptic import base_config, inject_lanczos

torch.set_num_threads(1)

# TestConvergenceStudy.test_l2_convergence, tests/test_elliptic_interface.py
GOLDEN_STUDY = (18, 22, 23)
STUDY = dict(do_convergence_study=True, initial_background_refinement=3,
             initial_immersed_refinement=2, n_refinement_cycles=3)


def study_pair(cycle):
    """One cycle of the convergence study in both packages, the port on its
    own setup with the reference's Lanczos vectors: ``(jax_problem,
    port_problem)`` after ``solve()``."""
    jp = JProblem(base_config(JConfig, **STUDY))
    jp.setup(cycle)
    jp.solve()
    tp = inject_lanczos(TProblem(base_config(TConfig, **STUDY),
                                 device="cpu"))
    tp.setup(cycle).solve()
    return jp, tp


def check_study_cycle(cycle):
    jp, tp = study_pair(cycle)
    ij, it = jp.results["outer_iterations"], tp.results["outer_iterations"]
    assert abs(ij - GOLDEN_STUDY[cycle]) <= 2
    assert it == ij and tp.results["converged"]
    assert tp.fg_gridspace is None and jp.fg_gridspace is None
    (l2j, h1j), (l2t, h1t) = jp.errors(), tp.errors()
    # the errors of two solutions that agree to the solver's tolerance
    assert l2t == pytest.approx(l2j, rel=1e-6)
    assert h1t == pytest.approx(h1j, rel=1e-6)
    return jp, tp


@pytest.mark.parametrize("cycle", [0])
def test_convergence_study_cycle_matches_reference(cycle):
    check_study_cycle(cycle)


def test_sqrt2_rule():
    """tests/test_elliptic_interface.py::TestModifiedAL.test_sqrt2_rule on
    the port: γ divided by √2 after each cycle, every cycle converged."""
    prob = TProblem(base_config(
        TConfig, use_sqrt_2_rule=True, n_refinement_cycles=2,
        initial_background_refinement=3, initial_immersed_refinement=1),
        device="cpu")
    table = prob.run()
    assert prob.gamma_bg == pytest.approx(10.0 / 2.0 ** (2 / 2))
    assert [row["gamma"] for row in table.rows] == pytest.approx(
        [10.0, 10.0 / np.sqrt(2.0)])
    assert all(row["constraint_residual"] < 1e-7 for row in table.rows)


def test_parameter_study():
    """tests/test_elliptic_interface.py::TestModifiedAL
    .test_parameter_study on the port: one solve per γ of the sweep, the
    best one kept."""
    prob = TProblem(base_config(
        TConfig, do_parameter_study=True, start_gamma=0.5, end_gamma=10.0,
        n_steps_gamma=3, initial_background_refinement=3,
        initial_immersed_refinement=1), device="cpu")
    best, iters = prob.parameter_study()
    assert len(iters) == 3 and all(i > 0 for i in iters)
    assert best in np.linspace(0.5, 10.0, 3)
    assert prob.gamma_bg == prob.gamma_imm == best
