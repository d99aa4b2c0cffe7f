"""The Stokes problem, IBStokesAL at 5:6 with the grad-div block and diagonal
W (golden 32, ``tests/test_stokes.py``'s ``test_iteration_flatness``): the
port on the JAX package's carried setup state with its Lanczos vectors.
The JAX solve itself takes over 40 s on one core, so the port is held to the
golden count, not run against it: see ``test_torch_stokes.py``."""

from fictitious_domain_al_preconditioners_tpu.models import stokes as jstokes
from test_torch_stokes import DIAG_W, GOLDEN, make_config, port_problem


def fine(mod):
    return make_config(mod, al=DIAG_W, initial_refinement=5,
                       initial_embedded_refinement=6)


def test_fine_count_matches_golden():
    jp = jstokes.StokesProblem(fine(jstokes))
    jp.setup()
    tp = port_problem(jp, fine)
    tp.solve()
    assert tp.results["converged"]
    assert tp.results["outer_iterations"] == GOLDEN["fine"]
    assert tp.results["dofs_background"] == 2 * 65 ** 2 + 33 ** 2
    assert tp.constraint_residual() < 1e-6
