"""The Stokes problem, the unpreconditioned nested-Schur ``IBStokes`` at 3:4:
the port on the JAX package's carried setup state with its Lanczos vectors.
The JAX solve takes 50-80 s on one core, so the port is held to the count
one run of it printed on the CPU (166), from

    PYTHONPATH=. python -c "import jax; jax.config.update('jax_platforms',
      'cpu'); jax.config.update('jax_enable_x64', True); from
      fictitious_domain_al_preconditioners_tpu.models import StokesConfig,
      StokesProblem; p = StokesProblem(StokesConfig(solver='IBStokes',
      initial_refinement=3, initial_embedded_refinement=4)); p.setup();
      p.solve(); print(p.results)"

see ``test_torch_stokes.py``."""

from fictitious_domain_al_preconditioners_tpu.models import stokes as jstokes
from test_torch_stokes import make_config, port_problem

IBSTOKES_COUNT = 166


def ibstokes(mod):
    return make_config(mod, solver="IBStokes", initial_refinement=3,
                       initial_embedded_refinement=4)


def test_ibstokes_count_matches_reference():
    jp = jstokes.StokesProblem(ibstokes(jstokes))
    jp.setup()
    tp = port_problem(jp, ibstokes)
    tp.solve()
    assert tp.results["converged"]
    assert tp.results["outer_iterations"] == IBSTOKES_COUNT
    assert tp.constraint_residual() < 1e-6
