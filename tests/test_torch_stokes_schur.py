"""The Stokes problem, the step-22 Schur-complement baseline (``Stokes``) at
4:5: the port on the JAX package's carried setup state with its Lanczos
vectors.  The JAX solve takes 30-45 s on one core, so the port is held to
the count one run of it printed on the CPU (6), from

    PYTHONPATH=. python -c "import jax; jax.config.update('jax_platforms',
      'cpu'); jax.config.update('jax_enable_x64', True); from
      fictitious_domain_al_preconditioners_tpu.models import StokesConfig,
      StokesProblem; p = StokesProblem(StokesConfig(solver='Stokes'));
      p.setup(); p.solve(); print(p.results)"

see ``test_torch_stokes.py``."""

from fictitious_domain_al_preconditioners_tpu.models import stokes as jstokes
from test_torch_stokes import make_config, port_problem

SCHUR_COUNT = 6


def schur(mod):
    return make_config(mod, solver="Stokes")


def test_schur_baseline_count_matches_reference():
    jp = jstokes.StokesProblem(schur(jstokes))
    jp.setup()
    tp = port_problem(jp, schur)
    _, _, lam, _ = tp.solve()
    assert tp.results["converged"]
    assert tp.results["outer_iterations"] == SCHUR_COUNT
    # the baseline ignores the immersed body, and its velocity is
    # divergence-free (tests/test_stokes.py::test_plain_stokes_schur)
    assert tp.divergence_residual() < 1e-5
    assert float(lam.abs().max()) == 0.0
    assert tp.results["gmg_routes"] == ["band", "band", "band"]
