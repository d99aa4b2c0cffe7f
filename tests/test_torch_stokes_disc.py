"""The Stokes problem, IBStokesAL at 4:5 with the Q2-P1disc pair (golden 37,
``tests/test_stokes.py``), in both packages: see ``test_torch_stokes.py``."""

from test_torch_stokes import DIAG_W, GOLDEN, check_solve, make_config, \
    reference_solve


def disc_pressure(mod):
    return make_config(mod, al=DIAG_W, use_disc_pressure=True)


def test_disc_pressure_matches_reference():
    check_solve(reference_solve(disc_pressure), disc_pressure,
                GOLDEN["disc_pressure"])
