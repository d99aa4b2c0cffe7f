"""The Stokes problem, IBStokesAL at 4:5 with MinRes and the SPD diagonal
AL preconditioner (outer tolerance 1e-7, as ``tests/test_stokes.py``'s
``test_minres_diag_spd``), in both packages: see ``test_torch_stokes.py``."""

from test_torch_stokes import DIAG_W, check_solve, make_config, \
    reference_solve


def minres_spd(mod):
    return make_config(mod, al=dict(DIAG_W, diagonal_spd_prec=True),
                       outer=dict(tolerance=1e-7))


def test_minres_diagonal_spd_matches_reference():
    check_solve(reference_solve(minres_spd), minres_spd)
