"""The Stokes problem, IBStokesAL at 4:5 with the symmetric-gradient
velocity block (no grad-div term in A: the augmented block carries
γ_gd·BᵀMp⁻¹B) and diagonal W, in both packages: see
``test_torch_stokes.py``."""

from test_torch_stokes import check_solve, make_config, reference_solve


def symgrad(mod):
    return make_config(mod, al=dict(grad_div_stabilization=False,
                                    inverse_diag_square=True))


def test_symmetric_gradient_matches_reference():
    check_solve(reference_solve(symgrad), symgrad)
