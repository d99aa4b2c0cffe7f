"""The Stokes problem, IBStokesAL at 4:5 with the grad-div block and the
exact W⁻¹ = (M_Γ⁻¹)², in both packages: see ``test_torch_stokes.py``."""

from test_torch_stokes import check_solve, make_config, reference_solve


def exact_w(mod):
    return make_config(mod, al=dict(grad_div_stabilization=True,
                                    inverse_diag_square=False))


def test_exact_w_matches_reference():
    check_solve(reference_solve(exact_w), exact_w)
