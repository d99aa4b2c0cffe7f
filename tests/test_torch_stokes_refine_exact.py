"""The Stokes problem's ``solve_refined`` at 4:5 with the exact W⁻¹ in both
packages: see ``test_torch_stokes_refine.py``."""

from test_torch_stokes_refine import check_refined


def test_refined_exact_w_matches_reference():
    check_refined(False)
