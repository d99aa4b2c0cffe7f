"""The CG mode of the PyTorch port (exact Schur complement S = C K⁻¹ Cᵀ by
CG, float64) against the JAX package on the smooth problem of
tests/test_immersed_laplace.py::TestOtherSolvers, with the reference's setup
state and Lanczos start vectors carried across."""

import pytest
import torch

from test_torch_immersed_laplace import solve_pair

torch.set_num_threads(1)


@pytest.mark.parametrize("ref", [4, 5, 6])
def test_schur_cg_matches_reference(ref):
    ij, it, rel_diff = solve_pair("CG", ref)
    assert bool(ij.converged) and it.converged
    assert abs(it.iterations - int(ij.iterations)) <= 1
    assert rel_diff <= 1e-6
