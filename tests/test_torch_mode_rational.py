"""The rational mode of the PyTorch port (MINRES + the AAA rational
preconditioner, float64) against the JAX package on the f = 0, g = 1 circle,
with the reference's setup state and Lanczos start vectors carried across."""

import pytest
import torch

from test_torch_immersed_laplace import solve_pair

torch.set_num_threads(1)

# TestRationalFlat.GOLDEN, tests/test_baseline_tables.py:51
GOLDEN = {4: 32, 5: 38, 6: 44}


@pytest.mark.parametrize("ref", sorted(GOLDEN))
def test_rational_matches_reference(ref):
    ij, it, rel_diff = solve_pair("rational", ref)
    assert bool(ij.converged) and it.converged
    assert abs(it.iterations - int(ij.iterations)) <= 1
    assert abs(it.iterations - GOLDEN[ref]) <= 2
    assert rel_diff <= 1e-6
