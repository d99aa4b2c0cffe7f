"""The ELMAN_triang mode of the PyTorch port (BFBt block-triangular
preconditioner, right GMRES, float64) against the JAX package on the f = 0,
g = 1 circle, with the reference's setup state and Lanczos start vectors
carried across.  The negative control: its counts grow with refinement."""

import functools

import pytest
import torch

from test_torch_immersed_laplace import solve_pair

torch.set_num_threads(1)

# TestElmanNegativeControl.GOLDEN, tests/test_baseline_tables.py:87
GOLDEN = {4: 7, 5: 10, 6: 13}


@functools.lru_cache(maxsize=None)
def elman(ref):
    return solve_pair("ELMAN_triang", ref)


@pytest.mark.parametrize("ref", sorted(GOLDEN))
def test_elman_matches_reference(ref):
    ij, it, rel_diff = elman(ref)
    assert bool(ij.converged) and it.converged
    assert abs(it.iterations - int(ij.iterations)) <= 1
    assert abs(it.iterations - GOLDEN[ref]) <= 1
    assert rel_diff <= 1e-6


def test_elman_counts_grow():
    counts = [elman(ref)[1].iterations for ref in sorted(GOLDEN)]
    assert counts[0] < counts[1] < counts[2], counts
