"""The convergence study of the elliptic interface problem at cycle 1
against the JAX package: see ``test_torch_elliptic_study.py``."""

import pytest

from test_torch_elliptic_study import check_study_cycle


@pytest.mark.parametrize("cycle", [1])
def test_convergence_study_cycle_matches_reference(cycle):
    check_study_cycle(cycle)
