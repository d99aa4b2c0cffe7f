"""The augmented solver's explicit form with the exact W = M²
(``use_operator_form=False, use_diagonal_inverse=False``: the matrix-free
γ·CᵀM⁻²C in the operator, its diagonal surrogate γ·Cᵀdiag(M)⁻²C on the GMG
levels) against the JAX package at refinements 4 and 5
(``tests/test_immersed_laplace.py:61-67`` runs it at 5): see
``test_torch_al_forms.py``."""

import pytest
import torch

from test_torch_al_forms import check_form

torch.set_num_threads(1)


@pytest.mark.parametrize("ref", [4, 5])
def test_explicit_exact_w_matches_reference(ref):
    tp = check_form(ref, False, False)
    assert all(st is None for st in tp.level_stencils)
