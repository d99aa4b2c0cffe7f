"""The augmented solver's explicit form with W = diag(M)²
(``use_operator_form=False, use_diagonal_inverse=True``: γ·Cᵀdiag(w)C as
the compact dense block, K1 on every level) against the JAX package at
refinements 4 and 5 (``tests/test_immersed_laplace.py:52-59`` runs it at
5): see ``test_torch_al_forms.py``."""

import pytest
import torch

from test_torch_al_forms import check_form

torch.set_num_threads(1)


@pytest.mark.parametrize("ref", [4, 5])
def test_explicit_diag_w_matches_reference(ref):
    tp = check_form(ref, False, True)
    # K1 and the masked compact block on every level, no patch planes
    assert all(st is None for st in tp.level_stencils)
    assert len(tp.compact_blocks) == len(tp._last_gmg.levels)
    assert tp.compact_blocks[0]["rows"] > 0
