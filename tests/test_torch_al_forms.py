"""The augmented solver's operator form with the exact W = M
(``use_diagonal_inverse=False``: W⁻¹ = M⁻¹, the flagship's lattice path
with K2 and K1) against the JAX package, in float64 on the CPU with the
reference's setup state and Lanczos start vectors carried across: the
counts of ``GOLDEN_EXACT`` exactly (``tests/test_baseline_tables.py:70``),
the reference's own count and solution at refinement 4, and
``solve_refined``'s refusal of the forms its host reference does not
apply.  The explicit forms have a file each
(``test_torch_al_explicit{,_exact}.py``)."""

import numpy as np
import pytest
import torch

from test_torch_immersed_laplace import (JConfig, JControl, JProblem,
                                         TConfig, TControl, TProblem,
                                         carried_arrays, golden_config,
                                         state_from_jax)

torch.set_num_threads(1)

# TestALFlat.GOLDEN_EXACT, tests/test_baseline_tables.py:70
GOLDEN_EXACT = {4: 16, 5: 17, 6: 18}


def form_config(cfg_cls, control_cls, ref, operator_form, diagonal):
    cfg = golden_config(cfg_cls, control_cls, ref)
    cfg.use_operator_form = operator_form
    cfg.use_diagonal_inverse = diagonal
    return cfg


def port_on_reference(jp, cfg):
    """The port's problem of ``cfg`` on ``jp``'s carried state (the whole
    immersed mass matrix: the exact W⁻¹ needs it)."""
    tp = TProblem(cfg, device="cpu").setup()
    return tp.load_state(state_from_jax(carried_arrays(jp, matrices=True),
                                        "cpu", torch.float64))


def check_form(ref, operator_form, diagonal, golden=None):
    """Both packages solve one form at ``ref``: equal outer counts (and the
    golden), solutions within 1e-8 of the reference's max.  Returns the
    port's problem."""
    jp = JProblem(form_config(JConfig, JControl, ref, operator_form,
                              diagonal)).setup()
    uj, _, ij = jp.solve()
    tp = port_on_reference(jp, form_config(TConfig, TControl, ref,
                                           operator_form, diagonal))
    ut, _, it = tp.solve()
    if golden is not None:
        assert int(ij.iterations) == golden
    assert bool(ij.converged) and it.converged
    assert it.iterations == int(ij.iterations)
    uj = np.asarray(uj)
    assert np.abs(ut.numpy() - uj).max() <= 1e-8 * np.abs(uj).max()
    assert tp.constraint_residual() < 1e-6
    return tp


def test_exact_w_operator_form_matches_reference():
    tp = check_form(4, True, False, GOLDEN_EXACT[4])
    # the flagship's lattice path: the patched K2 level on the fine level
    assert tp.level_stencils[0] is not None


@pytest.mark.parametrize("ref", [5, 6])
def test_exact_w_operator_form_golden(ref):
    """The port on the reference's carried state at the golden's count,
    without re-running the reference's solve."""
    jp = JProblem(form_config(JConfig, JControl, ref, True, False)).setup()
    tp = port_on_reference(jp, form_config(TConfig, TControl, ref, True,
                                           False))
    _, _, info = tp.solve()
    assert info.converged and info.iterations == GOLDEN_EXACT[ref]


@pytest.mark.parametrize("operator_form, diagonal", [(True, False),
                                                     (False, True),
                                                     (False, False)])
def test_solve_refined_refuses_other_forms(operator_form, diagonal):
    cfg = form_config(TConfig, TControl, 4, operator_form, diagonal)
    prob = TProblem(cfg, device="cpu").setup()
    with pytest.raises(NotImplementedError, match="diag"):
        prob.solve_refined()
