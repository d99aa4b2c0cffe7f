"""The element-form path of immersed_laplace in the PyTorch port against the
JAX package, in float64 on the CPU, each package on its own setup with the
JAX package's Lanczos start vectors injected: the augmented solver with
local refinement near Γ in three AL forms (``tests/test_adaptive.py:
189-215``'s configuration, 4 + 1 and embedded 6, tolerance 1e-10), both
packages solving, outer counts equal and u and λ within 1e-8 of the
reference's max; the other solver modes on a locally refined grid, partial
Dirichlet sides and a degree-2 background on uniform grids, both packages
solving, with the same checks; ``from_prm`` on every shipped parameter
file."""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fictitious_domain_al_preconditioners_tpu.models.immersed_laplace import (
    ImmersedLaplaceConfig as JConfig, ImmersedLaplaceProblem as JProblem,
    SolverControlConfig as JControl)
from fictitious_domain_al_preconditioners_torch.models.immersed_laplace \
    import (ImmersedLaplaceConfig as TConfig,
            ImmersedLaplaceProblem as TProblem,
            SolverControlConfig as TControl)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOL_TOL = 1e-8
# W = diag(M) and W = M in operator form; the explicit form with
# W = diag(M)², the configuration of tests/test_adaptive.py:199-203
FORMS = {"diag_w": (True, True), "exact_w": (True, False),
         "explicit": (False, True)}
SMOOTH = dict(embedding_rhs=("8*pi^2*sin(2*pi*x)*sin(2*pi*y)", ""),
              embedded_value=("sin(2*pi*x)*sin(2*pi*y)", ""),
              dirichlet_boundary=("x", ""))
# the other modes on 3 + 1, and the element form's two other triggers on
# uniform grids (smooth data, inhomogeneous Dirichlet data x)
OPTIONS = {
    "CG": dict(initial_refinement=3, delta_refinement=1, solver="CG"),
    "ELMAN_triang": dict(initial_refinement=3, delta_refinement=1,
                         solver="ELMAN_triang"),
    "rational": dict(initial_refinement=3, delta_refinement=1,
                     solver="rational"),
    "partial_dirichlet": dict(initial_refinement=3, dirichlet_ids=(0, 2)),
    "degree_2": dict(initial_refinement=3, embedding_space_degree=2),
}


def jax_normal(n):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                        dtype=jnp.float64))


def solve_both(cfg_kw):
    """The configuration ``cfg_kw(config_class, control_class)`` solved by
    both packages; returns the two problems."""
    jp = JProblem(cfg_kw(JConfig, JControl))
    jp.setup()
    jp.solve()
    tp = TProblem(cfg_kw(TConfig, TControl), device="cpu")
    tp.lanczos_start = lambda i, n: jax_normal(n)
    tp.setup()
    assert tp.element_form
    tp.solve()
    return jp, tp


def check_pair(jp, tp):
    assert tp.results["outer_iterations"] == jp.results["outer_iterations"]
    assert tp.results["converged"] and jp.results["converged"]
    assert tp.space.n_dofs == jp.space.n_dofs
    for a, b in ((tp.u, jp.u), (tp.lam, jp.lam)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= SOL_TOL * np.abs(b).max()
    np.testing.assert_allclose(tp.rhs_f.numpy(), np.asarray(jp.rhs_f),
                               rtol=0, atol=1e-14)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_adaptive_augmented_matches_reference(form):
    op, diag = FORMS[form]

    def cfg(C, S):
        return C(initial_refinement=4, delta_refinement=1,
                 initial_embedded_refinement=6, solver="augmented",
                 use_operator_form=op, use_diagonal_inverse=diag,
                 schur=S(max_steps=200, tolerance=1e-10, reduction=None))

    jp, tp = solve_both(cfg)
    check_pair(jp, tp)
    assert tp.grid.max_level == 5 and tp.space.n_constrained_cells > 0
    assert tp.constraint_residual() < 1e-8
    assert len(tp._last_gmg.levels) == 4


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_element_form_options_match_reference(option):
    def cfg(C, S):
        kw = dict(OPTIONS[option], **SMOOTH)
        if kw.get("solver") is None:
            kw.update(solver="augmented", use_operator_form=True,
                      use_diagonal_inverse=True)
        return C(initial_embedded_refinement=5,
                 schur=S(max_steps=400, tolerance=1e-10, reduction=1e-12),
                 **kw)

    jp, tp = solve_both(cfg)
    check_pair(jp, tp)


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(ROOT, "parameters", "*", "*.prm"))))
def test_from_prm_matches_reference(path):
    """Every shipped immersed_laplace parameter file reads to the JAX
    package's configuration, field by field."""
    tj = dataclasses.asdict(JConfig.from_prm(path))
    tt = dataclasses.asdict(TConfig.from_prm(path))
    assert tt == tj
    with open(path) as fh:
        assert dataclasses.asdict(TConfig.from_prm(fh.read())) == tj
